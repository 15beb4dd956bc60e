"""Flight recorder, after paddle_tpu/obs/flightrec.py: a post-mortem
black box.  When a trigger fires, the evidence that lives in process
memory (the span ring, the event ring, the metrics, which thread was
stuck where, the resolved flags, registered snapshots) is dumped to disk
as one atomically committed bundle directory, the JAX package's layout:

    <flight_dir>/
      flight_<utcstamp>_<pid>_<reason>/
        MANIFEST.json     # schema, reason, ts, context, per-file
                          #   {bytes, crc32}, written last
        spans.jsonl       # the tracing ring at dump time
        events.jsonl      # the structured event ring
        metrics.prom      # the Prometheus exposition
        threads.txt       # all-thread stacks (sys._current_frames)
        flags.json        # every FLAGS value
        <provider>.json   # registered snapshots (a server's stats and
                          #   health, its SLO timeline)

Commit discipline is the checkpoint vault's (fluid/checkpoint.py): every
file is written and fsynced into a `_tmp.flight_*` directory, the dir is
fsynced, the vault's chaos hook fires at `flight_committed`, then one
`os.rename` publishes the bundle; a stale tmp dir is swept by the next
dump.  Keep-N rotation bounds the disk.

Triggers (`trigger(reason, **context)`): `watchdog_fire` (the Executor's
step watchdog), `sentinel_giveup` / `sentinel_rollback` (the Trainer's
anomaly sentinel), `slo_breach` (obs/slo.py) and the server's `flight`
verb.  A per-reason cooldown (`FLAGS.flight_cooldown_s`) makes a storm
write one bundle.  Triggering never raises and is a no-op while
`FLAGS.flight_dir` is unset.  `validate_bundle` is the JAX package's
check; a bundle of either package passes the other's.
"""

import binascii
import json
import os
import sys
import threading
import time
import traceback
import warnings

__all__ = ["FlightRecorder", "configure", "get_recorder", "trigger",
           "add_provider", "remove_provider", "validate_bundle",
           "read_manifest", "list_bundles", "MANIFEST_NAME",
           "SCHEMA_VERSION", "REQUIRED_FILES"]

MANIFEST_NAME = "MANIFEST.json"
SCHEMA_VERSION = 1
_TMP_PREFIX = "_tmp.flight_"
_BUNDLE_PREFIX = "flight_"
# every bundle must carry these; providers add more
REQUIRED_FILES = ("spans.jsonl", "events.jsonl", "metrics.prom",
                  "threads.txt", "flags.json")


def _thread_stacks():
    """Human-readable stacks of EVERY live thread — the wedged-lane
    smoking gun.  ``sys._current_frames`` is a point-in-time snapshot;
    names resolve through threading.enumerate."""
    names = {t.ident: "%s%s" % (t.name, " daemon" if t.daemon else "")
             for t in threading.enumerate()}
    lines = []
    for ident, frame in sorted(sys._current_frames().items()):
        lines.append("--- thread %s (ident %d) ---"
                     % (names.get(ident, "<unknown>"), ident))
        lines.extend(l.rstrip("\n")
                     for l in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines) + "\n"


def _flags_snapshot():
    try:
        from ..flags import FLAGS
        return dict(sorted(vars(FLAGS).items()))
    except Exception as e:
        return {"_error": "%s: %s" % (type(e).__name__, e)}


class FlightRecorder(object):
    """One bundle sink rooted at ``root`` with keep-N rotation and a
    per-trigger-reason cooldown."""

    def __init__(self, root, keep=8, cooldown_s=30.0):
        self.root = str(root)
        self.keep = max(int(keep), 1)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        # serializes concurrent dumps WITHOUT holding _lock across
        # provider callbacks — a provider may legitimately read this
        # recorder back (the server's health snapshot does)
        self._dump_lock = threading.Lock()
        self._last = {}       # reason -> monotonic of last ACCEPTED
        self._seq = 0
        self._providers = {}  # name -> fn() -> json-encodable
        self._dumps = 0
        self._failures = 0

    # -- providers -----------------------------------------------------

    def add_provider(self, name, fn):
        """Register a snapshot source: ``fn()`` returns a
        json-encodable object written as ``<name>.json`` in every
        bundle.  A provider that raises at dump time is recorded as an
        error entry, never a dump failure."""
        with self._lock:
            self._providers[str(name)] = fn

    def remove_provider(self, name):
        with self._lock:
            self._providers.pop(str(name), None)

    # -- trigger -------------------------------------------------------

    def trigger(self, reason, force=False, **context):
        """Fire one trigger.  Returns the committed bundle path, or
        None when the cooldown suppressed it (or the dump failed).
        Never raises — the recorder must not take down what it
        observes."""
        reason = str(reason)
        now = time.monotonic()
        with self._lock:
            last = self._last.get(reason)
            if not force and last is not None \
                    and now - last < self.cooldown_s:
                return None
            # stamp at ACCEPT time so a concurrent trigger storm
            # collapses to one bundle even while this dump runs
            self._last[reason] = now
        try:
            return self.dump(reason, context)
        except Exception as e:
            self._failures += 1
            warnings.warn("flight recorder dump failed (%s: %s) — "
                          "continuing without a bundle"
                          % (type(e).__name__, e))
            return None

    # -- the dump ------------------------------------------------------

    def _sweep_stale_locked(self):
        try:
            for name in os.listdir(self.root):
                if name.startswith(_TMP_PREFIX):
                    import shutil
                    shutil.rmtree(os.path.join(self.root, name),
                                  ignore_errors=True)
        except OSError:
            pass

    def _rotate_locked(self):
        bundles = self.list_bundles()
        for path in bundles[:-self.keep]:
            import shutil
            shutil.rmtree(path, ignore_errors=True)

    def dump(self, reason, context=None):
        """Write one bundle unconditionally (cooldown is trigger()'s
        job) and return its committed path.  All file writes + the
        rename happen here so the whole commit is one auditable scope."""
        from ..fluid.checkpoint import _chaos, _fsync_dir
        from . import events as obs_events
        from . import registry as obs_registry
        from . import tracing as obs_tracing
        t0 = time.monotonic()
        with self._lock:
            self._seq += 1
            seq = self._seq
            providers = dict(self._providers)
        # the writes run under _dump_lock only: providers may read this
        # recorder back (stats/list), which needs _lock free
        with self._dump_lock:
            os.makedirs(self.root, exist_ok=True)
            self._sweep_stale_locked()
            # wall stamp names the bundle (operators sort by it); the
            # seq suffix keeps same-second dumps distinct
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            final_name = "%s%s.%03d_%d_%s" % (
                _BUNDLE_PREFIX, stamp, seq % 1000, os.getpid(),
                reason.replace(os.sep, "_"))
            final = os.path.join(self.root, final_name)
            tmp = os.path.join(self.root,
                               _TMP_PREFIX + final_name[len(_BUNDLE_PREFIX):])
            os.makedirs(tmp)
            files = {}

            def _write(name, data):
                if isinstance(data, str):
                    data = data.encode("utf-8")
                path = os.path.join(tmp, name)
                with open(path, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                files[name] = {"bytes": len(data),
                               "crc32": binascii.crc32(data) & 0xFFFFFFFF}

            _write("spans.jsonl", "".join(
                json.dumps(s, sort_keys=True) + "\n"
                for s in obs_tracing.recent_spans()))
            _write("events.jsonl", "".join(
                json.dumps(e, sort_keys=True) + "\n"
                for e in obs_events.recent_events()))
            _write("metrics.prom",
                   obs_registry.default().prometheus_text())
            _write("threads.txt", _thread_stacks())
            _write("flags.json", json.dumps(_flags_snapshot(),
                                            indent=1, sort_keys=True,
                                            default=str))
            for name, fn in sorted(providers.items()):
                try:
                    payload = fn()
                except Exception as e:
                    payload = {"_error": "%s: %s"
                               % (type(e).__name__, e)}
                _write("%s.json" % name,
                       json.dumps(payload, indent=1, sort_keys=True,
                                  default=str))
            manifest = {
                "schema": SCHEMA_VERSION,
                "reason": reason,
                "ts": round(time.time(), 6),
                "context": {k: (v if isinstance(v, (str, int, float,
                                                    bool)) else str(v))
                            for k, v in (context or {}).items()
                            if v is not None},
                "pid": os.getpid(),
                "dump_ms": round((time.monotonic() - t0) * 1e3, 3),
                "files": files,
            }
            _write(MANIFEST_NAME,
                   json.dumps(manifest, indent=1, sort_keys=True))
            _fsync_dir(tmp)
            _chaos("flight_committed")
            os.rename(tmp, final)
            _fsync_dir(self.root)
            self._rotate_locked()
        with self._lock:
            self._dumps += 1
        obs_events.emit("flight_dumped", reason=reason,
                        bundle=os.path.basename(final))
        return final

    # -- readouts ------------------------------------------------------

    def list_bundles(self):
        """Committed bundle paths, oldest first (name-sorted — the
        stamp prefix makes that chronological)."""
        return list_bundles(self.root)

    def stats(self):
        with self._lock:
            return {"root": self.root, "keep": self.keep,
                    "cooldown_s": self.cooldown_s,
                    "dumps": self._dumps, "failures": self._failures,
                    "bundles": len(self.list_bundles())}


# ---------------------------------------------------------------------------
# process-default recorder (flag-configured) + module-level trigger
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_recorder = None
_configured = False
# providers registered before the recorder exists (or while disabled)
# are replayed onto every (re)configured recorder
_pending_providers = {}


def _flag(name, default):
    try:
        from ..flags import FLAGS
        return getattr(FLAGS, name)
    except Exception:
        return default


def configure(root=None, keep=None, cooldown_s=None):
    """(Re)build the process-default recorder from flags/overrides;
    ``root=''`` (the default flag value) disables it."""
    global _recorder, _configured
    with _lock:
        root = _flag("flight_dir", "") if root is None else root
        if not root:
            _recorder = None
        else:
            _recorder = FlightRecorder(
                root,
                keep=_flag("flight_keep", 8) if keep is None else keep,
                cooldown_s=_flag("flight_cooldown_s", 30.0)
                if cooldown_s is None else cooldown_s)
            for name, fn in _pending_providers.items():
                _recorder.add_provider(name, fn)
        _configured = True
    return _recorder


def get_recorder():
    """The process-default recorder, or None while disabled."""
    global _recorder, _configured
    if not _configured:
        configure()
    return _recorder


def add_provider(name, fn):
    """Register a snapshot provider on the default recorder — kept
    across reconfiguration, harmless while the recorder is disabled."""
    with _lock:
        _pending_providers[str(name)] = fn
    rec = get_recorder()
    if rec is not None:
        rec.add_provider(name, fn)


def remove_provider(name):
    with _lock:
        _pending_providers.pop(str(name), None)
    rec = get_recorder()
    if rec is not None:
        rec.remove_provider(name)


def trigger(reason, force=False, **context):
    """Module-level trigger into the default recorder.  The one-line
    call sites (executor watchdog, sentinel, SLO monitor, the `flight`
    verb) stay exception-free and cost nothing while disabled."""
    try:
        rec = get_recorder()
        if rec is None:
            return None
        return rec.trigger(reason, force=force, **context)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# bundle inspection
# ---------------------------------------------------------------------------

def list_bundles(root):
    if not os.path.isdir(root):
        return []
    out = [os.path.join(root, name) for name in os.listdir(root)
           if name.startswith(_BUNDLE_PREFIX)
           and os.path.isdir(os.path.join(root, name))
           and os.path.exists(os.path.join(root, name, MANIFEST_NAME))]
    return sorted(out)


def read_manifest(bundle):
    with open(os.path.join(bundle, MANIFEST_NAME)) as f:
        return json.load(f)


def validate_bundle(bundle):
    """Deep-validate one committed bundle; returns a list of problem
    strings (empty == valid).  Checks: manifest parses and carries the
    known schema, every listed file exists with matching size + CRC32,
    the required files are present, and every ``*.jsonl``/``*.json``
    payload parses."""
    problems = []
    try:
        manifest = read_manifest(bundle)
    except (OSError, ValueError) as e:
        return ["manifest unreadable: %s: %s" % (type(e).__name__, e)]
    if manifest.get("schema") != SCHEMA_VERSION:
        problems.append("unknown schema %r" % (manifest.get("schema"),))
    if not manifest.get("reason"):
        problems.append("manifest missing reason")
    files = manifest.get("files") or {}
    for name in REQUIRED_FILES:
        if name not in files:
            problems.append("required file %s missing from manifest"
                            % name)
    for name, meta in sorted(files.items()):
        path = os.path.join(bundle, name)
        if not os.path.exists(path):
            problems.append("%s listed but missing on disk" % name)
            continue
        with open(path, "rb") as f:
            data = f.read()
        if len(data) != meta.get("bytes"):
            problems.append("%s size %d != manifest %s"
                            % (name, len(data), meta.get("bytes")))
        crc = binascii.crc32(data) & 0xFFFFFFFF
        if crc != meta.get("crc32"):
            problems.append("%s crc32 %d != manifest %s (corrupt)"
                            % (name, crc, meta.get("crc32")))
            continue
        if name.endswith(".jsonl"):
            for i, line in enumerate(data.splitlines()):
                if not line.strip():
                    continue
                try:
                    json.loads(line)
                except ValueError:
                    problems.append("%s line %d is not JSON"
                                    % (name, i + 1))
                    break
        elif name.endswith(".json"):
            try:
                json.loads(data.decode("utf-8"))
            except ValueError:
                problems.append("%s is not JSON" % name)
    # files on disk the manifest never heard of (a torn commit can't
    # produce this — the rename is atomic — but a tamper can)
    for name in sorted(os.listdir(bundle)):
        if name != MANIFEST_NAME and name not in files:
            problems.append("unlisted file %s in bundle" % name)
    if "threads.txt" in files and files["threads.txt"].get("bytes", 0) \
            < 10:
        problems.append("threads.txt suspiciously empty")
    return problems
