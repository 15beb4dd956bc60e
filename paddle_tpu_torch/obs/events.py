"""Structured event log: append-only JSONL of discrete lifecycle events,
after paddle_tpu/obs/events.py (the same record schema and API).

Spans answer "where did the time go"; this log answers "what happened":
hot-swap flips, admission sheds (with the priority class dropped),
deadline expiries, slow requests, degraded speculative lanes, SLO
transitions.  Each record is one JSON object with a wall-clock ``ts``, a
``kind``, and whatever ids the emitter had (``trace_id`` for serving
events).

Emitting never raises and never blocks on durability.  A bounded
in-memory ring always records (``recent_events``); the file sink is
opt-in via ``FLAGS.event_log`` and plain buffered appends.  Past
``FLAGS.event_log_max_kb`` the file is fsynced and atomically renamed to
``<path>.1`` (one rotated generation kept), so a crash mid-rotation
leaves the old log intact.
"""

import collections
import json
import os
import threading
import time
import warnings

__all__ = ["EventLog", "emit", "recent_events", "configure", "get_log",
           "stats"]

_lock = threading.Lock()
_log = None          # the process-default EventLog (lazy, flag-config'd)
_configured = False


class EventLog(object):
    """One event sink: bounded memory ring + optional JSONL file."""

    def __init__(self, path=None, max_bytes=1 << 20, ring=1024):
        self.path = path or None
        self.max_bytes = int(max_bytes)
        self._mem = collections.deque(maxlen=max(int(ring), 1))
        self._total = 0
        self._dropped = 0     # ring-overflow evictions (oldest-first)
        self._rotations = 0   # committed file rotations
        self._lock = threading.Lock()
        self._f = None
        self._size = 0
        self._sink_dead = False

    # -- file sink ----------------------------------------------------

    def _open_locked(self):
        # caller holds self._lock (emit / _rotate_locked)
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "ab")
            self._size = self._f.tell()
        return self._f

    def _rotate_locked(self):
        """Vault-discipline rotation: flush+fsync the full file, fire
        the chaos point, then one atomic rename to ``<path>.1`` (the
        previous generation is dropped).  A crash between fsync and
        rename leaves the just-synced file in place — nothing is ever
        truncated in place."""
        f = self._f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        self._f = None
        os.replace(self.path, self.path + ".1")
        _fsync_dir(os.path.dirname(self.path) or ".")
        self._size = 0
        self._rotations += 1

    # -- emit ---------------------------------------------------------

    def emit(self, kind, **fields):
        """Record one event.  Never raises; file-sink failures warn once
        and drop to memory-only."""
        rec = {"ts": round(time.time(), 6), "kind": str(kind)}
        for k, v in fields.items():
            if v is None:
                continue
            rec[k] = v if isinstance(v, (str, int, float, bool)) \
                else str(v)
        if len(self._mem) == self._mem.maxlen:
            self._dropped += 1  # GIL-atomic bump, same as the append
        self._mem.append(rec)
        self._total += 1
        if not self.path or self._sink_dead:
            return rec
        try:
            line = (json.dumps(rec, sort_keys=True) + "\n").encode()
            with self._lock:
                f = self._open_locked()
                f.write(line)
                # flush (no fsync) per record: lifecycle events are
                # low-rate and an operator tailing the file must see
                # them live; durability is the rotation's job
                f.flush()
                self._size += len(line)
                if self._size >= self.max_bytes:
                    self._rotate_locked()
        except Exception as e:
            self._sink_dead = True
            warnings.warn("obs event log sink %r failed (%s: %s) — "
                          "continuing memory-only"
                          % (self.path, type(e).__name__, e))
        return rec

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except Exception:
                    pass
                self._f = None

    def recent(self, n=None, kind=None):
        evs = list(self._mem)
        if kind:
            evs = [e for e in evs if e.get("kind") == kind]
        if n is not None and len(evs) > n:
            evs = evs[-int(n):]
        return evs

    @property
    def total(self):
        return self._total

    def stats(self):
        """Ring + sink health (the metrics surface's event-log
        families)."""
        return {"events_total": self._total,
                "buffered": len(self._mem),
                "dropped": self._dropped,
                "rotations": self._rotations,
                "sink": ("none" if not self.path
                         else "dead" if self._sink_dead else "ok"),
                "sink_dead": bool(self.path and self._sink_dead)}


def _fsync_dir(path):
    """Make a rename in `path` durable (POSIX; a no-op where a directory
    cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# process-default log (flag-configured)
# ---------------------------------------------------------------------------

def get_log():
    global _log, _configured
    if _log is None or not _configured:
        with _lock:
            if _log is None or not _configured:
                path, max_kb = None, 1024
                try:
                    from ..flags import FLAGS
                    path = FLAGS.event_log or None
                    max_kb = FLAGS.event_log_max_kb
                except Exception:
                    pass
                _log = EventLog(path=path, max_bytes=max_kb * 1024)
                _configured = True
    return _log


def _flag(name, default):
    try:
        from ..flags import FLAGS
        return getattr(FLAGS, name)
    except Exception:
        return default


def configure(path=None, max_kb=None):
    """Swap the process-default sink (flags on_change routes here).
    The memory ring starts fresh; the old file handle is closed."""
    global _log, _configured
    with _lock:
        if _log is not None:
            _log.close()
        _log = EventLog(
            path=(_flag("event_log", "") if path is None else path)
            or None,
            max_bytes=(_flag("event_log_max_kb", 1024) if max_kb is None
                       else max_kb) * 1024)
        _configured = True
    return _log


def emit(kind, **fields):
    """Module-level emit into the process-default log.  The one-line
    call sites sprinkle through serving and training; it must stay
    exception-free whatever state the sink is in."""
    try:
        return get_log().emit(kind, **fields)
    except Exception:
        return None


def recent_events(n=None, kind=None):
    return get_log().recent(n=n, kind=kind)


def stats():
    """Health of the process-default event log."""
    return get_log().stats()
