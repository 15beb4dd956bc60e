"""Checkpoint vault, after paddle_tpu/fluid/checkpoint.py: atomic,
CRC-verified, rotated checkpoint directories, byte for byte the JAX
package's layout, so a checkpoint written by either package loads in
the other.

    <root>/
      checkpoint_<step>/
        __manifest__.json        # schema, meta {epoch, step, ...}, per-array
                                 #   {file, crc32, shape, dtype, nbytes}
        <array files>.npy        # one file per persistable
      latest                     # text file naming a fully-committed dir
      _tmp.checkpoint_<step>.*   # in-flight save (ignored by readers)

Commit protocol: write every array and the manifest into a temp
directory, fsync each file, fsync the temp dir, `os.rename` it to its
numbered name, fsync the root, then atomically rewrite `latest` (temp +
fsync + rename).  A kill at any point leaves either a stale `_tmp.*` dir
(swept by the next save) with `latest` still naming the previous good
checkpoint, or a fully committed new dir.  Loads verify every array's
CRC32, shape and dtype and raise `CheckpointCorruptionError` naming the
first bad array.

Arrays may be torch tensors (on the card or the CPU) or numpy arrays;
they are written as .npy from the host.  bfloat16 has no numpy dtype:
an `ml_dtypes.bfloat16` array (a torch bf16 tensor becomes one) is
written as the JAX package's `np.save` writes it, raw 2-byte records
(descr '<V2') with "bfloat16" in the manifest, and read back as
`ml_dtypes.bfloat16` by the manifest's dtype.  It is never widened to
fp32.

Chaos hooks: `PADDLE_TPU_CHAOS="<point>=<action>[@<n>]"` (or an
in-process hook via `set_chaos_hook`) fires a fault at a named protocol
point: `array_written`, `arrays_written`, `manifest_written`,
`committed`, `latest_updated` (and the flight recorder's
`flight_committed`).  Actions: `exit` (os._exit(137), the kill -9
analogue) and `pause[:secs]` (print `CHAOS_PAUSE <point>` and sleep so a
parent can SIGKILL for real).  `@<n>` fires on the n-th arrival.
"""

import binascii
import io as _io
import json
import os
import re
import shutil
import threading
import time

import numpy as np

__all__ = [
    "CheckpointError", "CheckpointCorruptionError", "MANIFEST_NAME",
    "LATEST_NAME", "save_checkpoint_dir", "load_checkpoint_dir",
    "verify_checkpoint_dir", "read_manifest", "list_checkpoints",
    "latest_checkpoint", "rotate_checkpoints", "normalize_meta",
    "AsyncCheckpointSaver", "async_saver", "wait_for_async_saves",
    "set_chaos_hook", "atomic_write",
]

MANIFEST_NAME = "__manifest__.json"
LATEST_NAME = "latest"
SCHEMA_VERSION = 1
_DIR_RE = re.compile(r"^checkpoint_(\d+)$")
_TMP_PREFIX = "_tmp.checkpoint_"


class CheckpointError(RuntimeError):
    """A checkpoint directory is missing or structurally unusable."""


class CheckpointCorruptionError(CheckpointError):
    """An array shard failed its CRC32 / shape / dtype verification.
    The message names the offending array and file."""


# ---------------------------------------------------------------------------
# chaos / fault-injection hooks
# ---------------------------------------------------------------------------

_CHAOS_ENV = "PADDLE_TPU_CHAOS"
_chaos_hook = None
_chaos_hits = {}
_chaos_lock = threading.Lock()


def set_chaos_hook(fn):
    """Install an in-process fault hook `fn(point_name)` (None clears).
    Used by tests to interrupt a save at an exact protocol point without
    spawning a subprocess; the env-var spec serves real-kill scenarios."""
    global _chaos_hook
    _chaos_hook = fn
    _chaos_hits.clear()


def _chaos(point):
    if _chaos_hook is not None:
        _chaos_hook(point)
        return
    spec = os.environ.get(_CHAOS_ENV)
    if not spec:
        return
    with _chaos_lock:
        hits = _chaos_hits[point] = _chaos_hits.get(point, 0) + 1
    for part in spec.split(","):
        name, _, action = part.partition("=")
        nth = 1
        if "@" in action:
            action, _, n = action.rpartition("@")
            nth = int(n)
        if name != point or hits != nth:
            continue
        if action == "exit":
            os._exit(137)  # kill -9 semantics: no cleanup, no atexit
        if action.startswith("pause"):
            secs = float(action.split(":", 1)[1]) if ":" in action else 60.0
            print("CHAOS_PAUSE %s" % point, flush=True)
            time.sleep(secs)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse fsync on directories
    finally:
        os.close(fd)


def _atomic_write(path, data, fsync=True, chaos_point=None):
    """Write bytes to `path` via temp + fsync + rename.  `chaos_point`
    names an optional fault-injection point fired between the durable
    temp write and the rename — a crash there must leave the previous
    file intact plus a stale `.tmp.*`, never a truncated target."""
    tmp = "%s.tmp.%d.%x" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if chaos_point:
        _chaos(chaos_point)
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(os.path.dirname(path) or ".")


# the shared commit helper (the flight recorder rides the same discipline)
atomic_write = _atomic_write


def checkpoint_dir_name(step):
    return "checkpoint_%d" % int(step)


def list_checkpoints(root):
    """[(step, abs_path)] of committed checkpoint dirs, ascending step."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _DIR_RE.match(name)
        path = os.path.join(root, name)
        if m and os.path.isdir(path) and \
                os.path.exists(os.path.join(path, MANIFEST_NAME)):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def latest_checkpoint(root):
    """Resolve the `latest` pointer -> absolute dir path, or None.
    Falls back to the highest committed step when the pointer is missing
    (e.g. a crash landed between commit and pointer update — the new dir
    is fully committed, so it is safe to prefer it)."""
    ptr = os.path.join(root, LATEST_NAME)
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        cand = os.path.join(root, name)
        if _DIR_RE.match(name) and \
                os.path.exists(os.path.join(cand, MANIFEST_NAME)):
            return cand
    cks = list_checkpoints(root)
    return cks[-1][1] if cks else None


def normalize_meta(meta):
    """One explicit meta schema for save/load/Trainer: a dict with at
    least integer `epoch` and `step`.  Accepts the legacy forms the old
    io.save_checkpoint produced (a bare int step, a {"epoch","step"}
    dict, or None) and always returns the canonical dict."""
    if meta is None:
        return {"epoch": 0, "step": 0}
    if isinstance(meta, (int, np.integer)):
        return {"epoch": 0, "step": int(meta)}
    if isinstance(meta, dict):
        out = dict(meta)
        out["epoch"] = int(out.get("epoch", 0) or 0)
        out["step"] = int(out.get("step", 0) or 0)
        return out
    raise TypeError("checkpoint meta must be an int step or a dict with "
                    "'epoch'/'step', got %r" % (meta,))


def _array_filename(name, used):
    base = name.replace("/", "__")
    fname = base + ".npy"
    k = 0
    while fname in used:  # sanitization collision: disambiguate
        k += 1
        fname = "%s.%d.npy" % (base, k)
    used.add(fname)
    return fname


try:
    from ml_dtypes import bfloat16 as _NP_BF16
except ImportError:  # pragma: no cover
    _NP_BF16 = None


def _host_array(value):
    """A contiguous host numpy array of a tensor or array-like (a torch
    bf16 tensor as an `ml_dtypes.bfloat16` array)."""
    from .executor import as_numpy
    import torch
    if isinstance(value, torch.Tensor):
        value = as_numpy(value)
    return np.ascontiguousarray(np.asarray(value))


def _npy_bytes(arr):
    buf = _io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# save / load / verify
# ---------------------------------------------------------------------------

def _sweep_stale_tmp(root, keep=None):
    for name in os.listdir(root):
        if name.startswith(_TMP_PREFIX):
            path = os.path.join(root, name)
            if path != keep:
                shutil.rmtree(path, ignore_errors=True)


def save_checkpoint_dir(root, arrays, meta, max_num_checkpoints=None,
                        fsync=True):
    """Commit one checkpoint of `arrays` (name -> array-like) under
    `root` as `checkpoint_<meta['step']>/`, update `latest`, rotate.
    Returns the committed directory path."""
    meta = normalize_meta(meta)
    step = meta["step"]
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, "%s%d.%d.%x" % (
        _TMP_PREFIX, step, os.getpid(), threading.get_ident()))
    _sweep_stale_tmp(root, keep=tmp)
    os.makedirs(tmp)
    manifest = {"schema": SCHEMA_VERSION, "meta": meta, "arrays": {}}
    used = set()
    for name in sorted(arrays):
        arr = _host_array(arrays[name])
        fname = _array_filename(name, used)
        data = _npy_bytes(arr)
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        manifest["arrays"][name] = {
            "file": fname,
            "crc32": binascii.crc32(data) & 0xFFFFFFFF,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "nbytes": int(arr.nbytes),
        }
        _chaos("array_written")
    _chaos("arrays_written")
    mpath = os.path.join(tmp, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    _chaos("manifest_written")
    if fsync:
        _fsync_dir(tmp)
    final = os.path.join(root, checkpoint_dir_name(step))
    if os.path.isdir(final):
        # re-save at the same step (e.g. rollback then retrain): move the
        # old dir aside first — rename onto a non-empty dir fails
        trash = final + ".old.%d" % os.getpid()
        os.rename(final, trash)
        shutil.rmtree(trash, ignore_errors=True)
    os.rename(tmp, final)
    _chaos("committed")
    if fsync:
        _fsync_dir(root)
    _atomic_write(os.path.join(root, LATEST_NAME),
                  (checkpoint_dir_name(step) + "\n").encode(), fsync=fsync)
    _chaos("latest_updated")
    # lifecycle record (OBSERVABILITY.md): the commit is durable and
    # the `latest` pointer names it — stamped with the step id so the
    # event log cross-references the train-side ckpt spans
    from ..obs import events as _obs_events
    _obs_events.emit("checkpoint_committed", step=int(step),
                     epoch=meta.get("epoch"), path=final)
    if max_num_checkpoints:
        rotate_checkpoints(root, max_num_checkpoints)
    return final


def rotate_checkpoints(root, max_num_checkpoints):
    """Keep the newest `max_num_checkpoints` committed dirs (reference
    CheckpointConfig.max_num_checkpoints / _scroll_delete).  The dir the
    `latest` pointer names is never deleted, whatever its step."""
    keep = max(int(max_num_checkpoints), 1)
    cks = list_checkpoints(root)
    if len(cks) <= keep:
        return []
    latest = latest_checkpoint(root)
    removed = []
    for _, path in cks[:-keep]:
        if path == latest:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def read_manifest(dirname):
    mpath = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise CheckpointError("no %s in %s — not a committed checkpoint "
                              "directory" % (MANIFEST_NAME, dirname))
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("schema") != SCHEMA_VERSION:
        raise CheckpointError("checkpoint %s has manifest schema %r, this "
                              "build reads schema %d"
                              % (dirname, manifest.get("schema"),
                                 SCHEMA_VERSION))
    return manifest


def _load_one(dirname, name, ent):
    path = os.path.join(dirname, ent["file"])
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointCorruptionError(
            "checkpoint %s: array %r is missing its shard file %s (%s)"
            % (dirname, name, ent["file"], e))
    crc = binascii.crc32(data) & 0xFFFFFFFF
    if crc != ent["crc32"]:
        raise CheckpointCorruptionError(
            "checkpoint %s: array %r failed CRC32 verification "
            "(manifest %d != file %d) — shard %s is corrupt"
            % (dirname, name, ent["crc32"], crc, ent["file"]))
    arr = np.load(_io.BytesIO(data), allow_pickle=False)
    if ent["dtype"] == "bfloat16" and arr.dtype == np.dtype("V2") \
            and _NP_BF16 is not None:
        # np.save writes a bfloat16 array as raw 2-byte records
        arr = arr.view(_NP_BF16)
    if list(arr.shape) != list(ent["shape"]) or \
            str(arr.dtype) != ent["dtype"]:
        raise CheckpointCorruptionError(
            "checkpoint %s: array %r decoded as %s%s but the manifest "
            "says %s%s" % (dirname, name, arr.dtype, list(arr.shape),
                           ent["dtype"], ent["shape"]))
    return arr


def load_checkpoint_dir(dirname, names=None):
    """Load a committed checkpoint dir -> (arrays dict, meta dict),
    CRC-verifying every shard (or just `names` when given)."""
    manifest = read_manifest(dirname)
    out = {}
    for name, ent in manifest["arrays"].items():
        if names is not None and name not in names:
            continue
        out[name] = _load_one(dirname, name, ent)
    return out, normalize_meta(manifest.get("meta"))


def verify_checkpoint_dir(dirname):
    """CRC-verify every shard without keeping the arrays; returns the
    manifest.  Raises CheckpointCorruptionError naming the first bad
    array."""
    manifest = read_manifest(dirname)
    for name, ent in manifest["arrays"].items():
        _load_one(dirname, name, ent)
    return manifest


# ---------------------------------------------------------------------------
# async save
# ---------------------------------------------------------------------------

class AsyncCheckpointSaver:
    """One background worker draining save jobs in submit order, so the
    train loop never stalls on checkpoint IO.  The port's steps never
    update a state tensor in place (every optimizer lowering returns new
    tensors and the Executor rebinds the scope's names; the tests pin
    each tensor's version counter), so the live state refs are a
    snapshot: the device-to-host copy and the file IO both happen
    off-thread, after later steps were dispatched.  Errors are re-raised
    on the next `submit` or on `wait`: a failed checkpoint never stays
    silent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs = []
        self._error = None
        self._thread = None
        self._wake = threading.Condition(self._lock)
        self._busy = 0

    def _worker(self):
        while True:
            with self._wake:
                while not self._jobs:
                    self._wake.wait()
                job = self._jobs.pop(0)
                self._busy += 1
            try:
                if job is None:
                    return
                save_checkpoint_dir(*job)
            except BaseException as e:  # surfaced on wait()/next submit()
                with self._wake:
                    self._error = e
            finally:
                with self._wake:
                    self._busy -= 1
                    self._wake.notify_all()

    def submit(self, root, arrays, meta, max_num_checkpoints=None):
        self._raise_pending()
        with self._wake:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, daemon=True,
                    name="paddle-tpu-ckpt-saver")
                self._thread.start()
            self._jobs.append((root, dict(arrays), normalize_meta(meta),
                               max_num_checkpoints))
            self._wake.notify_all()

    def wait(self, timeout=None):
        """Block until every submitted save has committed; re-raises the
        first background error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._wake:
            while self._jobs or self._busy:
                rem = None if deadline is None \
                    else max(deadline - time.monotonic(), 0.0)
                if rem == 0.0:
                    raise TimeoutError("async checkpoint save still "
                                       "running after %.1fs" % timeout)
                self._wake.wait(rem)
        self._raise_pending()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(
                "background checkpoint save failed: %r" % (err,)) from err


_async_saver = None


def async_saver():
    global _async_saver
    if _async_saver is None:
        _async_saver = AsyncCheckpointSaver()
    return _async_saver


def wait_for_async_saves(timeout=None):
    """Join all pending background checkpoint saves (no-op when none)."""
    if _async_saver is not None:
        _async_saver.wait(timeout)
