"""Profiler, after paddle_tpu/fluid/profiler.py (reference
python/paddle/fluid/profiler.py over platform/profiler.cc's event tables,
the CUPTI device tracer and tools/timeline.py's chrome-trace export).

`torch.profiler` owns the device timeline, as jax.profiler does in the
JAX package: `start_profiler` starts one (CPU activity, and CUDA's when
the card is there), `stop_profiler` stops it, writes its chrome trace
into the trace directory and prints the sorted summary table.  The
table aggregates the host `RecordEvent` spans (a locked process-wide
table, as the reference's) and, as the JAX version adds its XLA ops,
the CUDA kernels, memcpys and memsets of the trace, named `cuda::<name>`
(`_device_events`).  The text is the JAX version's `_format_table`.
`export_chrome_tracing` writes the trace as a chrome://tracing JSON
with the port's obs spans (obs/tracing.py) merged in as their own rows.

The default trace directory and table file lie under the process's
temporary directory (`tempfile.gettempdir()`), never at a path the JAX
package writes.  The table and the enabled flag are process-wide:
`reset_profiler` clears the table.
"""

import contextlib
import json
import os
import tempfile
import threading
import time

__all__ = ["cuda_profiler", "reset_profiler", "profiler", "start_profiler",
           "stop_profiler", "RecordEvent", "export_chrome_tracing"]

_TRACE_FILE = "trace.json"

_trace_dir = None
_torch_prof = None
_host_events = {}    # name -> [calls, total_ms, min_ms, max_ms]
# every instrumented thread records here; the read-modify-write of
# _record is not atomic under the GIL, hence the lock
_events_lock = threading.Lock()
_enabled = False


def _default_dir(name):
    return os.path.join(tempfile.gettempdir(), name)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """Accepted for API parity: profiles the block as `profiler` does and
    writes the table to `output_file`."""
    with profiler("All", "total", output_file):
        yield


def reset_profiler():
    """Clear the collected host events (reference reset_profiler)."""
    with _events_lock:
        _host_events.clear()


def _record(name, ms):
    with _events_lock:
        e = _host_events.get(name)
        if e is None:
            _host_events[name] = [1, ms, ms, ms]
        else:
            e[0] += 1
            e[1] += ms
            e[2] = min(e[2], ms)
            e[3] = max(e[3], ms)


def enabled():
    """Whether a profiling session is open (start_profiler .. stop)."""
    return _enabled


def start_profiler(state="All", tracer_option=None, output_dir=None):
    """Open a session: clear the table and start torch.profiler (CUDA
    activity when `state` is not "CPU" and the card is there).  The
    trace goes to `output_dir`, else $PADDLE_TPU_TORCH_TRACE_DIR, else
    <tmp>/paddle_tpu_torch_profile."""
    global _trace_dir, _torch_prof, _enabled
    import torch
    from torch.profiler import ProfilerActivity, profile
    _enabled = True
    reset_profiler()
    _trace_dir = output_dir or os.environ.get(
        "PADDLE_TPU_TORCH_TRACE_DIR",
        _default_dir("paddle_tpu_torch_profile"))
    activities = [ProfilerActivity.CPU]
    if state != "CPU" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        _torch_prof = profile(activities=activities)
        _torch_prof.__enter__()
    except RuntimeError:
        _torch_prof = None    # host-only profiling still works


def _is_device_event(e):
    cat = str(e.get("cat", "")).lower()
    return e.get("ph") == "X" and cat in ("kernel", "gpu_memcpy",
                                          "gpu_memset")


def _device_events(trace_dir):
    """{"cuda::<name>": [calls, total_ms, min_ms, max_ms]} of the device
    events (kernels, memcpys, memsets) in the session's chrome trace: the
    CUPTI kernel table.  A trace that cannot be parsed warns and yields
    no rows."""
    import warnings
    out = {}
    path = os.path.join(trace_dir, _TRACE_FILE)
    if not os.path.exists(path):
        return out
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, ValueError) as e:
        warnings.warn("profiler: could not parse the trace %s: %s"
                      % (path, e))
        return out
    for e in events:
        if not _is_device_event(e) or "name" not in e:
            continue
        ms = float(e.get("dur", 0)) / 1000.0
        name = "cuda::" + e["name"]
        rec = out.get(name)
        if rec is None:
            out[name] = [1, ms, ms, ms]
        else:
            rec[0] += 1
            rec[1] += ms
            rec[2] = min(rec[2], ms)
            rec[3] = max(rec[3], ms)
    return out


_SORT_KEYS = {"calls": 0, "total": 1, "min": 2, "max": 3, "ave": 4,
              "default": 1, None: 1}


def _format_table(rows, sorted_key):
    """The summary table of rows (name, calls, total, min, max), sorted
    by `sorted_key` (calls, total, min, max, ave; default total)."""
    idx = _SORT_KEYS.get(sorted_key, 1)
    total_time = sum(r[2] for r in rows) or 1.0
    full = [(n, c, t, mn, mx, t / c if c else 0.0)
            for n, c, t, mn, mx in rows]
    full.sort(key=lambda r: r[1 + idx], reverse=True)
    lines = ["", "------------------------->     Profiling Report     "
             "<-------------------------", "",
             "%-44s %8s %12s %12s %12s %12s %8s" % (
                 "Event", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                 "Ave(ms)", "Ratio")]
    for n, c, t, mn, mx, ave in full:
        lines.append("%-44s %8d %12.4f %12.4f %12.4f %12.4f %7.4f" % (
            n[:44], c, t, mn, mx, ave, t / total_time))
    return "\n".join(lines)


def stop_profiler(sorted_key=None, profile_path=None):
    """Close the session: stop torch.profiler, write its chrome trace to
    <trace dir>/trace.json, print the sorted table of the host events
    and the device rows and write it to `profile_path` (default
    <tmp>/paddle_tpu_torch_profile.txt).  Returns the trace directory."""
    global _torch_prof, _enabled
    if _torch_prof is not None:
        prof, _torch_prof = _torch_prof, None
        prof.__exit__(None, None, None)
        os.makedirs(_trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(_trace_dir, _TRACE_FILE))
    if not _enabled:
        return _trace_dir
    _enabled = False
    with _events_lock:
        rows = [(n, e[0], e[1], e[2], e[3])
                for n, e in _host_events.items()]
    if _trace_dir:
        rows += [(n, e[0], e[1], e[2], e[3])
                 for n, e in _device_events(_trace_dir).items()]
    if rows:
        table = _format_table(rows, sorted_key)
        print(table)
        path = profile_path or _default_dir("paddle_tpu_torch_profile.txt")
        try:
            with open(path, "w") as f:
                f.write(table + "\n")
        except OSError:
            pass
    return _trace_dir


def export_chrome_tracing(trace_dir=None, output_path=None,
                          merge_obs=True):
    """The session's trace as a chrome://tracing JSON file (default
    <trace dir>/timeline.json), the obs tracing ring's spans merged in as
    their own process rows (`merge_obs`), so the host request and step
    spans line up against the kernels.  Returns the path."""
    trace_dir = trace_dir or _trace_dir
    if trace_dir is None:
        raise ValueError("no trace captured; run the profiler first")
    src = os.path.join(trace_dir, _TRACE_FILE)
    if not os.path.exists(src):
        raise FileNotFoundError("no %s under %s" % (_TRACE_FILE, trace_dir))
    output_path = output_path or os.path.join(trace_dir, "timeline.json")
    with open(src, "rb") as f:
        raw = f.read()
    if merge_obs:
        from ..obs import tracing as obs_tracing
        spans = obs_tracing.recent_spans()
        if spans:
            try:
                data = json.loads(raw)
            except ValueError:
                data = None    # an unparseable trace is exported raw
            if data is not None:
                data.setdefault("traceEvents", []).extend(
                    obs_tracing.chrome_events(spans))
                raw = json.dumps(data).encode()
    with open(output_path, "wb") as dst:
        dst.write(raw)
    return output_path


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option=None):
    """with fluid.profiler.profiler(sorted_key="total"): ... -- prints
    the table on exit (reference profiler.py:39).  A `profile_path` that
    is a directory receives the trace too."""
    start_profiler(state, tracer_option,
                   profile_path if profile_path and
                   os.path.isdir(str(profile_path)) else None)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class RecordEvent:
    """A named host region (reference platform/profiler.h:72): its wall
    time aggregates into the table, and a `torch.profiler.record_function`
    range marks it on the trace."""

    def __init__(self, name):
        self.name = name
        self._ctx = None
        self._t0 = None

    def __enter__(self):
        import torch
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *args):
        if self._t0 is not None:
            _record(self.name, (time.perf_counter() - self._t0) * 1e3)
        self._ctx.__exit__(*args)
