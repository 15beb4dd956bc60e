"""Post-training quantization of saved inference artifacts, after
paddle_tpu/inference/quantize.py (QUANTIZE.md).

`quantize_inference_model(src, dst)` takes a frozen fp32
`save_inference_model` directory and writes a sibling int8 artifact: the
program's `mul` / `conv2d` / `lookup_table` ops rewritten to their
`dequant_*` twins (ops/quant_ops.py), each weight var re-typed int8 with
a `<w>@scale` fp32 per-output-channel scale var beside it, everything
below `FLAGS.quantize_min_weight_elems` left fp32.

Scales are per-channel symmetric int8 (q = round(W / s) clipped to
[-127, 127], s = absmax * r / 127); the clip ratio r comes from a small
search: fc weights minimise the output error ||X W - X dq(W)||^2 on the
calibration activations, other weights (or all, without calibration
feeds) the weight-space MSE.  Absmax (r = 1.0) is always a candidate.

The artifact is byte-compatible with the JAX package's: the same .npy
bytes, a CRC32 per quantized file in `quant_meta.bin` (encoded with the
port's copy of the wire codec), written into a `<dst>.tmp.*` directory,
fsynced, then renamed into place, so a crash mid-write leaves the source
and any previously committed artifact intact.  The JAX package's chaos
points and its build-time verifier are not ported.

The calibration runs on the card unless `place` says otherwise.
"""

import binascii
import hashlib
import io
import json
import os
import shutil
import threading

import numpy as np
import torch

from ..flags import FLAGS
from ..fluid.io import _host
from ..native import wire

__all__ = [
    "QUANT_META", "QuantizedArtifactError", "quantize_inference_model",
    "read_quant_meta", "is_quantized_dir", "verify_quantized_dir",
    "check_quantized_dir", "artifact_precision",
]

QUANT_META = "quant_meta.bin"
SCHEMA_VERSION = 1
_TINY_SCALE = 1e-12
_QMAX = 127.0
# the clip ratios the scale search tries, absmax first (the JAX package's
# defaults)
_CLIP_RATIOS = (1.0, 0.95, 0.9, 0.8)


class QuantizedArtifactError(RuntimeError):
    """A quantized artifact failed its payload verification; the
    message names the corrupt file."""


def _npy_bytes(arr):
    """The .npy serialization of `arr`, as the JAX package's checkpoint
    vault writes it."""
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


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


# ---------------------------------------------------------------------------
# scale selection
# ---------------------------------------------------------------------------

def _channel_absmax(w, reduce_axes):
    return np.maximum(np.abs(w).max(axis=reduce_axes), _TINY_SCALE)


def _quantize_array(w, scale, ch_axis):
    """Symmetric per-channel int8: broadcast `scale` along `ch_axis`."""
    shape = [1] * w.ndim
    shape[ch_axis] = -1
    s = scale.reshape(shape)
    q = np.clip(np.rint(w / s), -_QMAX, _QMAX).astype(np.int8)
    return q


def _dequant(q, scale, ch_axis):
    shape = [1] * q.ndim
    shape[ch_axis] = -1
    return q.astype(np.float32) * scale.reshape(shape)


def _pick_scale(w, reduce_axes, ch_axis, clip_ratios, acts=None):
    """Search the clip ratio minimizing reconstruction error.  `acts`
    (fc only): captured calibration activations [rows, K] — the error
    is then measured where it matters, on the layer OUTPUT."""
    absmax = _channel_absmax(w, reduce_axes)
    best = None
    for r in clip_ratios:
        scale = (absmax * float(r) / _QMAX).astype(np.float32)
        q = _quantize_array(w, scale, ch_axis)
        dq = _dequant(q, scale, ch_axis)
        if acts is not None and w.ndim == 2 and ch_axis == 1:
            err = float(np.mean(
                (acts @ w.astype(np.float32) - acts @ dq) ** 2))
        else:
            err = float(np.mean((w.astype(np.float32) - dq) ** 2))
        if best is None or err < best[0]:
            best = (err, float(r), scale, q)
    return best  # (err, clip_ratio, scale, q)


# candidate quantized ops: op type -> (weight slot, scale reduce axes,
# channel axis).  mul weights are [K, N] (channel = output column),
# conv filters OIHW (channel = O), embeddings [V, D] (channel = row —
# the gathered axis).
_CANDIDATES = {
    "mul": ("Y", (0,), 1),
    "conv2d": ("Filter", (1, 2, 3), 0),
    "lookup_table": ("W", (1,), 0),
}


def _supported(op, block, scope, min_elems):
    """(weight_name, spec) when this op quantizes, else None."""
    spec = _CANDIDATES.get(op.type)
    if spec is None:
        return None
    slot, reduce_axes, ch_axis = spec
    names = op.inputs.get(slot) or []
    if len(names) != 1:
        return None
    v = block._find_var_recursive(names[0])
    if v is None or not v.persistable or v.shape is None:
        return None
    if op.type == "conv2d" and int(op.attrs.get("groups", 1) or 1) != 1:
        return None  # grouped/depthwise: per-O scale story differs
    val = scope.get(names[0])
    if val is None:
        return None
    arr = _host(val)
    if arr.dtype != np.float32 or arr.size < int(min_elems):
        return None
    if op.type == "mul" and arr.ndim != 2:
        return None
    return names[0], spec


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _capture_activations(exe, scope, program, calib_feeds, wanted,
                         max_batches):
    """Run the fp32 program over the calibration batches fetching the
    mul ops' input vars; returns {var_name: [rows, K] fp32}.  A failed
    run raises: where the JAX package falls back to weight-only scales,
    the port does not turn a device fault into another artifact."""
    from .. import fluid
    if not calib_feeds or not wanted:
        return {}
    acc = {n: [] for n, _ in wanted}
    with fluid.scope_guard(scope):
        for feed in list(calib_feeds)[:max_batches]:
            outs = exe.run(program, feed=dict(feed),
                           fetch_list=[n for n, _ in wanted])
            for (name, xd), val in zip(wanted, outs):
                a = np.asarray(val, dtype=np.float32)
                lead = int(np.prod(a.shape[:xd])) if xd > 0 else 1
                acc[name].append(a.reshape(lead, -1))
    return {n: np.concatenate(v, axis=0) for n, v in acc.items() if v}


def _fetch_outputs(exe, scope, program, calib_feeds, fetch_names,
                   max_batches):
    from .. import fluid
    outs = []
    with fluid.scope_guard(scope):
        for feed in list(calib_feeds)[:max_batches]:
            outs.append([np.asarray(o) for o in exe.run(
                program, feed=dict(feed), fetch_list=list(fetch_names))])
    return outs


def _accuracy_delta(fp32_outs, q_outs):
    """Pinned per-fetch delta between the fp32 and quantized artifacts
    on the calibration batches: max |delta|, mean |delta|, and (for
    class-prob-shaped fetches) top-1 agreement."""
    deltas = {"max_abs": 0.0, "mean_abs": 0.0}
    n, mean_sum = 0, 0.0
    agree, total = 0, 0
    for ref_batch, q_batch in zip(fp32_outs, q_outs):
        for ref, q in zip(ref_batch, q_batch):
            ref = np.asarray(ref, np.float32)
            q = np.asarray(q, np.float32)
            if ref.shape != q.shape:
                return {"error": "fetch shape changed: %s vs %s"
                        % (ref.shape, q.shape)}
            d = np.abs(ref - q)
            deltas["max_abs"] = max(deltas["max_abs"],
                                    float(d.max()) if d.size else 0.0)
            mean_sum += float(d.mean()) if d.size else 0.0
            n += 1
            if ref.ndim == 2 and ref.shape[1] > 1:
                agree += int((ref.argmax(1) == q.argmax(1)).sum())
                total += ref.shape[0]
    deltas["mean_abs"] = mean_sum / max(n, 1)
    if total:
        deltas["top1_agreement"] = agree / total
    return deltas


# ---------------------------------------------------------------------------
# the PTQ pass
# ---------------------------------------------------------------------------

def quantize_inference_model(src_dir, dst_dir=None, calib_feeds=None,
                             model_filename=None, place=None):
    """Quantize a `save_inference_model` artifact dir into a sibling int8
    artifact (`<src>_int8` by default); returns a summary dict (dst,
    per-layer table, byte counts, calibration deltas).

    `calib_feeds`: feed dicts (name -> batch array); at most
    `FLAGS.quantize_calib_batches` are used, for the scale search and the
    accuracy delta.  Without them the scales are weight-space and no
    delta is recorded; a calibration run that fails raises, and nothing
    is written.  `place`: where the calibration runs (the card by
    default; `fluid.CPUPlace()` for the CPU)."""
    from .. import fluid
    from ..fluid import core as fcore
    from ..fluid.framework import Program
    from ..ops.quant_ops import quantized_op_for

    min_elems = int(FLAGS.quantize_min_weight_elems)
    max_batches = max(int(FLAGS.quantize_calib_batches), 1)
    src_dir = os.path.abspath(src_dir)
    dst_dir = os.path.abspath(dst_dir) if dst_dir \
        else src_dir.rstrip("/\\") + "_int8"

    exe = fluid.Executor(place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        program, feed_names, fetch_vars = fluid.load_inference_model(
            src_dir, exe, model_filename=model_filename)
    fetch_names = [v.name for v in fetch_vars]
    gb = program.global_block()

    # -- candidates (a weight consumed by ANY unsupported op stays fp32:
    #    its var dtype cannot be two things at once) ----------------------
    consumers = {}
    for op in gb.ops:
        for name in op.input_arg_names:
            consumers.setdefault(name, []).append(op)
    candidates = []        # (op_index, op, weight_name, spec)
    weights = {}           # weight_name -> spec (dedup for shared weights)
    for idx, op in enumerate(gb.ops):
        hit = _supported(op, gb, scope, min_elems)
        if hit is None:
            continue
        wname, spec = hit
        if any(_CANDIDATES.get(c.type) is None
               for c in consumers.get(wname, ())):
            continue
        prev = weights.get(wname)
        if prev is not None and prev != spec:
            continue  # the same weight feeding mul AND conv: leave fp32
        weights[wname] = spec
        candidates.append((idx, op, wname, spec))

    # -- calibration activations for the fc (mul) layers -----------------
    wanted = []
    for idx, op, wname, spec in candidates:
        if op.type == "mul":
            xd = int(op.attrs.get("x_num_col_dims", 1))
            wanted.append((op.inputs["X"][0], xd))
    acts = _capture_activations(exe, scope, program, calib_feeds,
                                sorted(set(wanted)), max_batches)

    # -- quantize every candidate weight ----------------------------------
    layers = []
    q_arrays = {}          # weight_name -> int8 array
    s_arrays = {}          # scale var name -> fp32 scale array
    fp32_bytes = 0
    quant_bytes = 0
    for idx, op, wname, spec in candidates:
        if wname in q_arrays:
            layers.append({"op_index": idx, "op_type": op.type,
                           "weight": wname, "shared": True})
            continue
        slot, reduce_axes, ch_axis = spec
        w = np.asarray(_host(scope.get(wname)), dtype=np.float32)
        layer_acts = None
        if op.type == "mul":
            layer_acts = acts.get(op.inputs["X"][0])
        err, ratio, scale, q = _pick_scale(w, reduce_axes, ch_axis,
                                           _CLIP_RATIOS, acts=layer_acts)
        sname = wname + "@scale"
        q_arrays[wname] = q
        s_arrays[sname] = scale.astype(np.float32)
        fp32_bytes += w.nbytes
        quant_bytes += q.nbytes + scale.nbytes
        layers.append({
            "op_index": idx, "op_type": op.type, "weight": wname,
            "scale": sname, "shape": list(w.shape),
            "clip_ratio": ratio, "mse": err,
            "calibrated": layer_acts is not None,
        })

    if not q_arrays:
        raise ValueError(
            "nothing to quantize in %r: no supported weight at or above "
            "the %d-element floor (FLAGS.quantize_min_weight_elems)"
            % (src_dir, min_elems))

    # -- rewrite the program ----------------------------------------------
    serialized_src = program.serialize_to_string()
    q_program = Program.parse_from_string(serialized_src)
    qgb = q_program.global_block()
    int8_dtype = fcore.convert_np_dtype_to_dtype_(np.int8)
    for idx, op, wname, spec in candidates:
        qop = qgb.ops[idx]
        qop.type = quantized_op_for(op.type)
        qop.inputs["Scale"] = [wname + "@scale"]
        qop.attrs["act_dtype"] = "bfloat16"
        qop.attrs["quant_axis"] = int(spec[2])
    for wname in q_arrays:
        qgb.vars[wname].dtype = int8_dtype
    for sname, scale in s_arrays.items():
        qgb.create_var(name=sname, shape=list(scale.shape),
                       dtype="float32", persistable=True)
    serialized = q_program.serialize_to_string()

    # -- the quantized persistable value set ------------------------------
    values = {}
    for v in qgb.vars.values():
        if not v.persistable:
            continue
        if v.name in q_arrays:
            values[v.name] = q_arrays[v.name]
        elif v.name in s_arrays:
            values[v.name] = s_arrays[v.name]
        else:
            val = scope.get(v.name)
            if val is not None:
                values[v.name] = _host(val)

    # -- accuracy delta on the calibration batches ------------------------
    calibration = {"batches": 0}
    if calib_feeds:
        fp32_outs = _fetch_outputs(exe, scope, program, calib_feeds,
                                   fetch_names, max_batches)
        q_scope = fluid.Scope()
        for name, arr in values.items():
            q_scope.set(name, torch.from_numpy(np.array(arr)).to(
                exe.device))
        q_outs = _fetch_outputs(exe, q_scope, q_program, calib_feeds,
                                fetch_names, max_batches)
        calibration = _accuracy_delta(fp32_outs, q_outs)
        calibration["batches"] = min(len(list(calib_feeds)), max_batches)

    # -- commit the artifact: temp dir, fsync, rename ---------------------
    parent = os.path.dirname(dst_dir) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = "%s.tmp.%d.%x" % (dst_dir, os.getpid(), threading.get_ident())
    # sweep stale in-flight dirs of THIS dst (a quantizer killed
    # mid-write leaves one; the next commit is the crash repair)
    base = os.path.basename(dst_dir) + ".tmp."
    for name in os.listdir(parent):
        if name.startswith(base):
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
    os.makedirs(tmp)

    def _write(fname, data):
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    crcs = {}
    for name, arr in values.items():
        fname = name.replace("/", "__") + ".npy"
        data = _npy_bytes(np.ascontiguousarray(arr))
        _write(fname, data)
        if name in q_arrays or name in s_arrays:
            crcs[fname] = binascii.crc32(data) & 0xFFFFFFFF
    meta = {
        "schema": SCHEMA_VERSION,
        "precision": "int8",
        "act_dtype": "bfloat16",
        "layers": layers,
        "crc32": crcs,
        "bytes": {
            "fp32_weight_bytes": int(fp32_bytes),
            "quant_weight_bytes": int(quant_bytes),
            "ratio": round(quant_bytes / max(fp32_bytes, 1), 4),
        },
        "source": {
            "dir": src_dir,
            "program_sha256": hashlib.sha256(
                serialized_src.encode()).hexdigest(),
        },
        "calibration": calibration,
        "min_weight_elems": int(min_elems),
        "clip_ratios": list(_CLIP_RATIOS),
    }
    _write(QUANT_META, wire.encode(meta))
    _write(model_filename or "__model__", json.dumps({
        "program": serialized,
        "feed_names": list(feed_names),
        "fetch_names": fetch_names,
    }).encode())
    _fsync_dir(tmp)
    if os.path.isdir(dst_dir):
        # re-quantizing over a prior artifact: move it aside only now,
        # with every byte of the replacement durable in tmp
        trash = dst_dir + ".old.%d" % os.getpid()
        os.rename(dst_dir, trash)
        shutil.rmtree(trash, ignore_errors=True)
    os.rename(tmp, dst_dir)
    _fsync_dir(parent)

    return {
        "dst": dst_dir,
        "layers": layers,
        "bytes": dict(meta["bytes"]),
        "calibration": dict(calibration),
        "n_quantized": len(q_arrays),
    }


# ---------------------------------------------------------------------------
# artifact inspection / verification
# ---------------------------------------------------------------------------

def is_quantized_dir(dirname):
    return os.path.exists(os.path.join(dirname, QUANT_META))


def artifact_precision(dirname):
    """'int8' for a quantized artifact dir, 'fp32' otherwise — the
    precision axis the serving registry files a load under."""
    if is_quantized_dir(dirname):
        meta = read_quant_meta(dirname)
        return str(meta.get("precision", "int8"))
    return "fp32"


def read_quant_meta(dirname):
    path = os.path.join(dirname, QUANT_META)
    with open(path, "rb") as f:
        return wire.decode(f.read())


def verify_quantized_dir(dirname):
    """CRC-walk the quantized payloads (int8 weights + scale tables)
    against the quant_meta.bin table; returns [(file, error-or-None)]
    — the JAX package's tools/verify_quantized.py renders the same
    list."""
    try:
        meta = read_quant_meta(dirname)
    except Exception as e:
        return [(QUANT_META, "does not decode: %s: %s"
                 % (type(e).__name__, e))]
    if meta.get("schema") != SCHEMA_VERSION:
        return [(QUANT_META, "schema %r (this build reads %d)"
                 % (meta.get("schema"), SCHEMA_VERSION))]
    out = []
    for fname, want in sorted((meta.get("crc32") or {}).items()):
        path = os.path.join(dirname, fname)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            out.append((fname, "missing payload file (%s)" % e))
            continue
        got = binascii.crc32(data) & 0xFFFFFFFF
        if got != int(want):
            out.append((fname, "failed CRC32 (manifest %08x != file "
                        "%08x)" % (int(want), got)))
        else:
            out.append((fname, None))
    if not out:
        out.append((QUANT_META, "empty CRC table — no quantized "
                    "payloads recorded"))
    return out


def check_quantized_dir(dirname):
    """Load-boundary gate: raise QuantizedArtifactError naming the
    first corrupt int8 payload / scale table.  fluid.io.
    load_inference_model calls this for every quant_meta.bin dir, so a
    tampered quantized artifact is rejected before any weight loads."""
    for fname, err in verify_quantized_dir(dirname):
        if err is not None:
            raise QuantizedArtifactError(
                "quantized artifact %s: %s: %s" % (dirname, fname, err))
