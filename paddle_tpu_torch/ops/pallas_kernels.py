"""The port's hand-written kernels, named after the JAX module whose Pallas
kernels they replace (paddle_tpu/ops/pallas_kernels.py).

Each kernel has three parts here: a plain PyTorch version with the TPU
kernel's exact semantics (`*_reference`), a wrapper that runs the plain
version for a tensor on the CPU and launches the CUDA kernel for a tensor
on the card (never falling back from one to the other), and a count of
the kernel's launches in `launch_counts`.

Ported so far: K3 and K4, `decode_attention` with fp32 caches and with
int8 caches and per-head dequant scales, and K4's head-slice entry
`decode_attention_head_slice` (csrc/decode_attention.cu); K1, the
flash-attention forward (csrc/flash_attention_fwd.cu); K2, its backward
dq and dk/dv kernels (csrc/flash_attention_bwd.cu), joined to K1 by a
torch.autograd.Function; K5, `dequant_matmul` (csrc/dequant_matmul.cu),
the int8-weight matmul of the quantized inference lane; K6,
`fused_bottleneck` (csrc/fused_bottleneck.cu), a whole BN-folded ResNet
bottleneck block.  K1, K2 and K6 each have an fp32 and a bf16 entry
(the dtypes the JAX package runs them in: bf16 under AMP training for
K1/K2, bf16 serving for K6), counted apart; the bf16 plain versions round
where the TPU kernels cast.  The bf16 kernels run on the tensor cores
(K1/K2: csrc/flash_attention_tc.cuh; K6: csrc/fused_bottleneck_tc.cuh; K5
with bf16 x in csrc/dequant_matmul.cu); so do the fp32 K1, K2 and K6, on
TF32 tiles at fp32 accuracy (3xTF32: csrc/tc_common.cuh), and K5 with
fp32 x (two products: an int8 weight is exact in TF32).  K3 and K4 split
each row's positions over a thread-block cluster.
The `flash_attention` and `fused_bottleneck` ops, through which fluid
programs reach K1/K2 and K6, are registered here too.
"""

import ctypes
import weakref

import numpy as np
import torch

from . import _build
from ._build import KernelError

__all__ = ["decode_attention", "decode_attention_reference",
           "decode_attention_head_slice", "decode_attention_f32_plan",
           "decode_attention_int8_plan",
           "flash_attention",
           "flash_attention_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_reference", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_reference", "dequant_matmul",
           "dequant_matmul_reference", "fused_bottleneck",
           "fused_bottleneck_bf16_plan", "fused_bottleneck_fp32_plan",
           "bottleneck_reference", "pad_channels_call",
           "pad_head_dim_call", "KernelError",
           "launch_counts", "reset_launch_counts"]

# Finite mask value (not -inf), as in the TPU kernels: exp(_NEG_INF -
# finite) underflows to an exact 0 and a fully masked row stays finite.
_NEG_INF = -1e30
_TINY = 1e-20
# head dims the decode kernel's templates are built for (D / VEC lanes per
# cached row, a power of two that divides a warp); any D up to the
# largest runs the next of them with the real D at run time, reading the
# caches in place (csrc/decode_attention.cu, kRagged)
_KERNEL_HEAD_DIMS = (4, 8, 16, 32, 64, 128, 256)

# kernel name -> launches of its CUDA kernel in this process (a call that
# runs the plain version never counts)
launch_counts = {"decode_attention": 0, "decode_attention_int8": 0,
                 "decode_attention_head_slice": 0, "flash_attention_fwd": 0,
                 "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                 "flash_attention_fwd_bf16": 0,
                 "flash_attention_bwd_dq_bf16": 0,
                 "flash_attention_bwd_dkv_bf16": 0,
                 "dequant_matmul": 0, "fused_bottleneck": 0,
                 "fused_bottleneck_bf16": 0}

# the dtypes K1/K2 and K6 take on the card -> C entry suffix; the bf16
# instantiations count under "<kernel>_bf16"
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _count_name(kernel, dtype):
    return kernel if dtype == torch.float32 else kernel + "_bf16"


def _rounded(t, dtype):
    """t (fp32) rounded to `dtype` and back to fp32: where a TPU kernel
    casts with `.astype(dtype)` before a product; the identity for fp32."""
    return t.to(dtype).float()

_fns = {}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


_DECODE_ARGTYPES = {
    # q, k, v, lengths, out; P, S, H, D, qps; scale; stream
    "paddle_decode_attention_f32": [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, lengths, kv_scales, out; P, S, H, D, qps, h_total,
    # head_offset; scale; stream
    "paddle_decode_attention_i8": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
    # S, D; cluster and share out
    "paddle_decode_attention_f32_plan": [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)],
    "paddle_decode_attention_i8_plan": [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)],
}


def _decode_plan(symbol, name, S, D):
    cluster, share = ctypes.c_int(), ctypes.c_int()
    if _decode_attention_fn(symbol)(int(S), int(D), ctypes.byref(cluster),
                                    ctypes.byref(share)):
        raise ValueError("%s: S %d, D %d not taken" % (name, S, D))
    return {"cluster": cluster.value, "share": share.value}


def decode_attention_f32_plan(S, D):
    """K3's split of each row for fp32 caches of S positions at head dim
    D, as csrc/decode_attention.cu computes it: {"cluster": blocks per
    (slot, head), "share": positions each block takes}.  Fixed by S and
    D alone.  Builds the CUDA library (needs nvcc)."""
    return _decode_plan("paddle_decode_attention_f32_plan",
                        "decode_attention_f32_plan", S, D)


def decode_attention_int8_plan(S, D):
    """K4's split of each row for int8 caches, as
    `decode_attention_f32_plan` gives K3's."""
    return _decode_plan("paddle_decode_attention_i8_plan",
                        "decode_attention_int8_plan", S, D)


def _decode_attention_fn(symbol):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load("decode_attention"), symbol)
        fn.argtypes = _DECODE_ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def decode_attention_reference(q, k_cache, v_cache, lengths, scale=None,
                               kv_scales=None, q_per_slot=1):
    """Plain PyTorch version of the TPU kernel's semantics (paddle_tpu's
    `decode_attention_reference`): q [P, H, D] one new token per
    (pseudo-)slot, k/v caches [P / q_per_slot, S, H, D] (fp32, or int8
    with `kv_scales`), lengths [P] live cached positions per row -> [P,
    H, D] in q's dtype.  Row p reads cache slot p // q_per_slot.
    Positions >= length score the finite -1e30; the normaliser is floored
    at 1e-20, so a length-0 row yields the mean of its S value rows.
    `kv_scales` [2, H] f32 applies the per-head dequant algebra: the K
    scale on the scaled scores, the V scale after the normalising
    divide."""
    S = k_cache.shape[1]
    H, D = q.shape[1], q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))
    if q_per_slot != 1:
        k_cache = k_cache.repeat_interleave(q_per_slot, dim=0)
        v_cache = v_cache.repeat_interleave(q_per_slot, dim=0)
    s = torch.einsum("nhd,nshd->nhs", q.float(), k_cache.float()) * scale
    if kv_scales is not None:
        sc = torch.as_tensor(kv_scales, dtype=torch.float32,
                             device=q.device).reshape(2, H)
        s = s * sc[0][None, :, None]
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    mask = torch.arange(S, device=q.device)[None, None, :] \
        >= lengths[:, None, None]
    s = s.masked_fill(mask, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(dim=-1), _TINY)
    o = torch.einsum("nhs,nshd->nhd", p, v_cache.float()) / l[..., None]
    if kv_scales is not None:
        o = o * sc[1][None, :, None]
    return o.to(q.dtype)


def _decode_attention_cuda(q, k_cache, v_cache, lengths, scale, kv_scales,
                           q_per_slot, head_offset, count):
    """Check what K3 / K4 take, launch on the current stream, count."""
    quant = kv_scales is not None
    named = [("k_cache", k_cache), ("v_cache", v_cache),
             ("lengths", lengths)] + ([("kv_scales", kv_scales)]
                                      if quant else [])
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.device != q.device:
            raise ValueError("decode_attention: %s must be a tensor on %s"
                             % (name, q.device))
    cache_dtype = torch.int8 if quant else torch.float32
    for name, t, dt in (("q", q, torch.float32),
                        ("k_cache", k_cache, cache_dtype),
                        ("v_cache", v_cache, cache_dtype),
                        ("lengths", lengths, torch.int32)) + (
            (("kv_scales", kv_scales, torch.float32),) if quant else ()):
        if t.dtype != dt:
            raise TypeError("decode_attention: %s must be %s, got %s"
                            % (name, dt, t.dtype))
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("decode_attention: q must be [P, H, D] and the "
                         "caches [N, S, H, D]")
    P, H, D = q.shape
    S = k_cache.shape[1]
    qps = int(q_per_slot)
    if qps < 1 or P % qps:
        raise ValueError("decode_attention: %d q rows are not a multiple "
                         "of q_per_slot %d" % (P, qps))
    N = P // qps
    if tuple(k_cache.shape) != (N, S, H, D) \
            or tuple(v_cache.shape) != (N, S, H, D) \
            or tuple(lengths.shape) != (P,):
        raise ValueError(
            "decode_attention: shapes q %s, k %s, v %s, lengths %s do not "
            "agree (q_per_slot %d)" % (tuple(q.shape), tuple(k_cache.shape),
                                       tuple(v_cache.shape),
                                       tuple(lengths.shape), qps))
    h_total = H
    if quant:
        if kv_scales.dim() != 2 or kv_scales.shape[0] != 2:
            raise ValueError("decode_attention: kv_scales must be [2, H], "
                             "got %s" % (tuple(kv_scales.shape),))
        h_total = kv_scales.shape[1]
        if not 0 <= head_offset <= h_total - H:
            raise ValueError("decode_attention: heads [%d, %d) outside the "
                             "%d-head scale table" % (head_offset,
                                                      head_offset + H,
                                                      h_total))
    if not 1 <= D <= _KERNEL_HEAD_DIMS[-1]:
        raise ValueError("decode_attention: head dim %d outside [1, %d]"
                         % (D, _KERNEL_HEAD_DIMS[-1]))
    if not all(t.is_contiguous() for _, t in named + [("q", q)]):
        raise ValueError("decode_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    cache_align = 4 if quant else 16
    if q.data_ptr() % 16 or out.data_ptr() % 16 \
            or k_cache.data_ptr() % cache_align \
            or v_cache.data_ptr() % cache_align:
        raise ValueError("decode_attention: q must be 16-byte and the "
                         "caches %d-byte aligned" % cache_align)
    if P == 0 or H == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quant:
            err = _decode_attention_fn("paddle_decode_attention_i8")(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), kv_scales.data_ptr(), out.data_ptr(),
                P, S, H, D, qps, h_total, head_offset, scale, stream)
        else:
            err = _decode_attention_fn("paddle_decode_attention_f32")(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), P, S, H, D, qps, scale,
                stream)
    if err:
        raise KernelError("%s: CUDA kernel launch failed (cudaError %d)"
                           % (count, err))
    launch_counts[count] += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths, scale=None,
                     kv_scales=None, q_per_slot=1):
    """Slot-cache decode attention: q [P, H, D] f32, k_cache/v_cache [P /
    q_per_slot, S, H, D], lengths [P] int32 -> [P, H, D] float32.  Row p
    attends cache slot p // q_per_slot over its own length (the
    speculative verify step's pseudo-slots; 1 for the plain step).

    float32 caches run K3.  int8 caches run K4 and need `kv_scales` [2,
    H] f32 (K scales row 0, V scales row 1: the per-head dequant scales
    of the quantized slot table, one layer's slice); float32 caches take
    none.  A CPU tensor runs `decode_attention_reference`.  A CUDA tensor
    launches csrc/decode_attention.cu on the current stream after
    checking device, dtype, shape, contiguity and alignment — it raises
    on anything the kernel does not take, and on a failed launch."""
    quant = k_cache.dtype == torch.int8 or v_cache.dtype == torch.int8
    if quant and kv_scales is None:
        raise ValueError(
            "decode_attention: int8 KV caches need kv_scales [2, H] "
            "(per-head fp32 dequant scales)")
    if not quant and kv_scales is not None:
        raise ValueError("decode_attention: kv_scales apply to int8 KV "
                         "caches only, got %s caches" % k_cache.dtype)
    if quant:
        kv_scales = torch.as_tensor(kv_scales, device=q.device).reshape(
            2, q.shape[1])
    D = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale=scale, kv_scales=kv_scales,
                                          q_per_slot=q_per_slot)
    if q.device.type != "cuda":
        raise ValueError("decode_attention: unsupported device %s"
                         % q.device)
    return _decode_attention_cuda(
        q, k_cache, v_cache, lengths, scale, kv_scales, q_per_slot, 0,
        "decode_attention_int8" if quant else "decode_attention")


def decode_attention_head_slice(q, k_cache, v_cache, lengths, head_offset,
                                n_local_heads, scale=None, kv_scales=None):
    """The tensor-parallel entry: decode attention over one member's
    resident head block.  q/k_cache/v_cache are the LOCAL head shards
    ([N, Hl, D] / [N, S, Hl, D], Hl = n_local_heads); `kv_scales`, for
    int8 caches, is the FULL per-layer table [2, H_total] (or [2,
    H_total, 1]), and the block's window starts at `head_offset`.  Heads
    are independent, so each head's result equals `decode_attention` on
    the full table.

    A CPU tensor runs the plain version on the block's [2, Hl] window.
    On the card int8 caches launch K4 with the table's pointer and the
    offset (the table is not sliced or copied); float32 caches take no
    scales and run K3 on the block."""
    Hl = int(n_local_heads)
    if q.dim() != 3 or q.shape[1] != Hl:
        raise ValueError("decode_attention_head_slice: q %s does not hold "
                         "%d local heads" % (tuple(q.shape), Hl))
    if kv_scales is None:
        return decode_attention(q, k_cache, v_cache, lengths, scale=scale)
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise ValueError("decode_attention_head_slice: kv_scales apply to "
                         "int8 KV caches only, got %s caches"
                         % k_cache.dtype)
    full = torch.as_tensor(kv_scales, device=q.device)
    full = full.reshape(2, full.numel() // 2)
    off = int(head_offset)
    if not 0 <= off <= full.shape[1] - Hl:
        raise ValueError("decode_attention_head_slice: heads [%d, %d) "
                         "outside the %d-head scale table"
                         % (off, off + Hl, full.shape[1]))
    scale = float(scale if scale is not None else 1.0 / np.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, lengths, scale=scale,
            kv_scales=full[:, off:off + Hl])
    if q.device.type != "cuda":
        raise ValueError("decode_attention_head_slice: unsupported device "
                         "%s" % q.device)
    return _decode_attention_cuda(q, k_cache, v_cache, lengths, scale, full,
                                  1, off, "decode_attention_head_slice")


# ---------------------------------------------------------------------------
# flash attention: K1 (forward) and K2 (backward dq, dk/dv), the training
# path's kernels.  q, k, v are [B, S, H, D] (the JAX package's public
# layout); the kernels read any strides over B, S and H with D contiguous,
# so the q/k/v column slices of a fused qkv projection go in without a
# copy.  The row statistics lse and di are [B, H, S] fp32.  q, k, v (and
# do) are fp32 or bf16, all alike; outputs are in their dtype.
# ---------------------------------------------------------------------------

# head dims the CUDA kernels are built for (fp32 and bf16 alike); a
# smaller D runs zero-padded to the next of them (`_flash_width`).  The
# 256 instantiation holds 32-row tiles, its warps in pairs over the
# columns (csrc/flash_attention_common.cuh, tile_rows).
_FLASH_HEAD_DIMS = (64, 128, 256)


def _flash_width(D):
    """The instantiated head dim a call of head dim D runs at."""
    for w in _FLASH_HEAD_DIMS:
        if D <= w:
            return w
    raise ValueError(
        "flash_attention: head dim %d > %d is not taken on the card: even "
        "a 32-row fp32 tile set of q, k and v that wide is past one "
        "block's shared memory, and needs a loop over D slices "
        "(ROADMAP.md queue 2, kernel work item 1)"
        % (D, _FLASH_HEAD_DIMS[-1]))


def _pad_last(t, width):
    """t zero-padded along its last axis to `width`."""
    n = t.shape[-1]
    return t if n == width else torch.nn.functional.pad(t, (0, width - n))


def pad_head_dim_call(fn, width, tensors, *args):
    """`fn(*tensors, *args)` with the [B, S, H, D] `tensors` zero-padded
    along D to `width`, and fn's [B, S, H, width] outputs sliced back to
    D (its [B, H, S] row statistics as they are).  The scale in `args`
    is the original D's: the zero columns add nothing to q . k^T and
    nothing to do . v, and they give zero columns of o, dq, dk and dv,
    which the slice drops."""
    D = tensors[0].shape[-1]
    out = fn(*[_pad_last(t, width) for t in tensors], *args)

    def back(t):
        return t[..., :D].contiguous() if t.dim() == 4 else t

    return tuple(back(t) for t in out) if isinstance(out, tuple) \
        else back(out)


class _T4(ctypes.Structure):
    """PaddleT4 of csrc/flash_attention_common.cuh: one [B, S, H, D] view."""
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("ss", ctypes.c_longlong), ("sh", ctypes.c_longlong)]


_DIMS = [("B", ctypes.c_int), ("S", ctypes.c_int), ("H", ctypes.c_int),
         ("D", ctypes.c_int), ("scale", ctypes.c_float),
         ("causal", ctypes.c_int)]


class _FlashFwdArgs(ctypes.Structure):
    _fields_ = [(n, _T4) for n in ("q", "k", "v", "o")] + [
        ("lse", ctypes.c_void_p)] + _DIMS


class _FlashBwdArgs(ctypes.Structure):
    _fields_ = [(n, _T4) for n in ("q", "k", "v", "dout", "dq", "dk",
                                   "dv")] + [
        ("lse", ctypes.c_void_p), ("di", ctypes.c_void_p)] + _DIMS


def _flash_fn(stem, symbol):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load(stem), symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _scale_of(q, scale):
    return float(scale if scale is not None else 1.0 / np.sqrt(q.shape[-1]))


def _scores(q, k, scale, causal):
    """s [B, H, Sq, Sk] = (q . k) * scale in fp32; with `causal`, keys
    after the query score the finite -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = torch.arange(Sk, device=q.device)[None, :] \
            > torch.arange(Sq, device=q.device)[:, None]
        s = s.masked_fill(mask, _NEG_INF)
    return s


def _flash_di(o, do, dlse=None):
    """di [B, H, S] = rowsum(do * o) - dlse, as `_fa_bwd` forms it."""
    di = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        di = di - dlse.float()
    return di.contiguous()


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch version of K1 with the TPU kernel's semantics: q, k, v
    [B, S, H, D] -> (o [B, S, H, D] in q's dtype, lse [B, H, S] fp32).
    Masked scores are the finite -1e30, the normaliser is floored at
    1e-20 and lse = m + log(l).  Products and sums are fp32; for bf16
    inputs p is rounded to v's dtype before p . v (the kernel's
    `p.astype(vb.dtype)`), while l sums the unrounded p.  Differentiable
    by autograd in fp32 (the row max is a constant of the softmax, so it
    is detached)."""
    scale = _scale_of(q, scale)
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), _TINY)
    o = torch.einsum("bhqk,bkhd->bqhd", _rounded(p, v.dtype), v.float()) \
        / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, di, causal=False,
                                     scale=None):
    """Plain PyTorch version of K2's dq kernel: with p = exp(s - lse) and
    ds = p * (do . v - di) * scale, dq = ds . k  ([B, S, H, D]); for bf16
    inputs ds is rounded to k's dtype before the product."""
    scale = _scale_of(q, scale)
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = _rounded(p * (dp - di[..., None]) * scale, k.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, causal=False,
                                      scale=None):
    """Plain PyTorch version of K2's dk/dv kernel: dk = ds^T . q and
    dv = p^T . do  (each [B, S, H, D]); for bf16 inputs p is rounded to
    do's dtype and ds to q's before the products."""
    scale = _scale_of(q, scale)
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = _rounded(p * (dp - di[..., None]) * scale, q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, do.dtype), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  scale=None, dlse=None):
    """(dq, dk, dv) of the attention from the forward's o and lse [B, H,
    S] and the cotangents do (and dlse [B, H, S]), without autograd: the
    plain versions of both K2 kernels.  di is formed from the cotangent as
    given; the kernels then take do in q's dtype (`_fa_bwd`'s cast)."""
    di = _flash_di(o, do, dlse)
    do = do.to(q.dtype)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, di, causal,
                                          scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, di,
                                               causal, scale)
    return dq, dk, dv


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              return_lse=False):
    """Attention with the kernels' mask and floor conventions, in plain
    PyTorch and differentiated by autograd: [B, S, H, D] -> [B, S, H, D]
    (or (o, lse [B, S, H]) with return_lse).  Autograd treats the bf16
    rounding casts as the identity, so for bf16 inputs `flash_attention`
    differentiates through the plain K2 versions instead."""
    o, lse = flash_attention_fwd_reference(q, k, v, causal, scale)
    return (o, lse.transpose(1, 2)) if return_lse else o


def _plain_device(t):
    """True where a wrapper runs the plain version: a CPU tensor, or a
    meta tensor (shape inference, no data)."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError("flash_attention: unsupported device %s" % t.device)
    return False


def _flash_check(q, named):
    """Raise on anything the CUDA kernels do not take: the [B, S, H, D]
    operands all float32 or all bfloat16, read by 16-byte loads (D
    contiguous, strides that are multiples of 16 bytes — 4 fp32 or 8 bf16
    elements — and a 16-byte aligned start); the row statistics fp32."""
    if q.dim() != 4:
        raise ValueError("flash_attention: q must be [B, S, H, D], got %s"
                         % (tuple(q.shape),))
    B, S, H, D = q.shape
    if D not in _FLASH_HEAD_DIMS:
        raise ValueError("flash_attention: head dim %d not in %s"
                         % (D, _FLASH_HEAD_DIMS))
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError("flash_attention: q must be float32 or bfloat16, "
                        "got %s" % q.dtype)
    vec = 16 // q.element_size()
    for name, t, shape in named:
        if not isinstance(t, torch.Tensor) or t.device != q.device:
            raise ValueError("flash_attention: %s must be a tensor on %s"
                             % (name, q.device))
        want = q.dtype if len(shape) == 4 else torch.float32
        if t.dtype != want:
            raise TypeError("flash_attention: %s must be %s (as q is %s), "
                            "got %s" % (name, want, q.dtype, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("flash_attention: %s has shape %s, expected %s"
                             % (name, tuple(t.shape), shape))
        if len(shape) == 4:
            if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                    or t.data_ptr() % 16:
                raise ValueError(
                    "flash_attention: %s must have D contiguous, strides "
                    "that are multiples of %d elements and a 16-byte "
                    "aligned start" % (name, vec))
        elif not t.is_contiguous():
            raise ValueError("flash_attention: %s must be contiguous" % name)
    return B, S, H, D


def _t4(t):
    return _T4(t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _flash_launch(symbol, stem, args, device, count):
    fn = _flash_fn(stem, symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    if err:
        raise KernelError("%s: CUDA kernel launch failed (cudaError %d)"
                           % (count, err))
    launch_counts[count] += 1


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    width = _flash_width(q.shape[-1])
    if width != q.shape[-1]:
        return pad_head_dim_call(_flash_fwd_cuda, width, (q, k, v), causal,
                                 scale)
    shape = tuple(q.shape)
    B, S, H, D = _flash_check(q, [("q", q, shape), ("k", k, shape),
                                  ("v", v, shape)])
    o = torch.empty(shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * H == 0 or S == 0:
        return o, lse
    args = _FlashFwdArgs(_t4(q), _t4(k), _t4(v), _t4(o), lse.data_ptr(),
                         B, S, H, D, scale, int(causal))
    _flash_launch("paddle_flash_fwd_" + _KERNEL_DTYPES[q.dtype],
                  "flash_attention_fwd", args, q.device,
                  _count_name("flash_attention_fwd", q.dtype))
    return o, lse


def _flash_bwd(kernel, q, k, v, do, lse, di, causal, scale, outs):
    width = _flash_width(q.shape[-1])
    if width != q.shape[-1]:
        return list(pad_head_dim_call(
            lambda *a: tuple(_flash_bwd(kernel, *a, outs)), width,
            (q, k, v, do), lse, di, causal, scale))
    shape = tuple(q.shape)
    rows = (shape[0], shape[2], shape[1])
    B, S, H, D = _flash_check(q, [
        ("q", q, shape), ("k", k, shape), ("v", v, shape),
        ("do", do, shape), ("lse", lse, rows), ("di", di, rows)])
    grads = [torch.empty(shape, dtype=q.dtype, device=q.device)
             for _ in outs]
    if B * H == 0 or S == 0:
        return grads
    named = dict(zip(outs, grads))
    empty = _T4(0, 0, 0, 0)
    args = _FlashBwdArgs(
        _t4(q), _t4(k), _t4(v), _t4(do),
        *[_t4(named[n]) if n in named else empty
          for n in ("dq", "dk", "dv")],
        lse.data_ptr(), di.data_ptr(), B, S, H, D, scale, int(causal))
    symbol = "paddle_%s_%s" % (kernel.replace("_attention", ""),
                               _KERNEL_DTYPES[q.dtype])
    _flash_launch(symbol, "flash_attention_bwd", args, q.device,
                  _count_name(kernel, q.dtype))
    return grads


def _flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       di: torch.Tensor, causal: bool, scale: float
                       ) -> torch.Tensor:
    return _flash_bwd("flash_attention_bwd_dq", q, k, v, do, lse, di,
                      causal, scale, ("dq",))[0]


def _flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        di: torch.Tensor, causal: bool, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    dk, dv = _flash_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, di,
                        causal, scale, ("dk", "dv"))
    return dk, dv


# The launches are torch.library custom ops, so torch.func transforms
# (which hand the backward wrapped tensors) reach the kernels with plain
# CUDA tensors, below their wrappers.
_flash_fwd_op = torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_fwd", _flash_fwd_cuda,
    mutates_args=(), device_types="cuda")
_flash_bwd_dq_op = torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_bwd_dq", _flash_bwd_dq_cuda,
    mutates_args=(), device_types="cuda")
_flash_bwd_dkv_op = torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_bwd_dkv", _flash_bwd_dkv_cuda,
    mutates_args=(), device_types="cuda")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """K1: q, k, v [B, S, H, D] fp32 or bf16 -> (o [B, S, H, D] in their
    dtype, lse [B, H, S] fp32).

    A CPU (or meta) tensor runs `flash_attention_fwd_reference`.  A CUDA
    tensor launches csrc/flash_attention_fwd.cu on the current stream
    after checking device, dtype, shape, layout and alignment; it raises
    on anything the kernel does not take, and on a failed launch."""
    scale = _scale_of(q, scale)
    if _plain_device(q):
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    return _flash_fwd_op(q, k, v, bool(causal), scale)


def flash_attention_bwd_dq(q, k, v, do, lse, di, causal=False, scale=None):
    """K2, dq kernel: q, k, v, do [B, S, H, D], lse and di [B, H, S] ->
    dq [B, S, H, D].  CPU (or meta) tensors run the plain version; a CUDA
    tensor launches csrc/flash_attention_bwd.cu's dq kernel or raises."""
    scale = _scale_of(q, scale)
    if _plain_device(q):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, di,
                                                causal, scale)
    return _flash_bwd_dq_op(q, k, v, do, lse, di, bool(causal), scale)


def flash_attention_bwd_dkv(q, k, v, do, lse, di, causal=False,
                            scale=None):
    """K2, dk/dv kernel: same inputs as the dq kernel -> (dk, dv), each
    [B, S, H, D].  CPU (or meta) tensors run the plain version; a CUDA
    tensor launches csrc/flash_attention_bwd.cu's dkv kernel or raises."""
    scale = _scale_of(q, scale)
    if _plain_device(q):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, di,
                                                 causal, scale)
    return _flash_bwd_dkv_op(q, k, v, do, lse, di, bool(causal), scale)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward: the port's `jax.custom_vjp` of
    `flash_attention`, through the wrappers (the kernels on the card, the
    plain versions on the CPU).  The setup_context form keeps it usable
    under torch.autograd.grad and torch.func alike."""

    @staticmethod
    def forward(q, k, v, causal, scale):
        return flash_attention_fwd(q, k, v, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.scale = scale

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        di = _flash_di(o, do, dlse)
        do = do.to(q.dtype).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, do, lse, di, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False):
    """Fused attention, q, k, v [B, S, H, D] -> [B, S, H, D] (or (out, lse
    [B, S, H] fp32) with return_lse), differentiable.

    On the card it runs K1 forward and K2 backward (`_FlashAttention`);
    an fp32 CPU (or meta) tensor runs `flash_attention_reference`, which
    autograd differentiates, and a bf16 one `_FlashAttention` over the
    plain versions, whose backward rounds ds (and p) as K2 does.  The
    kernels pick their own 64-row tiles and mask the ragged tail, so any S
    works (the JAX op falls back to plain attention when no block divides
    S)."""
    scale = _scale_of(q, scale)
    if _plain_device(q) and q.dtype == torch.float32:
        return flash_attention_reference(q, k, v, causal, scale, return_lse)
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), scale)
    return (o, lse.transpose(1, 2)) if return_lse else o


# ---------------------------------------------------------------------------
# framework op: fluid programs reach K1/K2 through this op type
# ---------------------------------------------------------------------------

from .registry import register_op  # noqa: E402


@register_op("flash_attention")
def _flash_attention_op(ctx):
    """q, k, v [B, S, H, D], or [B, S, H * D] with the `num_heads` attr."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    reshaped = q.dim() == 3
    if reshaped:
        H = int(ctx.attr("num_heads", 1))
        B, S, Dm = q.shape
        if Dm % H:
            raise ValueError(
                "flash_attention: hidden size %d not divisible by "
                "num_heads %d" % (Dm, H))
        q, k, v = (t.reshape(B, S, H, Dm // H) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=bool(ctx.attr("causal", False)))
    if reshaped:
        out = out.reshape(B, S, Dm)
    return {"Out": out}


# ---------------------------------------------------------------------------
# K5: the fused dequant-matmul of the quantized inference lane.  x [M, K]
# (fp32 or bf16 activations) times int8 weights [K, N] dequantized
# in-register, fp32 accumulation, the per-output-channel scale applied
# once to the fp32 accumulator.
# ---------------------------------------------------------------------------

def dequant_matmul_reference(x, w_q, scale, out_dtype=None):
    """Plain PyTorch version of K5 with the JAX reference's numerics:
    x [M, K] float, w_q [K, N] int8, scale [N] fp32 -> [M, N] in
    `out_dtype` (x's dtype by default).  The weight dequantizes through
    x's dtype (an int8 value is exact in bf16 and fp32), products and
    sums are fp32, and the scale multiplies the fp32 accumulator."""
    acc = torch.matmul(x.float(), w_q.to(x.dtype).float())
    return (acc * scale.float()).to(out_dtype or x.dtype)


_DEQUANT_DTYPES = (torch.float32, torch.bfloat16)
# K5 splits K over blocks while its output tiles number fewer than this
# (two blocks per SM of the H100), keeping >= 256 of K per slice
_DEQUANT_MIN_BLOCKS = 264
# K5's output tile (rows, columns) by x dtype (csrc/dequant_matmul.cu:
# kTile for bf16 x, kF32M x kF32N for fp32 x)
_DEQUANT_TILE = {torch.bfloat16: (64, 64), torch.float32: (128, 64)}


def _dequant_k_slices(M, N, K, tile):
    """How many K slices K5 runs (1 = no split) over output tiles of
    `tile` = (rows, columns): enough blocks to fill the card, at most 16
    slices, none shorter than 256."""
    tiles = -(-M // tile[0]) * -(-N // tile[1])
    return max(1, min(_DEQUANT_MIN_BLOCKS // tiles, K // 256, 16))


def _dequant_matmul_fn():
    fn = _fns.get("dequant_matmul")
    if fn is None:
        fn = _build.load("dequant_matmul").paddle_dequant_matmul
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["dequant_matmul"] = fn
    return fn


def dequant_matmul(x, w_q, scale, out_dtype=None):
    """K5: x [M, K] fp32/bf16, w_q [K, N] int8, scale [N] fp32 -> [M, N]
    in `out_dtype` (fp32 or bf16; x's dtype by default), at any M, K, N.

    A CPU (or meta) tensor runs `dequant_matmul_reference`.  A CUDA
    tensor launches csrc/dequant_matmul.cu on the current stream (bf16
    tensor cores for bf16 x, TF32 tensor cores in two products for fp32
    x) after
    checking device, dtypes, shapes and contiguity; it raises on anything
    the kernel does not take, and on a failed launch."""
    out_dtype = out_dtype or x.dtype
    if x.device.type in ("cpu", "meta"):
        return dequant_matmul_reference(x, w_q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError("dequant_matmul: unsupported device %s" % x.device)
    for name, t in (("w_q", w_q), ("scale", scale)):
        if not isinstance(t, torch.Tensor) or t.device != x.device:
            raise ValueError("dequant_matmul: %s must be a tensor on %s"
                             % (name, x.device))
    if x.dtype not in _DEQUANT_DTYPES or out_dtype not in _DEQUANT_DTYPES:
        raise TypeError("dequant_matmul: x and out must be float32 or "
                        "bfloat16, got %s -> %s" % (x.dtype, out_dtype))
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("dequant_matmul: w_q must be int8 and scale "
                        "float32, got %s, %s" % (w_q.dtype, scale.dtype))
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1] \
            or tuple(scale.shape) != (w_q.shape[1],):
        raise ValueError("dequant_matmul: shapes x %s, w_q %s, scale %s do "
                         "not agree" % (tuple(x.shape), tuple(w_q.shape),
                                        tuple(scale.shape)))
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("dequant_matmul: inputs must be contiguous")
    M, K = x.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    slices = _dequant_k_slices(M, N, K, _DEQUANT_TILE[x.dtype])
    work = torch.empty((slices, M, N), dtype=torch.float32,
                       device=x.device) if slices > 1 else None
    fn = _dequant_matmul_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), M, N, K, slices,
                 0 if work is None else work.data_ptr(), stream)
    if err:
        raise KernelError("dequant_matmul: CUDA kernel launch failed "
                           "(cudaError %d)" % err)
    launch_counts["dequant_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# K6: the fused ResNet bottleneck (inference, BN folded).  One NHWC block
# — 1x1 + bias + relu, 3x3 (stride s, pad 1) + bias + relu, 1x1 + bias,
# plus the identity or the 1x1/s projection shortcut, relu — in one
# launch, the two intermediate activations kept in shared memory.  The
# kernel reads the filters in the program's OIHW layout.
# ---------------------------------------------------------------------------

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def bottleneck_reference(x, w0, b0, w1, b1, w2, b2, ws=None, bs=None,
                         stride=1):
    """Plain PyTorch version of K6: x [N, H, W, C] NHWC, filters OIHW —
    w0 [F, C, 1, 1], w1 [F, F, 3, 3], w2 [C4, F, 1, 1], ws [C4, C, 1, 1]
    (None: identity shortcut) — biases [F], [F], [C4], [C4] -> [N, Ho, Wo,
    C4] in x's dtype with Ho = (H - 1) // stride + 1, as three (four)
    convolutions.

    The numerics of the JAX kernel and reference in any dtype: each
    filter is cast to x's dtype (`w.astype(v.dtype)`), the convolutions
    and bias adds are fp32, a and h are rounded to x's dtype after bias +
    relu, y + shortcut is fp32 and the output is rounded to x's dtype.
    For fp32 every cast is the identity."""
    import torch.nn.functional as F
    s = int(stride)
    dt = x.dtype

    def conv(v, w, **kw):
        return F.conv2d(v.float(), w.to(dt).float(), **kw)

    def bias(b):
        return b.float().reshape(1, -1, 1, 1)

    xc = _nchw(x)
    a = torch.relu(conv(xc, w0) + bias(b0)).to(dt)
    h = torch.relu(conv(a, w1, stride=s, padding=1) + bias(b1)).to(dt)
    y = conv(h, w2) + bias(b2)
    if ws is not None:
        short = conv(xc, ws, stride=s) + bias(bs)
    else:
        short = xc.float()
    return torch.relu(y + short).to(dt).permute(0, 2, 3, 1)


class _BottleneckArgs(ctypes.Structure):
    """PaddleBottleneckArgs of csrc/fused_bottleneck.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "w0", "b0", "w1", "b1", "w2", "b2", "ws", "bs", "out")] + [
        (n, ctypes.c_int) for n in ("N", "H", "W", "C", "F", "C4",
                                    "stride")]


def _fused_bottleneck_fn(symbol):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load("fused_bottleneck"), symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def fused_bottleneck(x, w0, b0, w1, b1, w2, b2, ws=None, bs=None,
                     stride=1):
    """K6 on the program's layouts: x [N, H, W, C] NHWC, OIHW filters and
    biases as `bottleneck_reference` takes them; stride 1 or 2, any H and
    W.  A CPU (or meta) tensor runs the plain version.  A CUDA tensor
    launches csrc/fused_bottleneck.cu on the current stream — its fp32
    kernel (3xTF32 tensor-core tiles at fp32 accuracy; any C, F and C4),
    or its bf16 one (counted as `fused_bottleneck_bf16`; operands
    16-byte aligned; C, F and C4 that are not multiples of 8 run
    zero-padded to them, `pad_channels_call`), every operand of x's
    dtype — after checking device, dtypes,
    shapes and contiguity; it raises on anything the kernel does not
    take, and on a failed launch."""
    s = int(stride)
    if x.device.type in ("cpu", "meta"):
        return bottleneck_reference(x, w0, b0, w1, b1, w2, b2, ws, bs, s)
    if x.device.type != "cuda":
        raise ValueError("fused_bottleneck: unsupported device %s"
                         % x.device)
    if x.dim() != 4:
        raise ValueError("fused_bottleneck: x must be [N, H, W, C], got %s"
                         % (tuple(x.shape),))
    N, H, W, C = x.shape
    F = w0.shape[0]
    C4 = w2.shape[0]
    branch = ws is not None
    if s not in (1, 2):
        raise ValueError("fused_bottleneck: stride must be 1 or 2, got %d"
                         % s)
    if not branch and (s != 1 or C != C4):
        raise ValueError("fused_bottleneck: the identity shortcut needs "
                         "stride 1 and C == C4")
    named = [("x", x, (N, H, W, C)), ("w0", w0, (F, C, 1, 1)),
             ("b0", b0, (F,)), ("w1", w1, (F, F, 3, 3)), ("b1", b1, (F,)),
             ("w2", w2, (C4, F, 1, 1)), ("b2", b2, (C4,))]
    if branch:
        named += [("ws", ws, (C4, C, 1, 1)), ("bs", bs, (C4,))]
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError("fused_bottleneck: x must be float32 or bfloat16, "
                        "got %s" % x.dtype)
    for name, t, shape in named:
        if not isinstance(t, torch.Tensor) or t.device != x.device:
            raise ValueError("fused_bottleneck: %s must be a tensor on %s"
                             % (name, x.device))
        if t.dtype != x.dtype:
            raise TypeError("fused_bottleneck: %s must be %s as x is, got "
                            "%s" % (name, x.dtype, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("fused_bottleneck: %s has shape %s, expected "
                             "%s" % (name, tuple(t.shape), shape))
        if not t.is_contiguous():
            raise ValueError("fused_bottleneck: %s must be contiguous"
                             % name)
    if x.dtype == torch.bfloat16:
        # the tensor-core kernel reads 16-byte rows of 8 channels: a
        # ragged channel edge runs zero-padded to a multiple of 8
        if C % 8 or F % 8 or C4 % 8:
            return pad_channels_call(fused_bottleneck, x, w0, b0, w1, b1,
                                     w2, b2, ws, bs, s)
        for name, t, _ in named:
            if t.data_ptr() % 16:
                raise ValueError("fused_bottleneck: bf16 %s must be 16-byte "
                                 "aligned" % name)
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    out = torch.empty((N, Ho, Wo, C4), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    args = _BottleneckArgs(
        x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ws.data_ptr() if branch else 0, bs.data_ptr() if branch else 0,
        out.data_ptr(), N, H, W, C, F, C4, s)
    fn = _fused_bottleneck_fn("paddle_fused_bottleneck_"
                              + _KERNEL_DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    count = _count_name("fused_bottleneck", x.dtype)
    if err:
        raise KernelError("%s: CUDA kernel launch failed (cudaError %d)"
                          % (count, err))
    launch_counts[count] += 1
    return out


# id(weight) -> (weakref to it, its version, its zero-padded copy): a
# weight is padded once, and again only after an in-place change
_PADDED_WEIGHTS = {}


def _padded_once(t, shape):
    """t zero-padded at the end of each axis to `shape`, made once per
    weight tensor."""
    if t is None or tuple(t.shape) == tuple(shape):
        return t
    try:
        version = t._version
    except RuntimeError:  # an inference tensor: never changed in place
        version = None
    key = id(t)
    hit = _PADDED_WEIGHTS.get(key)
    if hit is not None and hit[0]() is t and hit[1] == version \
            and tuple(hit[2].shape) == tuple(shape):
        return hit[2]
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    _PADDED_WEIGHTS[key] = (
        weakref.ref(t, lambda _, k=key: _PADDED_WEIGHTS.pop(k, None)),
        version, out)
    return out


def _up8(n):
    return -(-n // 8) * 8


def pad_channels_call(fn, x, w0, b0, w1, b1, w2, b2, ws=None, bs=None,
                      stride=1):
    """`fn` (fused_bottleneck or its plain version) on the bottleneck
    with C, F and C4 zero-padded to multiples of 8: x's channels, the
    folded filters and biases (each padded once, `_padded_once`) and the
    shortcut; the output sliced back to C4 channels.  A zero input
    channel meets zero filter taps and a zero bias, so every sum is
    unchanged; the padded output channels are relu(0 + 0) = 0 and are
    dropped."""
    C, F, C4 = x.shape[-1], w0.shape[0], w2.shape[0]
    Cp, Fp, C4p = _up8(C), _up8(F), _up8(C4)
    xp = _pad_last(x, Cp).contiguous()
    out = fn(xp, _padded_once(w0, (Fp, Cp, 1, 1)), _padded_once(b0, (Fp,)),
             _padded_once(w1, (Fp, Fp, 3, 3)), _padded_once(b1, (Fp,)),
             _padded_once(w2, (C4p, Fp, 1, 1)), _padded_once(b2, (C4p,)),
             _padded_once(ws, (C4p, Cp, 1, 1)), _padded_once(bs, (C4p,)),
             stride)
    return out[..., :C4].contiguous()


def _bottleneck_plan(kind, N, H, W, C, F, C4, stride, branch):
    symbol = "paddle_fused_bottleneck_%s_plan" % kind
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load("fused_bottleneck"), symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    args = _BottleneckArgs(0, 0, 0, 0, 0, 0, 0, 1 if branch else 0, 0, 0,
                           N, H, W, C, F, C4, int(stride))
    out = (ctypes.c_int * 6)()
    err = fn(ctypes.addressof(args), out)
    if err:
        raise KernelError("fused_bottleneck_%s_plan: cudaError %d"
                          % (kind, err))
    return dict(zip(("R", "blocks", "smem_bytes", "blocks_per_sm", "regs",
                     "tile_rows"), out))


def fused_bottleneck_bf16_plan(N, H, W, C, F, C4, stride=1, branch=True):
    """The launch geometry K6-bf16 picks for a call of these sizes on the
    current card: {"R": output rows per block, "blocks", "smem_bytes"
    (dynamic shared memory a block), "blocks_per_sm" (resident), "regs"
    (registers a thread), "tile_rows" (rows of a block's GEMM tile)}.
    Needs the card."""
    return _bottleneck_plan("bf16", N, H, W, C, F, C4, stride, branch)


def fused_bottleneck_fp32_plan(N, H, W, C, F, C4, stride=1, branch=True):
    """The launch geometry fp32 K6 picks, as `fused_bottleneck_bf16_plan`
    returns it.  Needs the card."""
    return _bottleneck_plan("f32", N, H, W, C, F, C4, stride, branch)


@register_op("fused_bottleneck")
def _fused_bottleneck_op(ctx):
    """The op FuseBottleneckPass emits: the filters arrive in OIHW, as the
    program holds them, and go to the kernel without a transpose."""
    x = ctx.input("X")
    if not x.is_contiguous():
        x = x.contiguous()
    branch = ctx.has_input("Ws")
    return {"Out": fused_bottleneck(
        x, ctx.input("W0"), ctx.input("B0"), ctx.input("W1"),
        ctx.input("B1"), ctx.input("W2"), ctx.input("B2"),
        ws=ctx.input("Ws") if branch else None,
        bs=ctx.input("Bs") if branch else None,
        stride=int(ctx.attr("stride", 1)))}
