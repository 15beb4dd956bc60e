"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, for one NVIDIA
H100.

The package mirrors paddle_tpu's module paths so each port sits beside
its counterpart (`inference/decode.py`, `serving/batcher.py`,
`ops/pallas_kernels.py`, `native/wire.py`, `flags.py`).  It imports
torch and numpy only — never jax and never a module of `paddle_tpu` —
and keeps its own copy of what it needs from the JAX package.

Entry points run on the card: `device=None` means "cuda", and a host
without CUDA raises instead of falling back to the CPU.  Callers that
want the CPU (the tests) pass `device="cpu"`; there every hand-written
kernel's wrapper runs its plain PyTorch version.
"""

import torch

__all__ = ["resolve_device"]

# fp32 parity: the JAX package computes its fp32 matmuls in full fp32,
# and the port is held against it (and batched decode against
# single-request decode) at fp32 tolerances.  TF32 keeps ~10 mantissa
# bits, so it stays off for matmuls and cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 parity: XLA sums a bf16 matmul in fp32 and rounds once, and the
# port's bf16 paths (AMP training, bf16 serving) are held to that.
# cuBLAS may otherwise reduce a bf16 GEMM's split-K partials in bf16.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None):
    """The torch.device an entry point computes on.  None means "cuda";
    a CUDA device on a host without CUDA raises (never a silent CPU
    fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: device %r requested but CUDA is not "
            "available on this host; pass device='cpu' explicitly to "
            "run the plain PyTorch path" % (str(dev),))
    return dev
