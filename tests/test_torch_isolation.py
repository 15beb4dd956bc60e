"""paddle_tpu_torch stands alone: it imports neither jax nor any module of
paddle_tpu, its entry points default to the card and refuse to fall back
to the CPU, and its CUDA build is keyed by source and flags."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference import decode
from paddle_tpu_torch.ops import _build

PKG_DIR = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")


def _forbidden(name):
    # exact match: paddle_tpu_torch shares paddle_tpu's prefix
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "paddle_tpu"))


def _package_modules():
    return ["paddle_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG_DIR],
                                              "paddle_tpu_torch.")]


def _python_files():
    out = [CHIP_SMOKE]
    for root, dirs, files in os.walk(PKG_DIR):
        # build/ holds compiled kernels (and whatever else is unpacked
        # there), not the package's sources
        dirs[:] = [d for d in dirs if d != "build"]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_matches_exactly():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("paddle_tpu") and _forbidden("paddle_tpu.flags")
    assert not _forbidden("paddle_tpu_torch")
    assert not _forbidden("paddle_tpu_torch.ops")
    assert not _forbidden("jaxlib_like")


def test_importing_every_module_loads_no_jax_or_paddle_tpu():
    mods = _package_modules()
    assert {"paddle_tpu_torch.inference.decode",
            "paddle_tpu_torch.serving.batcher",
            "paddle_tpu_torch.fluid.core",
            "paddle_tpu_torch.fluid.unique_name",
            "paddle_tpu_torch.fluid.param_attr",
            "paddle_tpu_torch.fluid.framework",
            "paddle_tpu_torch.fluid.layer_helper",
            "paddle_tpu_torch.fluid.initializer",
            "paddle_tpu_torch.fluid.layers.io",
            "paddle_tpu_torch.fluid.layers.tensor",
            "paddle_tpu_torch.fluid.layers.nn",
            "paddle_tpu_torch.fluid.backward",
            "paddle_tpu_torch.fluid.optimizer",
            "paddle_tpu_torch.fluid.executor",
            "paddle_tpu_torch.fluid.io",
            "paddle_tpu_torch.fluid.ir_passes",
            "paddle_tpu_torch.fluid.transpiler",
            "paddle_tpu_torch.fluid.transpiler.inference_transpiler",
            "paddle_tpu_torch.inference.predictor",
            "paddle_tpu_torch.inference.quantize",
            "paddle_tpu_torch.ops.registry",
            "paddle_tpu_torch.ops.tensor_ops",
            "paddle_tpu_torch.ops.math_ops",
            "paddle_tpu_torch.ops.nn_ops",
            "paddle_tpu_torch.ops.optimizer_ops",
            "paddle_tpu_torch.ops.quant_ops",
            "paddle_tpu_torch.ops.pallas_kernels",
            "paddle_tpu_torch.models.transformer",
            "paddle_tpu_torch.models.resnet",
            "paddle_tpu_torch.models.mnist",
            "paddle_tpu_torch.fluid.regularizer",
            "paddle_tpu_torch.fluid.functionalizer",
            "paddle_tpu_torch.fluid.nets",
            "paddle_tpu_torch.bench"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "sys.path.insert(0, %r)\n"
        "for m in %r + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "roots = ('jax', 'paddle_tpu')\n"
        "bad = sorted(m for m in sys.modules if any(\n"
        "    m == r or m.startswith(r + '.') for r in roots))\n"
        "print('FORBIDDEN', bad)\n"
        "sys.exit(1 if bad else 0)\n" % (REPO, mods))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_or_paddle_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, "%s:%d imports %s" % (path, node.lineno, bad)


def test_default_device_is_cuda_and_never_falls_back(tmp_path,
                                                      monkeypatch):
    d = str(tmp_path / "lm")
    decode.build_tiny_decode_model(d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode.GenerativePredictor(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode.load_decode_predictor(d)
    assert decode.GenerativePredictor(d, device="cpu").device.type \
        == "cpu"


def test_tf32_is_off_for_fp32_parity():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_bf16_reduced_precision_reduction_is_off_for_bf16_parity():
    """XLA sums a bf16 matmul in fp32 and rounds once; cuBLAS may reduce a
    bf16 GEMM's partials in bf16 unless this is off."""
    assert torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction is False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_repo(tmp_path, alone):
    script = CHIP_SMOKE
    cwd = REPO
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(CHIP_SMOKE, script)
        cwd = str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    src = os.path.join(_build.CSRC_DIR, "decode_attention.cu")
    stem, path = _build._lib_path(src)
    assert stem == "decode_attention"
    assert os.path.dirname(path) == str(tmp_path)
    assert _build._lib_path(src) == (stem, path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build._lib_path(src)[1] != path
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_is_keyed_by_the_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, str(csrc))
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    src = str(csrc / "flash_attention_fwd.cu")
    before = _build._lib_path(src)[1]
    with open(str(csrc / "flash_attention_common.cuh"), "a") as f:
        f.write("// edited\n")
    assert _build._lib_path(src)[1] != before
    assert {"flash_attention_fwd", "flash_attention_bwd",
            "decode_attention", "dequant_matmul",
            "fused_bottleneck"} <= {os.path.basename(p)[:-3]
                                    for p in _build._sources()}


def test_bound_decode_symbols_are_defined_in_the_source():
    """K3 and K4 bind the C entry points of one source by ctypes (the two
    launches and the two plans): each is defined there with the argument
    count its argtypes declare."""
    from paddle_tpu_torch.ops import pallas_kernels as pk
    with open(os.path.join(_build.CSRC_DIR, "decode_attention.cu")) as f:
        src = f.read()
    assert set(pk._DECODE_ARGTYPES) == {
        "paddle_decode_attention_f32", "paddle_decode_attention_i8",
        "paddle_decode_attention_f32_plan",
        "paddle_decode_attention_i8_plan"}
    for symbol, argtypes in pk._DECODE_ARGTYPES.items():
        head = 'extern "C" cudaError_t %s(' % symbol
        assert src.count(head) == 1, symbol
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(argtypes), symbol


def test_bound_int8_plan_symbol_is_defined_in_the_source():
    """`decode_attention_int8_plan` binds K4's split by ctypes: (S, D, two
    int out-pointers), defined once in decode_attention.cu."""
    with open(os.path.join(_build.CSRC_DIR, "decode_attention.cu")) as f:
        src = f.read()
    head = 'extern "C" cudaError_t paddle_decode_attention_i8_plan('
    assert src.count(head) == 1
    params = src.split(head, 1)[1].split(")", 1)[0]
    assert [p.split()[0] for p in params.split(",")] == [
        "int", "int", "int*", "int*"]


def test_bound_f32_plan_symbol_is_defined_in_the_source():
    """`decode_attention_f32_plan` binds K3's split by ctypes: (S, D, two
    int out-pointers), defined once in decode_attention.cu."""
    with open(os.path.join(_build.CSRC_DIR, "decode_attention.cu")) as f:
        src = f.read()
    head = 'extern "C" cudaError_t paddle_decode_attention_f32_plan('
    assert src.count(head) == 1
    params = src.split(head, 1)[1].split(")", 1)[0]
    assert [p.split()[0] for p in params.split(",")] == [
        "int", "int", "int*", "int*"]


@pytest.mark.parametrize("stem,symbols", [
    ("flash_attention_fwd", ["paddle_flash_fwd_f32",
                             "paddle_flash_fwd_bf16"]),
    ("flash_attention_bwd", ["paddle_flash_bwd_dq_f32",
                             "paddle_flash_bwd_dkv_f32",
                             "paddle_flash_bwd_dq_bf16",
                             "paddle_flash_bwd_dkv_bf16"]),
    ("fused_bottleneck", ["paddle_fused_bottleneck_f32",
                          "paddle_fused_bottleneck_bf16"]),
    ("fused_bottleneck", ["paddle_fused_bottleneck_f32_plan",
                          "paddle_fused_bottleneck_bf16_plan"]),
])
def test_bound_fp32_and_bf16_symbols_are_defined_in_the_source(stem,
                                                               symbols):
    """K1, K2 and K6 bind an fp32 and a bf16 C entry each, named by the
    wrappers from the tensor's dtype (K6 also an fp32 and a bf16 launch
    plan); each is defined once in its source, with the (args pointer,
    stream or output) pair the ctypes argtypes declare."""
    from paddle_tpu_torch.ops import pallas_kernels as pk
    with open(os.path.join(_build.CSRC_DIR, stem + ".cu")) as f:
        src = f.read()
    assert set(pk._KERNEL_DTYPES.values()) == {"f32", "bf16"}
    for symbol in symbols:
        head = "%s(" % symbol
        defs = [line for line in src.splitlines()
                if line.startswith('extern "C"') and head in line]
        assert len(defs) == 1, symbol
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == 2, symbol


_SASS_LISTING = """
\tcode for sm_90a
\t\tFunction : _Z10bf16_kernelv
\t.headerflags @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        /*0030*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
\t\tFunction : _Z10tf32_kernelv
        /*0010*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t\tFunction : _Z10simt_kernelv
        /*0010*/                   FFMA R4, R8, R12, R4 ;
"""


def test_sass_counts_tell_tf32_from_bf16_tensor_core_instructions(
        monkeypatch):
    """sass_opcode_counts keeps each tensor-core instruction's full
    mnemonic, and tensor_core_counts sorts a kernel's HMMA/HGMMA by input
    type: a TF32 kernel is told from a bf16 one and from a SIMT one."""
    class Done:
        stdout = _SASS_LISTING

    calls = []
    monkeypatch.setattr(_build, "build_all", lambda: {"k": "/b/libk.so"})
    monkeypatch.setattr(_build, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or Done())
    assert _build.sass_opcode_counts("k", _build.TC_OPCODES) == {
        "_Z10bf16_kernelv": {"HMMA.16816.F32.BF16": 2,
                             "HGMMA.64x64x16.F32.BF16": 1},
        "_Z10tf32_kernelv": {"HMMA.1688.F32.TF32": 1},
        "_Z10simt_kernelv": {}}
    assert calls[0] == ["/cuda/bin/cuobjdump", "-sass", "/b/libk.so"]
    assert _build.tensor_core_counts("k") == {
        "_Z10bf16_kernelv": {"bf16": 3, "tf32": 0, "other": 0},
        "_Z10tf32_kernelv": {"bf16": 0, "tf32": 1, "other": 0},
        "_Z10simt_kernelv": {"bf16": 0, "tf32": 0, "other": 0}}


@pytest.mark.parametrize("mnemonic,kind", [
    ("HMMA.16816.F32.BF16", "bf16"), ("HMMA.1688.F32.TF32", "tf32"),
    ("HGMMA.64x128x16.F32.BF16", "bf16"), ("HMMA.16816.F32", "other")])
def test_tensor_core_mnemonic_kind(mnemonic, kind):
    assert _build.tc_kind(mnemonic) == kind


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not os.path.exists(str(tmp_path / "build"))
