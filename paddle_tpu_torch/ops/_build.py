"""Build the port's hand-written CUDA kernels at first use.

Every `csrc/*.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), and
loads through ctypes.  One nvcc process per source, all started
together.  Libraries land in `paddle_tpu_torch/build/` under a name
carrying the hash of the source, the shared `csrc/*.cuh` headers and the
flags, so an edited source or header rebuilds and an unchanged one loads
as it is.
"""

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "KernelError",
           "build_all", "load", "build_logs", "sass_opcode_counts",
           "TC_OPCODES", "tc_kind", "tensor_core_counts"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
# sm_90a keeps Hopper's wgmma/setmaxnreg available to the kernels;
# -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
# source stem -> nvcc's output (ptxas register/spill report) of the
# build this process ran; empty when the library was already built
build_logs = {}


class KernelError(RuntimeError):
    """A CUDA kernel could not be built, loaded or launched."""


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError(
        "paddle_tpu_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin) — the CUDA kernels build on a host with "
        "the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _lib_path(src):
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return stem, os.path.join(BUILD_DIR, "lib%s_%s.so"
                              % (stem, h.hexdigest()[:16]))


def build_all():
    """Compile every source whose library is missing at its current
    hash, in parallel; returns {source stem: library path}.  Raises with
    nvcc's output when a build fails."""
    with _lock:
        built = [(_lib_path(src), src) for src in _sources()]
        libs = {stem: out for (stem, out), _ in built}
        todo = [(stem, src, out) for (stem, out), src in built
                if not os.path.exists(out)]
        if not todo:
            return libs
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        try:
            for stem, src, out in todo:
                tmp = "%s.tmp%d" % (out, os.getpid())
                procs.append((stem, out, tmp, subprocess.Popen(
                    [nvcc] + NVCC_FLAGS + ["-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for stem, out, tmp, proc in procs:
                log, _ = proc.communicate()
                build_logs[stem] = log
                if proc.returncode:
                    failed.append("%s (exit %d):\n%s"
                                  % (stem, proc.returncode, log))
                else:
                    os.replace(tmp, out)
        finally:
            for _, _, tmp, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
        if failed:
            raise KernelError("nvcc failed for " + "\n".join(failed))
        return libs


def load(stem):
    """The ctypes library built from `csrc/<stem>.cu` (built first when
    needed).  The caller sets each function's argtypes/restype."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    libs = build_all()
    if stem not in libs:
        raise KernelError("no CUDA source csrc/%s.cu" % stem)
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            try:
                lib = ctypes.CDLL(libs[stem])
            except OSError as e:
                raise KernelError("cannot load %s: %s" % (libs[stem], e))
            _libs[stem] = lib
    return lib


def sass_opcode_counts(stem, opcodes):
    """{kernel (mangled name): {mnemonic: count}} in the machine code of
    the library built from `csrc/<stem>.cu`, read with the toolkit's
    `cuobjdump -sass`: every instruction whose opcode is one of `opcodes`,
    counted under its full mnemonic with the modifiers that name its
    shape and types (e.g. HMMA.16816.F32.BF16 for a bf16 mma.sync,
    HMMA.1688.F32.TF32 for a tf32 one, HGMMA... for wgmma)."""
    lib = build_all()[stem]
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    pattern = re.compile(r"\b(?:%s)(?:\.\w+)*"
                         % "|".join(map(re.escape, opcodes)))
    counts, fn = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            fn = counts.setdefault(head.group(1), {})
        elif fn is not None:
            for op in pattern.findall(line):
                fn[op] = fn.get(op, 0) + 1
    return counts


# tensor-core instructions: HMMA (mma.sync) and HGMMA (wgmma)
TC_OPCODES = ("HMMA", "HGMMA")


def tc_kind(mnemonic):
    """The input type of a tensor-core mnemonic: "bf16", "tf32" or
    "other"."""
    mods = mnemonic.split(".")[1:]
    return "bf16" if "BF16" in mods else "tf32" if "TF32" in mods \
        else "other"


def tensor_core_counts(stem):
    """{kernel (mangled name): {"bf16": n, "tf32": n, "other": n}}: the
    tensor-core instructions of each kernel in `csrc/<stem>.cu`'s library,
    by input type."""
    out = {}
    for fn, counts in sass_opcode_counts(stem, TC_OPCODES).items():
        kinds = dict.fromkeys(("bf16", "tf32", "other"), 0)
        for op, n in counts.items():
            kinds[tc_kind(op)] += n
        out[fn] = kinds
    return out
