"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by nvcc for ``sm_90a`` into a shared library with a
plain C interface and loaded with ctypes.  The build runs at first use (or
through :func:`build`, which starts one nvcc per source, all together) into
``lameness_tpu_torch/_build/``; a library's file name carries a hash of its
sources and flags, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("attention", "sam_window_attention", "sam_global_attention",
           "sam_global_attention_v1", "sam_global_attention_v2",
           "sam_global_attention_v3", "sam_window_attention_v1",
           "sam_window_attention_v2", "sam_window_attention_v5")
# sm_90a (not sm_90): wgmma and setmaxnreg exist only there.  No -lcuda: the
# one libcuda function used, cuTensorMapEncodeTiled (TMA descriptors of the
# wgmma route of K3-K6), is looked up at run time through the CUDA runtime.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# every kernel wrapper, by name: chip_smoke.py zeroes and reads the counts
KERNELS: Dict[str, "CudaKernel"] = {}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)     # instantiated in csrc/attention.cuh


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ with the CUDA toolkit at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together.  Returns seconds per library built (0.0 when it was
    already there).  Raises with nvcc's output when a build fails; the
    compiler's report (``-Xptxas -v``: registers, spills) is kept beside the
    library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed: List[str] = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def ptxas_entries(log: str) -> List[Dict[str, str]]:
    """Per kernel of an nvcc ``-Xptxas -v`` report: its mangled name, the
    registers line and the stack/spill line ptxas printed for it."""
    entries: List[Dict[str, str]] = []
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            entries.append({"name": line.split("'")[1], "registers": "",
                            "spills": ""})
        elif entries and "bytes stack frame" in line:
            entries[-1]["spills"] = line.strip()
        elif entries and "Used " in line and "registers" in line:
            entries[-1]["registers"] = line.split("Used ")[1].split(",")[0]
    return entries


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` goes up by one per successful launch and nowhere else.  A
    non-zero ``cudaError_t`` from the C function (a refused launch, say)
    raises; nothing falls back."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: List[type]):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes + [ctypes.c_void_p]     # + the stream
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: cudaError_t {err}")
        self.launches += 1


def strides_array(*triples) -> ctypes.Array:
    """Flatten per-tensor {outer, head, token} element strides for C."""
    flat = [int(s) for t in triples for s in t]
    return (ctypes.c_longlong * len(flat))(*flat)


def check_operands(name: str, tensors, dtype: Optional[torch.dtype] = None
                   ) -> None:
    """Raise unless every tensor is on one CUDA device, of one supported
    dtype, with a contiguous innermost axis (the kernels take strides for
    the other axes), and none asks for a gradient: the kernels have no
    backward, so under grad mode their outputs would come back detached
    and the weights before them would get no gradient without an error."""
    first = tensors[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires grad, and the CUDA kernel has no "
            f"backward; run it under torch.no_grad() (inference) or on CPU "
            f"tensors, whose plain version is differentiable")
    dtype = dtype or first.dtype
    if first.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {first.device}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32, bfloat16)")
    for t in tensors:
        if t.device != first.device or t.dtype != dtype:
            raise ValueError(f"{name}: operands differ in device or dtype "
                             f"({t.device}/{t.dtype} vs {first.device}/"
                             f"{dtype})")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: innermost axis must be contiguous")


def check_chunked_rows(name: str, tensors) -> None:
    """The bf16 kernel copies q, k and v rows in 16-byte chunks: raise
    unless each tensor's address and outer strides allow that."""
    for t in tensors:
        if t.dtype != torch.bfloat16:
            continue
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: bf16 operands need 16-byte aligned "
                             f"rows (address {t.data_ptr()}, strides "
                             f"{t.stride()})")


def check_head_dim(name: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not built "
                         f"(supported: {HEAD_DIMS})")

