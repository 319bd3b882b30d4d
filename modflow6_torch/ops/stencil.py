"""7-point structured-stencil SpMV: the hand-written CUDA kernel, its
build and binding, and its plain PyTorch version.

``stencil7`` (one product) and ``bind_stencil7`` (the product with one
fixed system, which ``ops.system.make_matvec`` returns) replace the Pallas
TPU kernel modflow6_tpu/ops/pallas_stencil.py:_kernel (wrapper
``spmv_structured_pallas``).  On a CUDA tensor they launch the kernel in
``csrc/stencil7.cu`` or raise; on CPU tensors they run the plain version
``spmv_structured``, which is also the kernel's test oracle.  There is no
fallback from the kernel to the plain version.

The kernel is compiled with nvcc for sm_90a at first use into
``modflow6_torch/_build/`` (named by a hash of the source and flags, so a
changed source is rebuilt) and bound with ctypes through a plain C
interface.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from ..utils.profiler import launches

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "stencil7.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lib = None


def shifted(arr, axis, d, fill=0.0):
    """Neighbour values offset by d along axis; ``fill`` beyond the border."""
    out = torch.full_like(arr, fill)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if d == +1:
        src[axis], dst[axis] = slice(1, None), slice(None, -1)
    else:
        src[axis], dst[axis] = slice(None, -1), slice(1, None)
    out[tuple(dst)] = arr[tuple(src)]
    return out


def spmv_structured(shape, diag, off, x):
    """Plain PyTorch 7-point-stencil SpMV (port of
    modflow6_tpu/ops/system.py:39-68): the [N, 6] slot matrix [E,W,N,S,U,D]
    as six shifted multiplies."""
    nlay, nrow, ncol = shape
    x3 = x.reshape(shape)
    c = off.reshape(nlay, nrow, ncol, 6)
    y = diag.reshape(shape) * x3
    y = y + c[..., 0] * shifted(x3, 2, +1)   # east
    y = y + c[..., 1] * shifted(x3, 2, -1)   # west
    y = y + c[..., 2] * shifted(x3, 1, -1)   # north
    y = y + c[..., 3] * shifted(x3, 1, +1)   # south
    y = y + c[..., 4] * shifted(x3, 0, -1)   # up
    y = y + c[..., 5] * shifted(x3, 0, +1)   # down
    return y.reshape(-1)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def compile_library(source_path: Path, stem: str) -> tuple[Path, str]:
    """Compile ``source_path`` with ``NVCC_FLAGS`` into
    ``BUILD_DIR/<stem>-<hash>.so`` if this source has not been built yet.

    Returns (library path, compiler output); the output is empty when the
    library was already built.
    """
    source = source_path.read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"{stem}-{key[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source_path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def build() -> tuple[Path, str]:
    """Compile the kernel library if this source has not been built yet
    (``compile_library``)."""
    return compile_library(SOURCE, "libstencil7")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for fn in (lib.stencil7_f32, lib.stencil7_f64):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.stencil7_error_string.argtypes = [ctypes.c_int]
        lib.stencil7_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(shape, diag, off):
    """Shape, dtype, device and layout checks of the bound system."""
    nlay, nrow, ncol = (int(s) for s in shape)
    n = nlay * nrow * ncol
    if min(nlay, nrow, ncol) < 1 or max(nlay, nrow, ncol) > 2**31 - 1:
        raise ValueError(f"grid shape {shape} is not supported")
    dtype = diag.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil7 takes float32 or float64, not {dtype}")
    for name, t, want in (("diag", diag, (n,)), ("off", off, (n, 6))):
        if t.device != diag.device:
            raise ValueError(f"{name} is on {t.device}, diag on "
                             f"{diag.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, diag is {dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return nlay, nrow, ncol


def bind_stencil7(shape, diag, off):
    """x -> A x for the fixed structured 7-point matrix (diag[N], off[N, 6]).

    CPU tensors: the plain version.  CUDA tensors: diag and off are checked
    and the kernel is bound once here; each call checks only x, launches
    the sm_90a kernel on the current stream of diag's device (which must be
    the current device) and counts it (``utils.profiler.launches``).
    Either way the product carries its system as ``matvec.stencil7 =
    ((nlay, nrow, ncol), diag, off)``.
    """
    if diag.device.type == "cpu":
        def matvec(x):
            if x.device.type != "cpu":
                raise ValueError(f"x is on {x.device}, diag on the CPU")
            return spmv_structured(shape, diag, off, x)
        matvec.stencil7 = (tuple(int(s) for s in shape), diag, off)
        return matvec
    if diag.device.type != "cuda":
        raise ValueError(f"stencil7 runs on CUDA or CPU, not {diag.device}")
    nlay, nrow, ncol = _check(shape, diag, off)
    lib = _load()
    fn = lib.stencil7_f64 if diag.dtype == torch.float64 else lib.stencil7_f32
    device, dtype, n = diag.device, diag.dtype, diag.numel()
    diag_ptr, off_ptr = diag.data_ptr(), off.data_ptr()

    def matvec(x):
        if (x.device != device or x.dtype != dtype or x.shape != (n,)
                or not x.is_contiguous()):
            raise ValueError(f"x ({x.dtype}{tuple(x.shape)} on {x.device}) "
                             f"does not match the bound {dtype}[{n}] system "
                             f"on {device}, or is not contiguous")
        y = torch.empty_like(x)
        err = fn(diag_ptr, off_ptr, x.data_ptr(), y.data_ptr(), nlay, nrow,
                 ncol, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError("stencil7 launch failed: "
                               + lib.stencil7_error_string(err).decode())
        launches["stencil7"] += 1
        return y

    # the bound system, which marks the product for krylov.cg's fused
    # path; it holds diag and off, so their memory outlives the pointers
    # bound above
    matvec.stencil7 = ((nlay, nrow, ncol), diag, off)
    return matvec


def stencil7(shape, diag, off, x):
    """y = A x in one call (see ``bind_stencil7``); every kernel launch of
    either is counted as ``utils.profiler.launches["stencil7"]``."""
    return bind_stencil7(shape, diag, off)(x)

