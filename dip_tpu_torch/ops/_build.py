"""Build the package's CUDA sources at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface, under `build/kernels/` at the
root of the checkout. The library's name carries a hash of the sources and
flags, so an edit never loads a stale binary. Nothing here runs at import
time, and nothing falls back: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output of this process's build (ptxas lines)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH); "
                           "the Hopper kernels cannot be built")
    return found


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdip_kernels_{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The kernel library, compiled on the first call of the process."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dip_up_conv_fwd.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 6 + [ptr]
    lib.dip_up_conv_dgrad.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr]
    lib.dip_up_conv_wgrad.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 8 + [ptr]
    lib.dip_up_conv_wgrad_tiles.argtypes = [ctypes.POINTER(i32)] * 3
    lib.dip_downsample.argtypes = [ptr, ptr, ptr] + [i32] * 11 + [ptr]
    for fn in (lib.dip_up_conv_fwd, lib.dip_up_conv_dgrad, lib.dip_up_conv_wgrad,
               lib.dip_up_conv_wgrad_tiles, lib.dip_downsample):
        fn.restype = i32
    _lib = lib
    return lib


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
