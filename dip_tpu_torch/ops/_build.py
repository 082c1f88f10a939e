"""Build the package's CUDA sources at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`) by an `nvcc` of
its own, all started together, and the objects are linked into one shared
library with a plain C interface, under `build/kernels/` at the root of the
checkout. The library's name carries a hash of the sources and flags, so
an edit never loads a stale binary. Nothing here runs at import
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
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _build(so: Path) -> str:
    """Compile each source to an object, one nvcc per source, all running
    at once, then link the objects into `so`. Returns nvcc's output;
    raises, with that output, if a compile or the link fails."""
    nvcc = _nvcc()
    work = so.with_suffix(f".{os.getpid()}.d")
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in _sources():
            obj = work / f"{src.stem}.o"
            jobs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, proc in jobs:
            out, _ = proc.communicate(timeout=900)
            logs.append(f"# {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True, timeout=300)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, so)
        return log
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernel library, compiled on the first call of the process."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.is_file():
        build_log = _build(so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # xp, e, carry, out, fits, n, h, w, c, f, f32, stream
    lib.dip_up_conv_fwd.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 7 + [ptr]
    # dzq, e, workspace, dxp, fits, n, h, w, c, f, splits, steps a split, f32,
    # stream
    lib.dip_up_conv_dgrad.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr]
    # xp, dzq, workspace, de, fits, n, h, w, c, f, splits, tiles a split, f32,
    # stream
    lib.dip_up_conv_wgrad.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr]
    # x, g, workspace, dW, n, h, w, ci, co, splits, tiles a split, f32, stream
    lib.dip_wgrad3x3_mma.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 8 + [ptr]
    lib.dip_wgrad1x1_mma.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 8 + [ptr]
    # the same with a fit axis: x, g, workspace, dW, fits, n, h, w, ci, co,
    # splits, tiles a split, f32, stream
    lib.dip_wgrad3x3_mma_fits.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr]
    lib.dip_wgrad1x1_mma_fits.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr]
    # x, taps, out, n, h, w, c, h_out, w_out, factor, K, row pad, column pad,
    # tile_h, tile_w, channels a block, stream
    lib.dip_downsample.argtypes = [ptr, ptr, ptr] + [i32] * 13 + [ptr]
    # x, out, n, h/2, w/2, c, x's 4 strides, in f32, out f32, stream
    lib.dip_s2d_pack.argtypes = [ptr, ptr] + [i32] * 4 + [i64] * 4 + [i32] * 2 + [ptr]
    # x, g, workspace, dW, fits, n, h, w, hx, wx, ci, co, x's and g's 4
    # strides, ks, halo, splits, tiles a split, slab row pitch, stream
    lib.dip_wgrad_f32_fits.argtypes = [ptr] * 4 + [i32] * 8 + [i64] * 8 + [i32] * 5 + [ptr]
    for fn in (lib.dip_up_conv_fwd, lib.dip_up_conv_dgrad, lib.dip_up_conv_wgrad,
               lib.dip_wgrad3x3_mma, lib.dip_wgrad1x1_mma, lib.dip_wgrad3x3_mma_fits,
               lib.dip_wgrad1x1_mma_fits, lib.dip_downsample,
               lib.dip_s2d_pack, lib.dip_wgrad_f32_fits):
        fn.restype = i32
    _lib = lib
    return lib


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def on_cpu(**tensors) -> bool:
    """True if every tensor lies on the CPU (the caller then runs its plain
    version), False if all lie on one CUDA device (it launches its kernel);
    raises on any other mix of devices."""
    devs = {t.device for t in tensors.values()}
    if len(devs) == 1 and next(iter(devs)).type in ("cpu", "cuda"):
        return next(iter(devs)).type == "cpu"
    raise ValueError(f"kernels need all tensors on one CUDA device (or all on the CPU): "
                     f"{ {k: str(t.device) for k, t in tensors.items()} }")


def raise_on(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
