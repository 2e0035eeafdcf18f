"""Build, load and launch the port's hand-written CUDA kernels.

This module is the port's one door to the C side. `KERNELS` names each
kernel's source and the argument types of its `extern "C" int
<kernel>_launch(...)` entry point. Each source `csrc/<name>.cu` has a plain
C interface. On first use, `load(name)` compiles it with nvcc for Hopper
(`sm_90a`) into `_build/` beside this file, loads the shared library with
ctypes and declares its entry points' signatures. The library file name
carries a hash of the source, the headers beside it and the flags, so an
edited kernel is rebuilt. A failed build raises; nothing falls back.

`launch(kernel, dev, *args)` runs an entry point on `dev`'s current stream
and counts it in `launches`. `on_device` picks a wrapper's path by its
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
launches or raises; given a counter, it charges the call to the open span.
`check`, `check_kept`, `check_rays`, `ptr` and `kept_ptr` are the wrappers'
checks and pointer arguments; `f32` and `recip` round their Python numbers
as PyTorch's float32 ops do.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from garden_tpu_torch.utils import profiler

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# -fmad=false: the kernels must round like the plain PyTorch versions, which
# run every multiply and add as its own op; a contracted FMA moves edge
# values by an ulp and flips pixels on triangle edges.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel -> (source in csrc/, argument types of <kernel>_launch before its
# trailing stream pointer); every pointer is passed as a void pointer
KERNELS = {
    "raster_shade": ("raster_shade", (_P,) * 5 + (_I,) * 10 + (_P,) * 6),
    "visibility": ("raster_shade", (_P,) * 4 + (_I,) * 9 + (_P,) * 5),
    "sorted_blend": ("blend_raster", (_P,) * 6 + (_I,) * 9 + (_P, _I, _P, _P, _I)),
    "oit": ("blend_raster", (_P,) * 4 + (_I,) * 7 + (_P,) * 3 + (_I,)),
    "depth_super": ("depth_raster", (_P,) * 3 + (_I,) * 8 + (_P, _I, _P, _P, _I)),
    "depth_grid": ("depth_raster", (_P,) * 5 + (_I,) * 5 + (_P, _I, _P, _P, _I)),
    "depth_dense": ("depth_raster", (_P,) * 5 + (_I,) * 6 + (_P, _I, _P, _P, _I)),
    "cloud_march": ("clouds", (_P,) * 3 + (_I,) + (_F,) * 7 + (_I,) * 2 + (_P,) * 3),
    "cloud_shadow": ("clouds", (_P,) * 3 + (_I,) + (_F,) * 2 + (_I, _P)),
    "sky_radiance": ("atmosphere", (_P,) * 2 + (_I,) + (_F,) * 7 + (_I, _P)),
    "aerial_perspective": ("atmosphere", (_P,) * 3 + (_I,) + (_F,) * 2 + (_I,) + (_P,) * 2),
    "cast_sphere": ("queries", (_P,) * 4 + (_I,) + (_P,) * 2 + (_I,) + (_P,) * 4 + (_I,) * 3
                    + (_P,) + (_I,) * 2 + (_P,) * 4 + (_I,) * 2 + (_P,) * 3 + (_I,) * 5
                    + (_P,) * 5 + (_I,) * 2 + (_P,) * 6),
    "composite_sprites": ("sprites", (_P,) * 5 + (_I,) * 4 + (_F,) + (_P,) * 2),
}
SOURCES = sorted({source for source, _ in KERNELS.values()})
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)   # successful launches a kernel

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, found as torch.utils.cpp_extension finds it."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    # the headers in csrc/ count too: a source may include any of them
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    return build_all([name], verbose)[name]


def build_all(names, verbose: bool = False) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all running at once; -> {name: library path}. With `verbose`,
    print ptxas's register, shared-memory and spill report of each."""
    out = {name: library_path(name) for name in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        if verbose:
            print(err, end="")
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use, with the
    signatures of its entry points in `KERNELS` declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for kernel, (source, argtypes) in KERNELS.items():
                if source == name:
                    fn = getattr(lib, f"{kernel}_launch")
                    fn.restype = ctypes.c_int
                    fn.argtypes = [*argtypes, ctypes.c_void_p]
            _libs[name] = lib
        return lib


def launch(kernel: str, dev: torch.device, *args) -> None:
    """Launch `<kernel>_launch(*args, stream)` on card `dev`, on its current
    stream, and count it in `launches`. The launch runs under `dev`'s device
    guard, so the kernel (and the shared-memory limit the C entry point
    sets for it) goes to the card that holds the tensors, whatever the
    current device."""
    fn = getattr(load(KERNELS[kernel][0]), f"{kernel}_launch")
    with torch.cuda.device(dev):
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    with _lock:
        launches[kernel] += 1


def on_device(name: str, x: torch.Tensor, cuda_fn, plain_fn, counter: str = None):
    """The path of wrapper `name` for `x`'s device: `cuda_fn` on a card,
    `plain_fn` on the CPU; any other device raises. With `counter`, while
    a profiler records, the call charges the open span with
    `<counter>_calls` 1 and `<counter>_kernel_calls` 1 when it takes the
    kernel (0 on the CPU)."""
    if x.device.type == "cuda":
        fn = cuda_fn
    elif x.device.type == "cpu":
        fn = plain_fn
    else:
        raise ValueError(f"{name}: no path for device {x.device}")
    if counter is not None and profiler.recording():
        profiler.count(f"{counter}_calls", 1)
        profiler.count(f"{counter}_kernel_calls", int(fn is cuda_fn))
    return fn


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device,
          kernel: str) -> None:
    """Raise unless argument `name` of `kernel` is a contiguous `dtype`
    tensor of `shape` on `device`."""
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def check_kept(kept: torch.Tensor, n_rows: int, dev, kernel: str) -> None:
    """`check` of an optional (n_rows,) int32 `kept` output."""
    if kept is not None:
        check("kept", kept, torch.int32, (n_rows,), dev, kernel)


def check_rays(x: torch.Tensor, name: str, kernel: str):
    """(leading shape, count) of argument `name` of `kernel`, a contiguous
    (..., 3) float32 tensor on a card; raises otherwise, and past the
    count the kernels index."""
    shape = tuple(x.shape[:-1])
    check(name, x, torch.float32, (*shape, 3), x.device, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {x.device}")
    n = math.prod(shape)
    if 3 * n >= 2 ** 31:
        raise ValueError(f"{kernel}: {n} rays are more than the kernel indexes")
    return shape, n


def f32(x: float) -> float:
    """A Python number as a float32 op sees it."""
    return float(np.float32(x))


def recip(x: float) -> float:
    """PyTorch's reciprocal of a Python divisor on the card: a tensor
    divided by a Python number is multiplied by float32(1) / float32(x)."""
    return float(np.float32(1.0) / np.float32(x))


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def kept_ptr(kept: torch.Tensor) -> ctypes.c_void_p:
    """A pointer to an optional output; null for None."""
    return ctypes.c_void_p(None if kept is None else kept.data_ptr())
