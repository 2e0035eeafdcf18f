"""Build and load the port's hand-written CUDA kernels.

Each kernel lives in `csrc/<name>.cu` with a plain C interface. On first
use, `load(name)` compiles it with nvcc for Hopper (`sm_90a`) into
`_build/` beside this file and loads the shared library with ctypes. The
library file name carries a hash of the source, the headers beside it and
the flags, so an edited kernel is rebuilt. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# -fmad=false: the kernels must round like the plain PyTorch versions, which
# run every multiply and add as its own op; a contracted FMA moves edge
# values by an ulp and flips pixels on triangle edges.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

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
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
