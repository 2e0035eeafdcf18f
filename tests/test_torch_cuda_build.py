"""The table of the hand kernels' C entry points (`cuda_build.KERNELS`) on
the CPU.

Each entry names a source and the ctypes argument types of its
`extern "C" int <kernel>_launch(...)`; `load` declares them on the library.
A list that disagrees with the C prototype passes the wrong bytes to the
kernel, which shows only on a card. Here each prototype is parsed from
`csrc/<source>.cu` and held to its entry, parameter by parameter, the
stream pointer last.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import ctypes
import re
from types import SimpleNamespace

import pytest
import torch

from garden_tpu_torch import cuda_build

# the C parameter types the entry points use, and the ctypes type each takes
C_KINDS = {"int": ctypes.c_int, "float": ctypes.c_float}
POINTEES = {"float", "int", "unsigned long long", "void"}


def _prototype(kernel: str, source: str) -> list:
    """The parameter types of `<kernel>_launch` in csrc/<source>.cu, `const`
    and the names dropped: ["float*", "int", ...]."""
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern\s+"C"\s+int\s+' + kernel + r"_launch\s*\(([^)]*)\)", text)
    assert m, f"no extern \"C\" int {kernel}_launch in {source}.cu"
    types = []
    for param in m.group(1).split(","):
        words = re.sub(r"\bconst\b", "", param).replace("*", " * ").split()
        types.append(" ".join(words[:-1]).replace(" *", "*"))
    return types


def _ctype(c_type: str):
    if c_type.endswith("*"):
        assert c_type[:-1] in POINTEES, c_type
        return ctypes.c_void_p
    assert c_type in C_KINDS, c_type
    return C_KINDS[c_type]


@pytest.mark.parametrize("kernel", list(cuda_build.KERNELS))
def test_argtypes_match_the_c_prototype(kernel):
    source, argtypes = cuda_build.KERNELS[kernel]
    c_types = _prototype(kernel, source)
    assert c_types[-1] == "void*", f"{kernel}_launch does not end with the stream"
    assert [_ctype(t) for t in c_types] == [*argtypes, ctypes.c_void_p]


def test_sources_are_every_csrc_file_and_launches_every_kernel():
    assert cuda_build.SOURCES == sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    assert set(cuda_build.launches) == set(cuda_build.KERNELS)


def test_load_declares_every_entry_point_of_its_source(monkeypatch):
    """`load` sets restype and argtypes once on each entry point of the
    loaded source, and on no other."""
    libs = []

    def fake_cdll(path):
        libs.append(SimpleNamespace(**{f"{k}_launch": SimpleNamespace()
                                       for k in cuda_build.KERNELS}))
        return libs[-1]
    monkeypatch.setattr(cuda_build, "build", lambda name: name)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(cuda_build, "_libs", {})
    lib = cuda_build.load("depth_raster")
    assert cuda_build.load("depth_raster") is lib and len(libs) == 1
    for kernel, (source, argtypes) in cuda_build.KERNELS.items():
        fn = getattr(lib, f"{kernel}_launch")
        if source == "depth_raster":
            assert fn.restype is ctypes.c_int
            assert fn.argtypes == [*argtypes, ctypes.c_void_p]
        else:
            assert not hasattr(fn, "argtypes")


def test_on_device_takes_the_plain_version_on_the_cpu():
    cuda_fn, plain_fn = object(), object()
    assert cuda_build.on_device("k", torch.zeros(1), cuda_fn, plain_fn) is plain_fn
    with pytest.raises(ValueError, match="k: no path for device meta"):
        cuda_build.on_device("k", torch.zeros(1, device="meta"), cuda_fn, plain_fn)
