"""State checkpointing, the kernels' build cache and NaN/Inf guards.

Port of `garden_tpu.utils.checkpoint`:

- `save`/`load`: the full engine state tree as an .npz snapshot (bitwise
  resume, physics warm-start impulses included) with a `.npz.tree` file of
  per-leaf key paths. The format is the reference's: leaves in JAX's
  pytree order (dicts by sorted key, lists and tuples by position, None
  holds no leaf), named `leaf_<i>`, and key paths as `jax.tree_util.keystr`
  writes them (`['components']['transform']['position']`), so a checkpoint
  written by either package loads in the other.
- `enable_compilation_cache(dir)`: where the hand-written kernels are built
  and looked up (`cuda_build.BUILD_DIR`), the port's persistent cache of
  compiled artifacts.
- `debug_guards(True)`: the Engine's step raises FloatingPointError after
  an event that leaves a NaN or Inf in a float leaf (the contract of
  `jax_debug_nans` / `jax_debug_infs`). Off, the guards read nothing back.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, List, Tuple

import numpy as np
import torch

_guards = {"on": False}


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in JAX's pytree order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _rebuild(like: Any, it) -> Any:
    """`like`'s structure with its leaves replaced, in order, from `it`."""
    if isinstance(like, dict):
        # fill in sorted order (the leaf order), keep like's key order
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_rebuild(v, it) for v in like]
        return type(like)(vals) if type(like) in (list, tuple) else type(like)(*vals)
    if like is None:
        return None
    return next(it)


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, state: Any) -> None:
    """Snapshot a state tree to .npz (+ structure file with per-leaf key
    paths, validated at load)."""
    leaves = _leaves(state)
    flat = {f"leaf_{i}": _host(x) for i, (_, x) in enumerate(leaves)}
    keys = [k for k, _ in leaves]
    base = path[:-4] if path.endswith(".npz") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    np.savez_compressed(base + ".npz", **flat)
    with open(base + ".npz.tree", "w", encoding="utf-8") as f:
        f.write("\n".join([str(len(keys))] + keys))


def load(path: str, like: Any) -> Any:
    """Restore a snapshot; `like` provides the tree structure, which is
    validated leaf-by-leaf against the persisted key paths so a structurally
    different `like` errors instead of silently mis-mapping arrays. Each
    leaf lands on the device of `like`'s leaf; a leaf whose dtype or shape
    differs from `like`'s raises."""
    base = path[:-4] if path.endswith(".npz") else path
    leaves = _leaves(like)
    keys = [k for k, _ in leaves]
    try:
        with open(base + ".npz.tree", "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        saved_n, saved_keys = int(lines[0]), lines[1:]
    except (OSError, ValueError, IndexError):
        saved_n, saved_keys = len(keys), None  # legacy sidecar: count only
    if saved_n != len(keys):
        raise ValueError(
            f"checkpoint has {saved_n} leaves but `like` has {len(keys)}")
    if saved_keys is not None and saved_keys != keys:
        diff = next((i, a, b) for i, (a, b)
                    in enumerate(zip(saved_keys, keys)) if a != b)
        raise ValueError(
            f"checkpoint structure mismatch at leaf {diff[0]}: "
            f"saved {diff[1]!r} vs requested {diff[2]!r}")
    with np.load(base + ".npz") as data:
        restored = []
        for i, (_, ref) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                t = torch.from_numpy(arr)
                if t.dtype != ref.dtype or t.shape != ref.shape:
                    raise ValueError(
                        f"checkpoint leaf {keys[i]} is {t.dtype}{tuple(t.shape)} "
                        f"but `like` has {ref.dtype}{tuple(ref.shape)}")
                restored.append(t.to(ref.device, copy=True))
            else:
                restored.append(arr)
    return _rebuild(like, iter(restored))


def enable_compilation_cache(cache_dir: str = ".torch_kernel_cache") -> None:
    """Build and look up the hand-written kernels' libraries in `cache_dir`:
    a library built once is loaded from there by any later process."""
    from garden_tpu_torch import cuda_build
    cuda_build.BUILD_DIR = Path(cache_dir).resolve()


def debug_guards(enable: bool = True) -> None:
    """NaN/Inf guards on the Engine's step (see the module docstring)."""
    _guards["on"] = bool(enable)


def guards_enabled() -> bool:
    return _guards["on"]


def check_finite(state: Any, where: str) -> None:
    """Raise FloatingPointError if a float leaf of `state` holds a NaN or an
    Inf, naming the first such leaf. One read from the device for all."""
    floats = [(k, x) for k, x in _leaves(state)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not floats:
        return
    bad = torch.stack([~torch.isfinite(x).all() for _, x in floats]).cpu()
    if bool(bad.any()):
        key = floats[int(torch.nonzero(bad)[0, 0])][0]
        raise FloatingPointError(f"NaN or Inf in {key} {where}")
