"""What the entries share: the program's configuration against the file's,
and the reference run in the precision the check asks for."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from benchmark.reference.physics import world as ref_world


def require_physics_config(pcfg, cfg: Dict[str, Any]) -> None:
    """Raise unless the program's PhysicsConfig holds the file's numbers."""
    have = dataclasses.asdict(pcfg)
    want = dict(cfg["physics"], max_bodies=cfg["n_bodies"])
    off = {k: (have.get(k), v) for k, v in want.items() if have.get(k) != v}
    if off:
        raise ValueError(f"the program's physics config departs from the file's: {off}")


@contextlib.contextmanager
def precision(mode: Optional[str]):
    """The reference's precision: float32 with TF32 off (None), or the
    control's TF32 ("tf32"), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bf16_rounded(tree: Any) -> Any:
    """Every float32 leaf rounded through bfloat16 (the "bf16" control's
    input: state kept in bfloat16)."""
    if isinstance(tree, dict):
        return {k: bf16_rounded(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16).float()
    return tree


def ref_physics_step(state: Dict[str, Any], pcfg, types, mode: Optional[str] = None):
    """One reference physics step in the precision `mode` names."""
    if mode == "bf16":
        state = bf16_rounded(state)
    with precision(mode):
        return ref_world.step(state, pcfg, 1.0 / 60.0, types)
