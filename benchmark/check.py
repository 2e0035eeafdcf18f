"""The numbers that decide `correct`, and their limits.

Each number is the widest gap, over the compared steps (and worlds),
between what the program produced and what the reference computes from
the same input. A workload's limits are `benchmark/limits/<workload>.json`:
{number: limit}; a number the cell does not produce is not judged.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

BODY_LEAVES = {"pos_m": "pos", "quat": "quat", "linvel_mps": "linvel",
               "angvel_radps": "angvel"}


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a.double() - b.double().to(a.device))))


def physics_gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """Widest gaps of the bodies' poses and velocities, and of the clock."""
    out = {k: _max_abs(prog["bodies"][leaf], ref["bodies"][leaf])
           for k, leaf in BODY_LEAVES.items()}
    out["time_s"] = _max_abs(prog["time"], ref["time"])
    return out


def image_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest per-channel gap between two images, in 8-bit levels."""
    return _max_abs(prog.float(), ref.float())


def leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def differing_leaves(prog: Any, ref: Any) -> int:
    """How many leaves of two state trees differ in key, shape, type or any
    bit; 0 where they are the same."""
    a, b = dict(leaves(prog)), dict(leaves(ref))
    bad = len(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            same = (x.shape == y.shape and x.dtype == y.dtype
                    and torch.equal(x.cpu(), y.cpu()))
        else:
            same = x == y
        bad += not same
    return bad


def widest(acc: Dict[str, float], new: Dict[str, float]) -> Dict[str, float]:
    """acc with each number raised to new's where new's is wider."""
    for k, v in new.items():
        acc[k] = max(acc.get(k, v), v)
    return acc


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(every number within its limit, {name: {value, limit}}) over the
    numbers that have a limit; a number without one fails."""
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(d["limit"] is not None and d["value"] <= d["limit"] for d in out.values())
    return ok and bool(out), out
