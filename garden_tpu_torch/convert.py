"""Convert the reference's state trees into the port's tensors.

`from_jax` takes a nested dict of numpy arrays, as `jax.device_get` returns
for the JAX package's state (the physics `device_state`, the renderer's
`device_scene`, the frame state, the constants), and returns the same tree
of tensors on `device`. It needs no JAX itself; with it both packages can
compute on identical inputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_jax(tree: Any, device) -> Any:
    """Nested dicts of numpy arrays (or scalars) -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":        # ml_dtypes bfloat16 from JAX
        return torch.as_tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(arr), device=device)   # a writable copy
