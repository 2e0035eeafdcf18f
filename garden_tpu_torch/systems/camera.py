"""Per-frame common constants (view/projection matrices and friends).

Port of `garden_tpu.systems.camera.common_constants`. The rest of the
reference module depends on the ECS, which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from garden_tpu_torch.core import math3d as m3

Tensor = torch.Tensor


def common_constants(camera_position: Tensor, view: Tensor, projection: Tensor,
                     light_dir: Tensor, frame_size: tuple, time: float,
                     delta_time: float,
                     prev_view_proj: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """The CommonConstants dict; every tensor lives on `view`'s device."""
    dev = view.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    view_proj = m3.matmul(projection, view)
    inv_view = m3.mat4_inverse(view)
    inv_proj = m3.mat4_inverse(projection)
    return {
        "view": view,
        "projection": projection,
        "view_proj": view_proj,
        "inv_view": inv_view,
        "inv_proj": inv_proj,
        "inv_view_proj": m3.matmul(inv_view, inv_proj),
        "prev_view_proj": view_proj if prev_view_proj is None else prev_view_proj,
        "camera_pos": camera_position,
        "light_dir": m3.normalize(light_dir),
        "frame_size": f32(frame_size),
        "inv_frame_size": 1.0 / f32(frame_size),
        "time": f32(time),
        "delta_time": f32(delta_time),
    }
