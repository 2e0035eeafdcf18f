"""Camera component and per-frame common constants.

Port of `garden_tpu.systems.camera`: the CAMERA component (perspective or
orthographic projection parameters) and its system, `view_matrix` (a
world-space pose to its view matrix) and `common_constants`, the
view/projection matrices and friends each frame's passes read. Projection
is reverse-Z.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.core.ecs import ComponentDef, Field, System

Tensor = torch.Tensor

PROJ_PERSPECTIVE = 0
PROJ_ORTHOGRAPHIC = 1

CAMERA = ComponentDef(
    "camera",
    {
        # perspective params
        "fov_y": Field((), np.float32, 0.9),
        "aspect": Field((), np.float32, 16.0 / 9.0),
        "near": Field((), np.float32, 0.1),
        # orthographic params
        "ortho_extents": Field((6,), np.float32, (-1, 1, -1, 1, -1, 1)),
        "proj_type": Field((), np.int32, PROJ_PERSPECTIVE),
    },
)


def view_matrix(position: Tensor, rotation: Tensor) -> Tensor:
    """World-space camera pose -> view matrix (inverse rigid transform)."""
    r = m3.quat_to_mat3(rotation)
    rt = torch.swapaxes(r, -1, -2)
    t = -torch.einsum("...ij,...j->...i", rt, position)
    top = torch.cat([rt, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


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


class CameraSystem(System):
    component = CAMERA
