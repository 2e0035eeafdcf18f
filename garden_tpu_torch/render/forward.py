"""Forward renderer: colour and depth without the deferred machinery.

Port of `garden_tpu.render.forward.ForwardRenderer`: the vertex pool to
world space (`mesh.transform_vertices`), one visibility pass
(`raster.render_pass`: slot binning on square tiles, kernel K5 on a CUDA
tensor), the G-buffer from the winners' shading records, the lighting
resolve with its analytic sky, and tone mapping. No shadows, AO or post.
"""

from __future__ import annotations

from typing import Dict

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.render import gbuffer, lighting, mesh, raster, tonemap
from garden_tpu_torch.utils import profiler

Tensor = torch.Tensor


class ForwardRenderer:
    """Owns the host scene and the config; `render` is a function of the
    device scene, instance matrices and constants."""

    def __init__(self, config: RenderConfig, scene: mesh.SceneBuffers, device,
                 use_hdr: bool = False):
        self.config = config
        self.scene_host = scene
        self.device = torch.device(device)
        self.use_hdr = use_hdr

    def device_scene(self) -> Dict[str, Tensor]:
        return self.scene_host.device_arrays(self.device)

    def render(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
               constants: Dict[str, Tensor], exposure: float = 1.0
               ) -> Dict[str, Tensor]:
        """One frame at the config's size -> {"image" (H, W, 3) uint8,
        "depth", "tri_id"}, and "hdr" with use_hdr."""
        cfg = self.config
        w, h = cfg.width, cfg.height
        with profiler.span("raster"):
            world_pos, world_nrm = mesh.transform_vertices(scene, inst_matrices)
            clip = m3.apply_mat4_h(constants["view_proj"], world_pos)
            vis, setup = raster.render_pass(clip, scene["indices"], scene["tri_valid"],
                                            w, h, cfg.tile_size, cfg.max_tris_per_tile)
        with profiler.span("gbuffer"):
            g = gbuffer.shade_gbuffer(vis, setup, scene, world_pos, world_nrm,
                                      constants=constants)
        with profiler.span("lighting"):
            hdr = lighting.resolve(g, constants)
        ldr = tonemap.tone_map(hdr, torch.tensor(exposure, device=hdr.device))
        out = {"image": tonemap.to_uint8(ldr), "depth": vis["depth"],
               "tri_id": vis["tri_id"]}
        if self.use_hdr:
            out["hdr"] = hdr
        return out
