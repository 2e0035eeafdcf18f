"""Deferred renderer: the pass schedule of one frame.

Port of `garden_tpu.render.deferred.DeferredRenderer` for the pass set the
port has today: triangle transform and frustum cull, the main-view raster
with the fused G-buffer kernel, G-buffer assembly, the lighting resolve
without atmosphere, auto exposure and tone mapping. A config or scene that
needs any other pass raises NotImplementedError naming the ROADMAP item
that ports it; nothing is skipped silently.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.render import gbuffer, lighting, mesh, raster, tonemap

Tensor = torch.Tensor

# (config flag, the ROADMAP Queue 1 item that ports its pass)
_UNPORTED_FLAGS = (
    ("use_shadows", "item 9 (shadows)"),
    ("use_hbao", "item 10 (screen-space effects)"),
    ("use_atmosphere", "item 10 (atmosphere sky and lighting)"),
    ("use_bloom", "item 11 (post-processing)"),
    ("use_fxaa", "item 11 (post-processing)"),
    ("use_ssr", "item 13 (SSR)"),
    ("use_ssgi", "item 13 (SSGI)"),
    ("use_clouds", "item 13 (clouds)"),
    ("use_velocity", "item 13 (velocity and disocclusion)"),
    ("use_occlusion_culling", "item 13 (Hi-Z)"),
)


def check_ported(config: RenderConfig, scene: mesh.SceneBuffers) -> None:
    """Raise NotImplementedError for any pass the port cannot run yet."""
    for flag, item in _UNPORTED_FLAGS:
        if getattr(config, flag):
            raise NotImplementedError(
                f"RenderConfig.{flag}=True: the pass is not ported yet "
                f"(ROADMAP Queue 1 {item})")
    if config.render_scale != 1.0:
        raise NotImplementedError(
            "render_scale != 1 is not ported yet (ROADMAP Queue 1 item 13)")
    if (scene.tri_translucent_mask().any() or scene.tri_sorted_mask().any()
            or scene.tri_refract_mask().any()):
        raise NotImplementedError(
            "translucent, sorted or refractive content needs the OIT, sorted "
            "and refraction passes, not ported yet (ROADMAP Queue 1 item 13)")


class DeferredRenderer:
    """Owns the host scene and the config; `render` is a function of the
    device scene, instance matrices, constants and frame state."""

    def __init__(self, config: RenderConfig, scene: mesh.SceneBuffers, device):
        check_ported(config, scene)
        self.config = config
        self.scene_host = scene
        self.device = torch.device(device)

    def device_scene(self) -> Dict[str, Tensor]:
        return self.scene_host.device_arrays(self.device)

    def initial_frame_state(self) -> Dict[str, Tensor]:
        return {"avg_luminance": torch.tensor(0.18, device=self.device)}

    def cull_instances(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                       constants: Dict[str, Tensor]) -> Tensor:
        """Frustum-cull instance AABBs -> per-triangle validity mask."""
        lo, hi = scene["inst_aabb_min"], scene["inst_aabb_max"]
        corners = torch.stack([
            torch.stack([(hi if (k >> i) & 1 else lo)[:, i] for i in range(3)], -1)
            for k in range(8)], dim=-2)                        # (I, 8, 3)
        wc = (torch.einsum("iab,ikb->ika", inst_matrices[:, :3, :3], corners)
              + inst_matrices[:, None, :3, 3])
        planes = m3.frustum_planes(constants["view_proj"])
        outside = m3.aabb_outside_frustum(planes, torch.amin(wc, dim=1),
                                          torch.amax(wc, dim=1))
        visible = scene["inst_valid"] & ~outside
        ti = scene["tri_instance"]
        vis_t = visible[torch.clamp(ti, min=0).long()] & (ti >= 0)
        return scene["tri_valid"] & vis_t

    def raster_inputs(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                      constants: Dict[str, Tensor]) -> Dict[str, Any]:
        """Everything up to the fused raster: transformed, set-up, binned
        triangles and their shading records, as the keyword arguments of
        raster.rasterize_visibility_shaded."""
        cfg = self.config
        w, h = cfg.width, cfg.height
        pos_pl, nrm_pl = mesh.transform_triangle_planes(scene, inst_matrices)
        tri_valid = self.cull_instances(scene, inst_matrices, constants)
        px, py, pz = pos_pl
        m = constants["view_proj"]
        comps = [m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]
                 for i in range(4)]
        setup = raster.setup_triangles_planes(*comps, tri_valid, w, h)
        # front-to-back binning priority: when a tile overflows, its
        # farthest triangles drop (16 depth buckets over the visible range)
        zt = torch.amax(setup["z"], dim=0)
        zlo = torch.amin(torch.where(setup["valid"], zt, torch.inf))
        zhi = torch.amax(torch.where(setup["valid"], zt, -torch.inf))
        zn = (zt - zlo) / torch.clamp(zhi - zlo, min=1e-12)
        prio = 15 - torch.clamp((zn * 16.0).int(), 0, 15)
        th = cfg.tile_h or cfg.tile_size
        cap_scale = max(th / cfg.tile_size, 0.25)
        cap_main = max(64, int(cfg.max_tris_per_tile * cap_scale) // 16 * 16)
        fy = cfg.foot_y or max(2, min(8, (2 * cfg.tile_size) // th))
        tiles, counts, big = raster.bin_triangles(
            setup, w, h, cfg.tile_size, max(32, cap_main - 32), max_big=32,
            bucket_priority=prio, foot=2, tile_h=th, foot_y=fy)
        nx, ny, nz = nrm_pl
        t_cnt = px.shape[1]
        tri_nrm = torch.stack([nx.T, ny.T, nz.T], dim=-1).reshape(t_cnt, 3, 3)
        records = gbuffer.pack_triangle_records(scene, tri_nrm, setup["inv_w"])
        return dict(setup=setup, shade_records=records, tile_tris=tiles,
                    counts=counts, big_list=big, width=w, height=h,
                    tile=cfg.tile_size, tile_h=th)

    def render(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
               constants: Dict[str, Tensor], frame_state: Dict[str, Tensor]
               ) -> Dict[str, Any]:
        cfg = self.config
        vis, gplanes = raster.rasterize_visibility_shaded(
            **self.raster_inputs(scene, inst_matrices, constants))
        g = gbuffer.shade_gbuffer(vis, gplanes, constants=constants)
        hdr = lighting.resolve(g, constants)
        if cfg.post_bf16:
            hdr = hdr.to(torch.bfloat16)
        if cfg.use_auto_exposure:
            hist = tonemap.luminance_histogram(hdr, cfg.exposure_histogram_bins)
            target = tonemap.average_luminance_from_histogram(hist)
            avg_lum = tonemap.adapt_exposure(frame_state["avg_luminance"], target,
                                             constants["delta_time"])
        else:
            avg_lum = frame_state["avg_luminance"]
        exposure = tonemap.exposure_from_luminance(
            avg_lum, compensation=cfg.exposure_compensation)
        ldr = tonemap.tone_map(hdr, exposure, mode=cfg.tone_mapper)
        return {
            "image": tonemap.to_uint8(ldr),
            "hdr": hdr,
            "depth": vis["depth"],
            "tri_id": vis["tri_id"],
            "gbuffer": g,
            "frame_state": {"avg_luminance": avg_lum},
        }
