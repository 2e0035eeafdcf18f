"""Deferred renderer: the pass schedule of one frame.

Port of `garden_tpu.render.deferred.DeferredRenderer`: triangle transform
and frustum cull, the main-view raster with the fused G-buffer kernel, the
G-buffer, cascaded shadows (the atlas depth raster and the resolve),
half-res HBAO, the atmosphere's sky, SH ambient and specular ambient, the
lighting resolve, aerial perspective, bloom, auto exposure, tone mapping
and FXAA. A config or scene that needs any other pass raises
NotImplementedError naming the ROADMAP item that ports it; nothing is
skipped silently.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.ops.blur import decimate2x, upsample2x_to
from garden_tpu_torch.render import (atmosphere, bloom, csm, fxaa, gbuffer, hbao,
                                     lighting, mesh, raster, tonemap)

Tensor = torch.Tensor

# (config flag, the ROADMAP Queue 1 item that ports its pass)
_UNPORTED_FLAGS = (
    ("use_ssr", "item 13 (SSR)"),
    ("use_ssgi", "item 13 (SSGI)"),
    ("use_clouds", "item 13 (clouds)"),
    ("use_velocity", "item 13 (velocity and disocclusion)"),
    ("use_occlusion_culling", "item 13 (Hi-Z)"),
)

SHADOW_NEAR = 0.1   # the camera near plane the cascades are fitted with


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
    if config.use_fxaa and config.aa_mode == "smaa":
        raise NotImplementedError(
            "aa_mode='smaa' is not ported yet (ROADMAP Queue 1 item 13)")
    if config.use_shadows:
        csm.atlas_tiling(config.shadow)
    if (scene.tri_translucent_mask().any() or scene.tri_sorted_mask().any()
            or scene.tri_refract_mask().any()):
        raise NotImplementedError(
            "translucent, sorted or refractive content needs the OIT, sorted, "
            "refraction passes and the translucent shadow map, not ported yet "
            "(ROADMAP Queue 1 item 13)")


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
                      constants: Dict[str, Tensor],
                      planes: Tuple[tuple, tuple] = None) -> Dict[str, Any]:
        """Everything up to the fused raster: transformed, set-up, binned
        triangles and their shading records, as the keyword arguments of
        raster.rasterize_visibility_shaded. `planes` are the world corner
        planes of mesh.transform_triangle_planes, when already computed."""
        cfg = self.config
        w, h = cfg.width, cfg.height
        pos_pl, nrm_pl = planes or mesh.transform_triangle_planes(scene, inst_matrices)
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

    def shadow_light(self, constants: Dict[str, Tensor]):
        """(light, splits): the cascades' shared light view and crops
        (csm.fit_cascades) and their view-space split depths."""
        splits = csm.cascade_splits(self.config.shadow, SHADOW_NEAR)
        light = csm.fit_cascades(constants["inv_view_proj"], constants["light_dir"],
                                 SHADOW_NEAR, splits, SHADOW_NEAR)
        return light, splits

    def cascade_inputs(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                       constants: Dict[str, Tensor]) -> Dict[str, Any]:
        """The keyword arguments of raster.rasterize_depth for this frame's
        cascade atlas. Casters are every valid triangle of the scene, not
        only those in the camera's frustum."""
        pos_pl, _ = mesh.transform_triangle_planes(scene, inst_matrices)
        light, _ = self.shadow_light(constants)
        return csm.cascade_raster_inputs(pos_pl, scene["tri_valid"], light,
                                         self.config.shadow)

    # The frame's stages, in order; `render` composes them, and each is a
    # method of its own so that tools can time or inspect it.

    def gbuffer_pass(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                     constants: Dict[str, Tensor]):
        """Transform, cull, set up, bin, the fused raster (kernel K1) and
        the G-buffer -> (world corner planes, vis, G-buffer dict)."""
        planes = mesh.transform_triangle_planes(scene, inst_matrices)
        vis, gplanes = raster.rasterize_visibility_shaded(
            **self.raster_inputs(scene, inst_matrices, constants, planes))
        return planes, vis, gbuffer.shade_gbuffer(vis, gplanes, constants=constants)

    def shadow_atlas(self, scene: Dict[str, Tensor], pos_planes, light) -> Tensor:
        """The cascade atlas's reverse-Z depth (kernels K2 + K3, or K4)."""
        return csm.render_cascades(pos_planes, scene["tri_valid"], light,
                                   self.config.shadow)

    def shadow_factor(self, g: Dict[str, Tensor], constants: Dict[str, Tensor],
                      atlas: Tensor, light, splits) -> Tensor:
        """The resolved shadow factor (H, W, 1); 1 where nothing was drawn."""
        view_depth = m3.length(g["position"] - constants["camera_pos"])
        shadow = csm.resolve_shadow(g["position"], g["normal"], view_depth, atlas,
                                    light, self.config.shadow, splits)
        return torch.where(g["visible"][..., None], shadow, 1.0)

    def ambient_occlusion(self, g: Dict[str, Tensor],
                          constants: Dict[str, Tensor]) -> Tensor:
        return hbao.compute_hbao(g["position"], g["normal"], g["visible"],
                                 constants["camera_pos"], half_res=True)

    def shade(self, g: Dict[str, Tensor], constants: Dict[str, Tensor],
              shadow, ao) -> Tensor:
        """The sky and the lighting resolve -> HDR (H, W, 3) float32."""
        if self.config.use_atmosphere:
            return self._atmosphere_lighting(g, constants, shadow, ao)
        return lighting.resolve(g, constants, shadow=shadow, ao=ao)

    def post(self, hdr: Tensor, constants: Dict[str, Tensor],
             frame_state: Dict[str, Tensor]):
        """Bloom, auto exposure, tone mapping and FXAA -> (uint8 image,
        the post chain's HDR, the adapted average luminance)."""
        cfg = self.config
        if cfg.post_bf16:
            hdr = hdr.to(torch.bfloat16)
        if cfg.use_bloom:
            hdr = bloom.apply_bloom(hdr, cfg.bloom_mip_count)
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
        if cfg.use_fxaa:
            ldr = fxaa.apply_fxaa(ldr)
        return tonemap.to_uint8(ldr), hdr, avg_lum

    def render(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
               constants: Dict[str, Tensor], frame_state: Dict[str, Tensor]
               ) -> Dict[str, Any]:
        cfg = self.config
        with record_function("raster"):
            planes, vis, g = self.gbuffer_pass(scene, inst_matrices, constants)
        shadow = None
        if cfg.use_shadows:
            with record_function("csm_render"):
                light, splits = self.shadow_light(constants)
                atlas = self.shadow_atlas(scene, planes[0], light)
            with record_function("csm_resolve"):
                shadow = self.shadow_factor(g, constants, atlas, light, splits)
        ao = None
        if cfg.use_hbao:
            with record_function("hbao"):
                ao = self.ambient_occlusion(g, constants)
        with record_function("sky_lighting"):
            hdr = self.shade(g, constants, shadow, ao)
        with record_function("post"):
            image, hdr, avg_lum = self.post(hdr, constants, frame_state)
        return {
            "image": image,
            "hdr": hdr,
            "depth": vis["depth"],
            "tri_id": vis["tri_id"],
            "gbuffer": g,
            "shadow": shadow,
            "ao": ao,
            "frame_state": {"avg_luminance": avg_lum},
        }

    def _atmosphere_lighting(self, g: Dict[str, Tensor],
                             constants: Dict[str, Tensor], shadow, ao) -> Tensor:
        """Lighting under the atmosphere: the sky raymarched at half res and
        tent-upsampled, SH ambient, a specular ambient that blends the sharp
        sky in the reflection direction with the SH irradiance by
        roughness (also at half res), then aerial perspective."""
        cfg = self.config
        w, h = cfg.width, cfg.height
        to_light = -constants["light_dir"]
        rays = lighting.view_rays(g, constants)
        sky = upsample2x_to(atmosphere.sky_radiance(decimate2x(rays), to_light), h, w)
        sh = atmosphere.sky_sh(to_light)
        view = m3.normalize(constants["camera_pos"] - g["position"])
        refl_h = decimate2x(m3.reflect(-view.expand(g["normal"].shape), g["normal"]))
        spec_sharp = atmosphere.sky_radiance(refl_h, to_light, steps=4)
        spec_rough = atmosphere.sh_irradiance(refl_h, sh)
        r_h = torch.clamp(decimate2x(g["roughness"]), 0.0, 1.0)[..., None]
        spec_amb = upsample2x_to(spec_sharp * (1.0 - r_h) + spec_rough * r_h, h, w)
        hdr = lighting.resolve(g, constants, shadow=shadow, ao=ao, ambient_sh=sh,
                               sky=sky, specular_ambient=spec_amb)
        if cfg.use_aerial_perspective:
            vd_km = m3.length(g["position"] - constants["camera_pos"]) \
                * cfg.aerial_km_per_unit
            trans, inscatter = atmosphere.aerial_perspective(vd_km, rays, to_light)
            hdr = torch.where(g["visible"][..., None], hdr * trans + inscatter, hdr)
        return hdr
