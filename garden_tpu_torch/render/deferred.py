"""Deferred renderer: the pass schedule of one frame.

Port of `garden_tpu.render.deferred.DeferredRenderer`: triangle transform,
frustum cull and Hi-Z occlusion cull against the previous frame's depth,
the main-view raster of the opaque triangles with the fused G-buffer kernel
(with per-pixel velocity from the previous frame's screen positions), the
G-buffer and the disocclusion mask, cascaded shadows (the atlas depth
raster, the translucent casters' tint map and the resolve), half-res HBAO,
SSR and SSGI from the previous frame's HDR, the atmosphere's sky with the
volumetric clouds and their shadow, SH ambient and specular ambient, the
lighting resolve, aerial perspective, then the non-opaque passes
(weighted-blended OIT, refraction, the sorted back-to-front blend,
trans-depth), bloom, auto exposure, tone mapping, the upscale to display
size (`render_scale`) and FXAA or SMAA. The 3D passes run at the scaled
size `render_size(config)`. A config that needs a pass the port lacks
raises NotImplementedError naming the ROADMAP item that ports it; nothing
is skipped silently.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.ops import blur
from garden_tpu_torch.ops.blur import decimate2x, upsample2x_to
from garden_tpu_torch.render import (atmosphere, bloom, clouds, csm, fxaa, gbuffer,
                                     hbao, hiz, lighting, mesh, oit, raster, smaa,
                                     ssgi, ssr, tonemap)

Tensor = torch.Tensor

SHADOW_NEAR = 0.1   # the camera near plane the cascades are fitted with
REFRACT_STRENGTH = 48.0   # screen offset of the refracted sample, px per unit normal
DISOCCLUSION_STEP = 2     # the disocclusion mask is resolved on every 2nd row and column


def check_ported(config: RenderConfig) -> None:
    """Raise NotImplementedError for any pass the port cannot run yet: the
    slot-binned cascade atlas (csm.atlas_tiling)."""
    if config.use_shadows:
        csm.atlas_tiling(config.shadow)


def render_size(config: RenderConfig) -> Tuple[int, int]:
    """(width, height) of the 3D passes: the display size, or under
    render_scale != 1 the scaled size cut down to whole tiles (at least
    one)."""
    scale = config.render_scale
    if scale == 1.0:
        return config.width, config.height
    t = config.tile_size
    return (max(int(config.width * scale) // t, 1) * t,
            max(int(config.height * scale) // t, 1) * t)


def nearest_rows(n_in: int, n_out: int, device) -> Tensor:
    """(n_out,) source indices of a nearest resize from n_in to n_out, as
    the reference's jitted `jax.image.resize(..., "nearest")` computes
    them: floor((i + 0.5) * c) in float32 with the constant c = n_in *
    (1 / n_out), the form XLA folds (i + 0.5) * n_in / n_out into; it
    differs from the exact quotient where that is an integer.
    F.interpolate's "nearest" and "nearest-exact" pick other rows at some
    ratios. Built once per device."""
    return _nearest_rows(n_in, n_out, str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _nearest_rows(n_in: int, n_out: int, device: str) -> Tensor:
    c = np.float32(n_in) * (np.float32(1.0) / np.float32(n_out))
    idx = np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * c)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


class DeferredRenderer:
    """Owns the host scene and the config; `render` is a function of the
    device scene, instance matrices, constants and frame state."""

    def __init__(self, config: RenderConfig, scene: mesh.SceneBuffers, device):
        check_ported(config)
        self.config = config
        self.scene_host = scene
        self.device = torch.device(device)
        # passes gated on the scene's content, as the reference's
        self.any_translucent = bool(scene.tri_translucent_mask().any())
        self.any_sorted = bool(scene.tri_sorted_mask().any())
        self.any_refract = bool(scene.tri_refract_mask().any())
        self.any_nonopaque = self.any_translucent or self.any_sorted or self.any_refract
        self.width, self.height = render_size(config)

    def device_scene(self) -> Dict[str, Tensor]:
        return self.scene_host.device_arrays(self.device)

    def initial_frame_state(self) -> Dict[str, Tensor]:
        """The frame state before the first frame, under the reference's
        keys: the adapted luminance; the previous depth (Hi-Z, disocclusion;
        empty: nothing occludes), camera and HDR (SSR, SSGI; black: no
        reflections or bounce on frame 0) where a pass reads them."""
        cfg, dev = self.config, self.device
        w, h = self.width, self.height
        state = {"avg_luminance": torch.tensor(0.18, device=dev)}
        if cfg.use_occlusion_culling or cfg.use_velocity:
            state["prev_depth"] = torch.zeros((h, w), device=dev)
        if cfg.use_velocity or cfg.use_ssr or cfg.use_ssgi:
            state["prev_view_proj"] = torch.eye(4, device=dev)
        if cfg.use_ssr or cfg.use_ssgi:
            state["prev_hdr"] = torch.zeros((h, w, 3), device=dev)
        return state

    @staticmethod
    def instance_bounds(scene: Dict[str, Tensor], inst_matrices: Tensor
                        ) -> Tuple[Tensor, Tensor]:
        """(min, max) (I, 3) world AABBs of the instances' local AABBs."""
        corners = hiz.box_corners(scene["inst_aabb_min"], scene["inst_aabb_max"])
        wc = (torch.einsum("iab,ikb->ika", inst_matrices[:, :3, :3], corners)
              + inst_matrices[:, None, :3, 3])
        return torch.amin(wc, dim=1), torch.amax(wc, dim=1)

    def cull_instances(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                       constants: Dict[str, Tensor]) -> Tensor:
        """Frustum-cull instance AABBs -> per-triangle validity mask."""
        planes = m3.frustum_planes(constants["view_proj"])
        outside = m3.aabb_outside_frustum(planes, *self.instance_bounds(scene, inst_matrices))
        visible = scene["inst_valid"] & ~outside
        ti = scene["tri_instance"]
        vis_t = visible[torch.clamp(ti, min=0).long()] & (ti >= 0)
        return scene["tri_valid"] & vis_t

    def occluded_instances(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                           constants: Dict[str, Tensor], prev_depth: Tensor) -> Tensor:
        """(I,) bool: instances hidden behind the Hi-Z pyramid of the
        previous frame's depth (one frame stale, not reprojected)."""
        return hiz.occlusion_cull(*self.instance_bounds(scene, inst_matrices),
                                  constants["view_proj"], hiz.build_pyramid(prev_depth),
                                  self.width, self.height)

    def visible_triangles(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                          constants: Dict[str, Tensor],
                          frame_state: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """(T,) triangles that pass the frustum cull and, with occlusion
        culling on, the Hi-Z cull against frame_state["prev_depth"]."""
        tri_valid = self.cull_instances(scene, inst_matrices, constants)
        if not self.config.use_occlusion_culling:
            return tri_valid
        with record_function("hiz"):
            occluded = self.occluded_instances(scene, inst_matrices, constants,
                                               frame_state["prev_depth"])
            return tri_valid & ~occluded[torch.clamp(scene["tri_instance"], min=0).long()]

    @staticmethod
    def nonopaque(scene: Dict[str, Tensor]) -> Tensor:
        """Triangles of the OIT, sorted and refraction passes."""
        return scene["tri_translucent"] | scene["tri_sorted"] | scene["tri_refract"]

    @staticmethod
    def tri_materials(scene: Dict[str, Tensor]) -> Tensor:
        """(T, 12) material row of each triangle's instance."""
        inst = torch.clamp(scene["tri_instance"], min=0).long()
        return scene["materials"][scene["inst_material"][inst].long()]

    def tiling(self) -> Tuple[int, int, int, int]:
        """(tile height, main-pass list cap, the other passes' cap, foot_y)
        of the screen passes."""
        cfg = self.config
        th = cfg.tile_h or cfg.tile_size
        cap_scale = max(th / cfg.tile_size, 0.25)
        cap_main = max(64, int(cfg.max_tris_per_tile * cap_scale) // 16 * 16)
        fy = cfg.foot_y or max(2, min(8, (2 * cfg.tile_size) // th))
        return th, cap_main, max(32, cap_main // 2), fy

    def pass_setup(self, pos_planes, mask: Tensor,
                   constants: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Clip transform of the world corner planes and screen setup of the
        triangles in `mask`."""
        px, py, pz = pos_planes
        m = constants["view_proj"]
        comps = [m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]
                 for i in range(4)]
        return raster.setup_triangles_planes(*comps, mask, self.width, self.height)

    def prev_screen(self, prev_planes, prev_view_proj: Tensor) -> Tensor:
        """(T, 3, 2) screen positions (pixels of the render size) of the
        triangles' corners under the previous frame's world corner planes
        and camera: the velocity inputs of the shading records."""
        px, py, pz = prev_planes
        m = prev_view_proj
        cx, cy, cw = [m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]
                      for i in (0, 1, 3)]
        cw = torch.clamp(cw, min=1e-6)
        sx = (cx / cw * 0.5 + 0.5) * self.width
        sy = (0.5 - cy / cw * 0.5) * self.height
        return torch.stack([sx.T, sy.T], dim=-1)

    def raster_inputs(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                      constants: Dict[str, Tensor], planes: Tuple[tuple, tuple] = None,
                      tri_valid: Tensor = None,
                      frame_state: Optional[Dict[str, Tensor]] = None,
                      prev_inst_matrices: Optional[Tensor] = None) -> Dict[str, Any]:
        """Everything up to the fused raster of the opaque triangles:
        transformed, set-up, binned triangles and their shading records, as
        the keyword arguments of raster.rasterize_visibility_shaded.
        `planes` (mesh.transform_triangle_planes) and `tri_valid`
        (visible_triangles, with the frame state's Hi-Z) are computed
        unless given. With velocity on, the records carry the corners'
        previous screen positions under `prev_inst_matrices` (default: this
        frame's) and frame_state["prev_view_proj"] (default: this camera)."""
        cfg = self.config
        w, h = self.width, self.height
        pos_pl, nrm_pl = planes or mesh.transform_triangle_planes(scene, inst_matrices)
        if tri_valid is None:
            tri_valid = self.visible_triangles(scene, inst_matrices, constants,
                                               frame_state)
        setup = self.pass_setup(pos_pl, tri_valid & ~self.nonopaque(scene), constants)
        # front-to-back binning priority: when a tile overflows, its
        # farthest triangles drop (16 depth buckets over the visible range)
        zt = torch.amax(setup["z"], dim=0)
        zlo = torch.amin(torch.where(setup["valid"], zt, torch.inf))
        zhi = torch.amax(torch.where(setup["valid"], zt, -torch.inf))
        zn = (zt - zlo) / torch.clamp(zhi - zlo, min=1e-12)
        prio = 15 - torch.clamp((zn * 16.0).int(), 0, 15)
        th, cap_main, _, fy = self.tiling()
        tiles, counts, big = raster.bin_triangles(
            setup, w, h, cfg.tile_size, max(32, cap_main - 32), max_big=32,
            bucket_priority=prio, foot=2, tile_h=th, foot_y=fy)
        nx, ny, nz = nrm_pl
        t_cnt = nx.shape[1]
        tri_nrm = torch.stack([nx.T, ny.T, nz.T], dim=-1).reshape(t_cnt, 3, 3)
        prev = None
        if cfg.use_velocity:
            prev_pl = (pos_pl if prev_inst_matrices is None
                       else mesh.transform_triangle_planes(scene, prev_inst_matrices)[0])
            prev = self.prev_screen(prev_pl, (frame_state or {}).get(
                "prev_view_proj", constants["view_proj"]))
        records = gbuffer.pack_triangle_records(scene, tri_nrm, setup["inv_w"], prev)
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

    def cascade_inputs(self, scene: Dict[str, Tensor], pos_planes, light
                       ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
        """(opaque, translucent): the keyword arguments of
        raster.rasterize_depth for this frame's cascade atlas and, when the
        scene has non-opaque content, for the translucent casters' atlas
        (else None), from the world corner planes and `shadow_light`'s
        light. Casters are every valid triangle of the scene, not only
        those in the camera's frustum."""
        tri_trans = self.nonopaque(scene) if self.any_nonopaque else None
        return csm.caster_inputs(pos_planes, scene["tri_valid"], light,
                                 self.config.shadow, tri_translucent=tri_trans)

    # The frame's stages, in order; `render` composes them, and each is a
    # method of its own so that tools can time or inspect it.

    def gbuffer_pass(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
                     constants: Dict[str, Tensor],
                     frame_state: Optional[Dict[str, Tensor]] = None,
                     prev_inst_matrices: Optional[Tensor] = None):
        """Transform, cull (frustum, and Hi-Z against the frame state's
        previous depth), set up, bin, the fused raster of the opaque
        triangles (kernel K1) and the G-buffer, with "velocity" when it is
        on -> (geo, vis, G-buffer dict); geo holds the world corner planes,
        the culled triangle mask and the shading records, which the
        non-opaque passes reuse."""
        planes = mesh.transform_triangle_planes(scene, inst_matrices)
        tri_valid = self.visible_triangles(scene, inst_matrices, constants, frame_state)
        kin = self.raster_inputs(scene, inst_matrices, constants, planes, tri_valid,
                                 frame_state, prev_inst_matrices)
        vis, gplanes = raster.rasterize_visibility_shaded(**kin)
        geo = {"planes": planes[0], "tri_valid": tri_valid,
               "records": kin["shade_records"]}
        return geo, vis, gbuffer.shade_gbuffer(vis, gplanes, constants=constants,
                                               with_velocity=self.config.use_velocity)

    def disocclusion(self, velocity: Tensor, depth: Tensor, prev_depth: Tensor) -> Tensor:
        """(H, W) 1 where the previous frame's depth, fetched at each pixel
        moved back by its velocity, differs from this depth by more than 10%
        (or lies off screen): newly revealed surfaces. Resolved on every
        DISOCCLUSION_STEP-th row and column, then a nearest resize."""
        s = DISOCCLUSION_STEP
        vel_d = velocity[::s, ::s]
        depth_d = depth[::s, ::s]
        hd, wd = depth_d.shape
        dev = depth.device
        py = (torch.arange(hd, dtype=torch.float32, device=dev)[:, None] + 0.5) * s \
            - vel_d[..., 1]
        px = (torch.arange(wd, dtype=torch.float32, device=dev)[None, :] + 0.5) * s \
            - vel_d[..., 0]
        ph, pw = prev_depth.shape
        iy = torch.clamp(py.int(), 0, ph - 1).long()
        ix = torch.clamp(px.int(), 0, pw - 1).long()
        rel = torch.abs(prev_depth[iy, ix] - depth_d) / torch.clamp(depth_d, min=1e-6)
        dis = (rel > 0.1) | (px < 0) | (px >= pw) | (py < 0) | (py >= ph)
        h, w = depth.shape
        return dis.float()[nearest_rows(hd, h, dev)][:, nearest_rows(wd, w, dev)]

    def caster_tint(self, scene: Dict[str, Tensor]) -> Optional[Tensor]:
        """(T, 4) rgba tint of each triangle in the translucent shadow map
        (its material's base colour and alpha), or None when the scene has
        no non-opaque content."""
        if not self.any_nonopaque:
            return None
        mat = self.tri_materials(scene)
        return torch.cat([mat[:, 0:3], mat[:, 9:10]], dim=-1)

    def shadow_atlas(self, scene: Dict[str, Tensor], pos_planes, light
                     ) -> Tuple[Tensor, Optional[Tensor]]:
        """(depth_atlas, trans_atlas): the opaque casters' reverse-Z depth
        (kernels K2 + K3, or K4) and, when the scene has non-opaque
        content, the translucent casters' tint and depth (K4, then K6)."""
        return csm.draw_cascades(*self.cascade_inputs(scene, pos_planes, light),
                                 tri_tint=self.caster_tint(scene))

    def shadow_factor(self, g: Dict[str, Tensor], constants: Dict[str, Tensor],
                      atlas: Tensor, light, splits,
                      trans_atlas: Optional[Tensor] = None) -> Tensor:
        """The resolved shadow factor (H, W, 1), or (H, W, 3) tinted by the
        translucent casters; 1 where nothing was drawn."""
        view_depth = m3.length(g["position"] - constants["camera_pos"])
        shadow = csm.resolve_shadow(g["position"], g["normal"], view_depth, atlas,
                                    light, self.config.shadow, splits, trans_atlas)
        return torch.where(g["visible"][..., None], shadow, 1.0)

    def ambient_occlusion(self, g: Dict[str, Tensor],
                          constants: Dict[str, Tensor]) -> Tensor:
        return hbao.compute_hbao(g["position"], g["normal"], g["visible"],
                                 constants["camera_pos"], half_res=True)

    def reflections(self, g: Dict[str, Tensor], depth: Tensor,
                    frame_state: Dict[str, Tensor], constants: Dict[str, Tensor]
                    ) -> Tuple[Tensor, Tensor]:
        """SSR against the previous frame's HDR -> (rgb (H, W, 3),
        confidence (H, W), 0 where no geometry)."""
        rgb, conf = ssr.trace(g, depth, frame_state["prev_hdr"],
                              frame_state.get("prev_view_proj", constants["view_proj"]),
                              constants, self.config.ssr)
        return rgb, torch.where(g["visible"], conf, 0.0)

    def bounce(self, g: Dict[str, Tensor], depth: Tensor, frame_state: Dict[str, Tensor],
               constants: Dict[str, Tensor]) -> Tensor:
        """SSGI: one-bounce diffuse irradiance (H, W, 3), gathered at half
        res from the previous frame's HDR."""
        return ssgi.compute_ssgi(g["position"], g["normal"], g["visible"], depth,
                                 frame_state["prev_hdr"],
                                 frame_state.get("prev_view_proj", constants["view_proj"]),
                                 intensity=self.config.ssgi_intensity)

    def cloud_shadow(self, g: Dict[str, Tensor], constants: Dict[str, Tensor],
                     shadow: Tensor) -> Tensor:
        """The shadow factor times the clouds' sun transmittance on the
        visible pixels, evaluated at half res and tent-upsampled."""
        cs = clouds.cloud_shadow(decimate2x(g["position"]), -constants["light_dir"],
                                 time=constants["time"])
        cs = upsample2x_to(cs[..., None], self.height, self.width)[..., 0]
        return shadow * torch.where(g["visible"], cs, 1.0)[..., None]

    def shade(self, g: Dict[str, Tensor], constants: Dict[str, Tensor],
              shadow, ao, reflection: Optional[Tensor] = None,
              reflection_conf: Optional[Tensor] = None,
              gi: Optional[Tensor] = None) -> Tensor:
        """The sky (under the atmosphere with the clouds when they are on)
        and the lighting resolve with the SSR and SSGI inputs -> HDR
        (H, W, 3) float32."""
        extra = dict(reflection=reflection, reflection_conf=reflection_conf, gi=gi)
        if self.config.use_atmosphere:
            return self._atmosphere_lighting(g, constants, shadow, ao, extra)
        return lighting.resolve(g, constants, shadow=shadow, ao=ao, **extra)

    def _pass_colors(self, scene: Dict[str, Tensor]) -> Tensor:
        """(T, 4) rgba of the OIT and sorted passes: the simple translucent
        shading, tinted ambient plus emissive, with the material's alpha."""
        mat = self.tri_materials(scene)
        return torch.cat([mat[:, 0:3] * 0.8 + mat[:, 5:8], mat[:, 9:10]], dim=-1)

    def oit_inputs(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                   constants: Dict[str, Tensor], opaque_depth: Tensor
                   ) -> Dict[str, Any]:
        """The keyword arguments of oit.rasterize_oit: the translucent
        triangles set up and binned on square tiles, the big list merged
        in front of every tile's list."""
        cfg = self.config
        w, h = self.width, self.height
        tsetup = self.pass_setup(geo["planes"], geo["tri_valid"] & scene["tri_translucent"],
                                 constants)
        tiles, counts = raster.merge_big_list(*raster.bin_triangles(
            tsetup, w, h, cfg.tile_size, cfg.max_tris_per_tile // 2))
        return dict(setup=tsetup, tri_colors=self._pass_colors(scene), tile_tris=tiles,
                    counts=counts, opaque_depth=opaque_depth, width=w, height=h,
                    tile=cfg.tile_size)

    def oit_pass(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                 constants: Dict[str, Tensor], opaque_depth: Tensor, hdr: Tensor
                 ) -> Tuple[Tensor, Tensor]:
        """Weighted-blended OIT of the translucent triangles over the HDR
        (kernel K7) -> (HDR, reveal)."""
        accum, reveal = oit.rasterize_oit(**self.oit_inputs(scene, geo, constants,
                                                            opaque_depth))
        return oit.composite(hdr, accum, reveal), reveal

    def refraction_inputs(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                          constants: Dict[str, Tensor]) -> Dict[str, Any]:
        """The keyword arguments of raster.rasterize_visibility for the
        refractive triangles."""
        cfg = self.config
        w, h = self.width, self.height
        th, _, cap_half, fy = self.tiling()
        rsetup = self.pass_setup(geo["planes"], geo["tri_valid"] & scene["tri_refract"],
                                 constants)
        tiles, counts, big = raster.bin_triangles(rsetup, w, h, cfg.tile_size, cap_half,
                                                  tile_h=th, foot_y=fy)
        return dict(setup=rsetup, tile_tris=tiles, counts=counts, big_list=big,
                    width=w, height=h, tile=cfg.tile_size, tile_h=th)

    def refraction_pass(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                        constants: Dict[str, Tensor], hdr: Tensor
                        ) -> Tuple[Tensor, Tensor]:
        """Refractive triangles (visibility kernel K5, not depth-tested
        against the opaque depth, as the reference) sample a GGX-blurred
        copy of the HDR at a normal-driven offset, tinted by their base
        colour -> (HDR, the refraction pass's tri_id)."""
        w, h = self.width, self.height
        rvis = raster.rasterize_visibility(**self.refraction_inputs(scene, geo, constants))
        rg = gbuffer.shade_gbuffer(rvis, constants=constants, records=geo["records"])
        chain = blur.ggx_blur_chain(hdr, levels=3)
        lvl = torch.clamp(rg["roughness"] * 2.0, 0.0, 2.0)
        dev = hdr.device
        oy = -rg["normal"][..., 1] * REFRACT_STRENGTH
        ox = rg["normal"][..., 0] * REFRACT_STRENGTH
        yy = torch.clamp((torch.arange(h, device=dev)[:, None] + oy).int(), 0, h - 1)
        xx = torch.clamp((torch.arange(w, device=dev)[None, :] + ox).int(), 0, w - 1)
        flat = (yy * w + xx).reshape(-1).long()
        samples = [(c if c.shape[:2] == (h, w) else blur.upsample_linear(c, h, w))
                   .reshape(-1, 3)[flat].reshape(h, w, 3) for c in chain]
        refr = samples[0]
        for k in range(1, len(samples)):
            wk = torch.clamp(1.0 - torch.abs(lvl - k), 0.0, 1.0)[..., None]
            refr = torch.where(lvl[..., None] > k - 1,
                               samples[k] * wk + refr * (1.0 - wk), refr)
        covered = rvis["tri_id"] >= 0
        return torch.where(covered[..., None], refr * rg["base_color"], hdr), \
            rvis["tri_id"]

    def sorted_inputs(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                      constants: Dict[str, Tensor], opaque_depth: Tensor, hdr: Tensor
                      ) -> Dict[str, Any]:
        """The keyword arguments of raster.rasterize_sorted_blend: the
        sorted triangles binned back to front (the centroid reverse-Z, a
        stable argsort, its inverse as the binning priority)."""
        cfg = self.config
        w, h = self.width, self.height
        th, _, cap_half, fy = self.tiling()
        ssetup = self.pass_setup(geo["planes"], geo["tri_valid"] & scene["tri_sorted"],
                                 constants)
        # ascending reverse-Z: far first
        zkey = torch.where(ssetup["valid"], torch.mean(ssetup["z"], dim=0), 2.0)
        order = torch.argsort(zkey, stable=True)
        prio = torch.empty_like(order)
        prio[order] = torch.arange(order.shape[0], device=order.device)
        tiles, counts, big = raster.bin_triangles(ssetup, w, h, cfg.tile_size, cap_half,
                                                  priority=prio, tile_h=th, foot_y=fy)
        return dict(setup=ssetup, tri_rgba=self._pass_colors(scene), tile_tris=tiles,
                    counts=counts, big_list=big, opaque_depth=opaque_depth, hdr=hdr,
                    width=w, height=h, tile=cfg.tile_size, tile_h=th)

    def sorted_pass(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                    constants: Dict[str, Tensor], opaque_depth: Tensor, hdr: Tensor
                    ) -> Tensor:
        """Back-to-front alpha blend of the sorted triangles over the HDR
        (kernel K6)."""
        return raster.rasterize_sorted_blend(**self.sorted_inputs(
            scene, geo, constants, opaque_depth, hdr))

    def trans_depth_inputs(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                           constants: Dict[str, Tensor]) -> Dict[str, Any]:
        """The keyword arguments of raster.rasterize_depth for the
        non-opaque triangles at screen tiles."""
        cfg = self.config
        w, h = self.width, self.height
        th, _, cap_half, fy = self.tiling()
        dsetup = self.pass_setup(geo["planes"], geo["tri_valid"] & self.nonopaque(scene),
                                 constants)
        tiles, counts, big = raster.bin_triangles(dsetup, w, h, cfg.tile_size, cap_half,
                                                  tile_h=th, foot_y=fy)
        return dict(setup=dsetup, tile_tris=tiles, counts=counts, big_list=big,
                    width=w, height=h, tile=cfg.tile_size, tile_h=th)

    def trans_depth_pass(self, scene: Dict[str, Tensor], geo: Dict[str, Tensor],
                         constants: Dict[str, Tensor]) -> Tensor:
        """The nearest non-opaque surface's reverse-Z depth (kernel K4 at
        screen tiles), 0 where there is none."""
        return raster.rasterize_depth(**self.trans_depth_inputs(scene, geo, constants))

    def tone(self, hdr: Tensor, constants: Dict[str, Tensor],
             frame_state: Dict[str, Tensor]):
        """Bloom, auto exposure, tone mapping and, under render_scale != 1,
        the linear upscale to the display size -> (float sRGB LDR image,
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
        if (self.height, self.width) != (cfg.height, cfg.width):
            ldr = blur.upsample_linear(ldr, cfg.height, cfg.width)
        return ldr, hdr, avg_lum

    def antialias(self, ldr: Tensor) -> Tensor:
        """SMAA (aa_mode "smaa") or FXAA on the display-size LDR image."""
        return smaa.apply_smaa(ldr) if self.config.aa_mode == "smaa" else fxaa.apply_fxaa(ldr)

    def post(self, hdr: Tensor, constants: Dict[str, Tensor],
             frame_state: Dict[str, Tensor]):
        """`tone`, then `antialias` when use_fxaa is on -> (uint8 image,
        the post chain's HDR, the adapted average luminance)."""
        ldr, hdr, avg_lum = self.tone(hdr, constants, frame_state)
        if self.config.use_fxaa:
            with record_function("aa"):
                ldr = self.antialias(ldr)
        return tonemap.to_uint8(ldr), hdr, avg_lum

    def render(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
               constants: Dict[str, Tensor], frame_state: Dict[str, Tensor],
               prev_inst_matrices: Optional[Tensor] = None) -> Dict[str, Any]:
        """One frame. The output holds the image, the post chain's HDR, the
        opaque depth and tri_id, the G-buffer, the shadow and AO factors,
        the velocity (pixels, from `prev_inst_matrices`, default this
        frame's, and the frame state's camera) and the disocclusion mask,
        trans-depth, the next frame state and, under "translucent", what
        the non-opaque passes drew: the OIT reveal, the refraction pass's
        tri_id and the translucent shadow atlas (each None when its pass
        did not run)."""
        cfg = self.config
        disocclusion = None
        with record_function("raster"):
            geo, vis, g = self.gbuffer_pass(scene, inst_matrices, constants, frame_state,
                                            prev_inst_matrices)
            if cfg.use_velocity and "prev_depth" in frame_state:
                disocclusion = self.disocclusion(g["velocity"], vis["depth"],
                                                 frame_state["prev_depth"])
        shadow = trans_atlas = None
        if cfg.use_shadows:
            with record_function("csm_render"):
                light, splits = self.shadow_light(constants)
                atlas, trans_atlas = self.shadow_atlas(scene, geo["planes"], light)
            with record_function("csm_resolve"):
                shadow = self.shadow_factor(g, constants, atlas, light, splits,
                                            trans_atlas)
        ao = None
        if cfg.use_hbao:
            with record_function("hbao"):
                ao = self.ambient_occlusion(g, constants)
        ssr_rgb = ssr_conf = gi = None
        if cfg.use_ssr and "prev_hdr" in frame_state:
            with record_function("ssr"):
                ssr_rgb, ssr_conf = self.reflections(g, vis["depth"], frame_state, constants)
        if cfg.use_ssgi and "prev_hdr" in frame_state:
            with record_function("ssgi"):
                gi = self.bounce(g, vis["depth"], frame_state, constants)
        with record_function("sky_lighting"):
            if cfg.use_atmosphere and cfg.use_clouds and shadow is not None:
                with record_function("clouds"):
                    shadow = self.cloud_shadow(g, constants, shadow)
            hdr = self.shade(g, constants, shadow, ao, ssr_rgb, ssr_conf, gi)
        reveal = refract_id = trans_depth = None
        if cfg.use_oit and self.any_translucent:
            with record_function("oit"):
                hdr, reveal = self.oit_pass(scene, geo, constants, vis["depth"], hdr)
        if self.any_refract:
            with record_function("refraction"):
                hdr, refract_id = self.refraction_pass(scene, geo, constants, hdr)
        if self.any_sorted:
            with record_function("sorted"):
                hdr = self.sorted_pass(scene, geo, constants, vis["depth"], hdr)
        if cfg.use_trans_depth and self.any_nonopaque:
            with record_function("trans_depth"):
                trans_depth = self.trans_depth_pass(scene, geo, constants)
        lit = hdr          # float32, before bloom: next frame's SSR and SSGI read it
        with record_function("post"):
            image, hdr, avg_lum = self.post(hdr, constants, frame_state)
        state = {"avg_luminance": avg_lum}
        if cfg.use_occlusion_culling or cfg.use_velocity:
            state["prev_depth"] = vis["depth"]
        if cfg.use_velocity or cfg.use_ssr or cfg.use_ssgi:
            state["prev_view_proj"] = constants["view_proj"]
        if cfg.use_ssr or cfg.use_ssgi:
            state["prev_hdr"] = lit
        return {
            "image": image,
            "hdr": hdr,
            "depth": vis["depth"],
            "tri_id": vis["tri_id"],
            "gbuffer": g,
            "shadow": shadow,
            "ao": ao,
            "velocity": g.get("velocity"),
            "disocclusion": disocclusion,
            "trans_depth": trans_depth,
            "translucent": {"reveal": reveal, "refract_tri_id": refract_id,
                            "trans_atlas": trans_atlas},
            "frame_state": state,
        }

    def _atmosphere_lighting(self, g: Dict[str, Tensor], constants: Dict[str, Tensor],
                             shadow, ao, extra: Dict[str, Optional[Tensor]]) -> Tensor:
        """Lighting under the atmosphere: the sky raymarched at half res,
        the clouds composited over it there when they are on, and
        tent-upsampled; SH ambient, a specular ambient that blends the sharp
        sky in the reflection direction with the SH irradiance by roughness
        (also at half res), the resolve with `extra` (its SSR and SSGI
        inputs), then aerial perspective."""
        cfg = self.config
        w, h = self.width, self.height
        to_light = -constants["light_dir"]
        rays = lighting.view_rays(g, constants)
        rays_h = decimate2x(rays)
        sky_h = atmosphere.sky_radiance(rays_h, to_light)
        if cfg.use_clouds:
            with record_function("clouds"):
                crgb, calpha = clouds.render_clouds(rays_h, to_light, time=constants["time"])
                sky_h = clouds.composite_clouds(sky_h, crgb, calpha)
        sky = upsample2x_to(sky_h, h, w)
        sh = atmosphere.sky_sh(to_light)
        view = m3.normalize(constants["camera_pos"] - g["position"])
        refl_h = decimate2x(m3.reflect(-view.expand(g["normal"].shape), g["normal"]))
        spec_sharp = atmosphere.sky_radiance(refl_h, to_light, steps=4)
        spec_rough = atmosphere.sh_irradiance(refl_h, sh)
        r_h = torch.clamp(decimate2x(g["roughness"]), 0.0, 1.0)[..., None]
        spec_amb = upsample2x_to(spec_sharp * (1.0 - r_h) + spec_rough * r_h, h, w)
        hdr = lighting.resolve(g, constants, shadow=shadow, ao=ao, ambient_sh=sh,
                               sky=sky, specular_ambient=spec_amb, **extra)
        if cfg.use_aerial_perspective:
            vd_km = m3.length(g["position"] - constants["camera_pos"]) \
                * cfg.aerial_km_per_unit
            trans, inscatter = atmosphere.aerial_perspective(vd_km, rays, to_light)
            hdr = torch.where(g["visible"][..., None], hdr * trans + inscatter, hdr)
        return hdr
