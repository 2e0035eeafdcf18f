"""Split-frame rendering: one frame's rows rendered as horizontal bands.

Port of `garden_tpu.parallel.frame_tiles`. The screen splits into
`n_bands` horizontal bands; each band renders through an asymmetric crop
of the projection matrix on its own device, and the bands are stitched on
the first device. A device may repeat: `["cuda"] * 4` renders four bands
on one card, `["cpu"] * 4` on the CPU.

As in the reference:
- Geometry work (transform, setup, the shadow cascades) repeats per band;
  only per-pixel work divides.
- Screen-space effects read neighbour pixels, so each band renders
  `overlap` guard rows on both sides (rounded up to the raster tile
  height) and crops them.
- Auto exposure is temporal: every band tone-maps the current frame with
  its frame state's luminance, and each band's next luminance is the mean
  over the bands, so the bands never diverge in exposure.

The reference `vmap`s one renderer over the bands on a device mesh. The
port cannot: its renderer launches hand-written CUDA kernels through
ctypes, which vmap cannot batch. So `render` loops over the bands, one
`DeferredRenderer.render` each, queued one after another.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.render.deferred import DeferredRenderer

Tensor = torch.Tensor


def crop_projection(view_proj: Tensor, y0_ndc: float, y1_ndc: float) -> Tensor:
    """Asymmetric vertical crop of a (view-)projection matrix: remaps NDC y
    in [y0, y1] onto [-1, 1] (a row operation on row 1 with clip w's row 3,
    valid for perspective and orthographic alike)."""
    scale = 2.0 / (y1_ndc - y0_ndc)
    off = -(y0_ndc + y1_ndc) / (y1_ndc - y0_ndc)
    m = view_proj
    return torch.cat([m[:1], (m[1] * scale + m[3] * off)[None], m[2:]])


def band_constants(constants: Dict[str, Tensor], band: int, n_bands: int,
                   overlap_ndc: float) -> Dict[str, Tensor]:
    """Per-band camera constants: view_proj cropped to the band's rows plus
    the guard overlap, inv_view_proj its inverse (the cascade fit reads
    it). Screen y runs down and NDC y up, so band 0 is the highest slice."""
    y1 = 1.0 - 2.0 * band / n_bands + overlap_ndc
    y0 = 1.0 - 2.0 * (band + 1) / n_bands - overlap_ndc
    vp = crop_projection(constants["view_proj"], y0, y1)
    return dict(constants, view_proj=vp, inv_view_proj=m3.mat4_inverse(vp))


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, Tensor) else tree


class FrameTiles:
    """Render one frame as `n_bands` horizontal bands, band i on devices[i].

    Usage:
        ft = FrameTiles(cfg, scene, n_bands=4, overlap=16, devices=["cuda"] * 4)
        state = ft.initial_state()
        image, state = ft.render(ft.renderer.device_scene(), inst_mats, constants, state)
    """

    def __init__(self, config, scene, n_bands: int, overlap: int = 16,
                 devices: Optional[Sequence] = None):
        devices = [torch.device(d) for d in (devices if devices is not None
                                             else ["cuda"] * n_bands)]
        if n_bands > len(devices):
            raise ValueError(f"{n_bands} bands > {len(devices)} devices")
        if config.height % n_bands:
            raise ValueError("height must divide into bands")
        th = config.tile_h or config.tile_size
        # guard rows round up to the raster tile height, as the reference's
        overlap = -(-overlap // th) * th
        self.n_bands = n_bands
        self.overlap = overlap
        self.band_h = config.height // n_bands
        self.full_h = config.height
        self.config = dataclasses.replace(config, height=self.band_h + 2 * overlap)
        self.devices = devices[:n_bands]
        by_device: Dict[torch.device, DeferredRenderer] = {}
        for d in self.devices:
            if d not in by_device:
                by_device[d] = DeferredRenderer(self.config, scene, d)
        self.renderers: List[DeferredRenderer] = [by_device[d] for d in self.devices]
        self.renderer = self.renderers[0]

    def initial_state(self) -> List[Dict[str, Tensor]]:
        """One frame state per band, each on its band's device."""
        return [r.initial_frame_state() for r in self.renderers]

    def render(self, scene: Dict[str, Tensor], inst_matrices: Tensor,
               constants: Dict[str, Tensor], frame_state: List[Dict[str, Tensor]]
               ) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
        """-> (image (H, W, 3) uint8 on the first band's device, the next
        frame state of each band). The inputs move to each band's device
        (no copy where they already are)."""
        ov_ndc = 2.0 * self.overlap / self.full_h
        first = self.devices[0]
        images, states = [], []
        for band, (dev, r, fstate) in enumerate(zip(self.devices, self.renderers,
                                                    frame_state)):
            consts = band_constants(_to(constants, dev), band, self.n_bands, ov_ndc)
            out = r.render(_to(scene, dev), inst_matrices.to(dev), consts, fstate)
            images.append(out["image"][self.overlap:self.overlap + self.band_h].to(first))
            states.append(out["frame_state"])
        # one exposure for every band's next frame
        lum = torch.mean(torch.stack([s["avg_luminance"].to(first) for s in states]))
        states = [dict(s, avg_luminance=lum.to(d)) for s, d in zip(states, self.devices)]
        return torch.cat(images, dim=0), states
