"""Entry `ultra`: `garden_tpu_torch.entry.CombinedStep.__call__` once a step,
one world on one device, under Garden's Ultra quality.

The program's step is `entry.build` at the configuration file's sizes with
its render block (the flagship's plus clouds, SSR, SSGI and the 5x5 PCF)
passed as overrides, built, stepped and timed as `combined_step` does; the
entry raises unless the program's SSR, SSGI and cloud settings are the
file's. SSR and SSGI read the lit HDR and the camera of the step before
(`prev_hdr`, `prev_view_proj` in the frame state), so the check holds what
a step hands its next to the reference's too: each kept step is followed
from the program's own input by one reference step (`scenes.Flagship` with
the file's render block), and besides the body state, the instance
matrices and the image, the frame state the program hands on is compared
with the reference's: `lit_hdr` (the widest gap of `prev_hdr`, relative to
max(|reference|, 1)), `avg_luminance` (the widest gap of the adapted
luminance) and `view_proj_leaves` (leaves of `prev_view_proj` that differ
in any bit).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List, Optional

import torch

from benchmark import check
from benchmark.entries import combined_step, world_sim
from benchmark.entries._shared import bf16_rounded, precision
from benchmark.reference import scenes as ref_scenes


def require_screen_space(step, cfg: Dict[str, Any]) -> None:
    """Raise unless the program runs the file's pass switches, SSR
    settings, SSGI gather and cloud layer."""
    from garden_tpu_torch.render import ssgi
    rcfg = step.renderer.config
    defaults = {k: p.default for k, p in inspect.signature(ssgi.compute_ssgi).parameters.items()}
    have = {
        "switches": {k: getattr(rcfg, k) for k in ("use_clouds", "use_ssr", "use_ssgi")},
        "ssr": dataclasses.asdict(rcfg.ssr),
        "ssgi": {"half_res": defaults["half_res"], "directions": ssgi.N_DIRS,
                 "radii_px": list(ssgi.STEP_RADII), "world_radius": defaults["world_radius"],
                 "intensity": rcfg.ssgi_intensity},
    }
    want = {
        "switches": {k: cfg["render"].get(k, False)
                     for k in ("use_clouds", "use_ssr", "use_ssgi")},
        "ssr": cfg["ssr"],
        "ssgi": cfg["ssgi"],
    }
    off = {k: (have[k], v) for k, v in want.items() if have[k] != v}
    if off:
        raise ValueError(f"the program's screen-space passes depart from the file's: {off}")
    world_sim.require_cloud_layer(cfg)


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, devices: List):
    base = combined_step.build(cfg, traffic, seed, devices)
    require_screen_space(base.fn, cfg)
    return Runner(base.fn, base.state, cfg, base.positions, base.device)


def frame_gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers of the frame state a step hands its next: the lit HDR's
    widest gap relative to max(|reference|, 1), the adapted luminance's
    widest gap, and the leaves of the previous camera that differ."""
    a, b = prog["prev_hdr"].double(), ref["prev_hdr"].double().to(prog["prev_hdr"].device)
    rel = torch.abs(a - b) / torch.clamp(torch.abs(b), min=1.0)
    return {"lit_hdr": float(torch.max(rel)),
            "avg_luminance": check._max_abs(prog["avg_luminance"], ref["avg_luminance"]),
            "view_proj_leaves": float(check.differing_leaves(
                {"prev_view_proj": prog["prev_view_proj"]},
                {"prev_view_proj": ref["prev_view_proj"]}))}


class Runner(combined_step.Runner):
    """`combined_step.Runner`, whose check also compares the frame state
    handed to the next step."""

    def check(self, initial, kept, mode: Optional[str] = None) -> List[Dict[str, float]]:
        """The numbers of each kept step: the program's output and handed-on
        frame state against the reference's from the program's input; with
        `mode`, the control (the reference in that precision) in the
        program's place."""
        with precision(None):
            ref = ref_scenes.Flagship(self.cfg, self.positions.cpu().numpy(), self.device)
        start = (check.differing_leaves(initial["physics"], ref.state0)
                 + check.differing_leaves(initial["frame"],
                                          ref.renderer.initial_frame_state())
                 + check.differing_leaves(self.fn.constants, ref.constants))
        out = []
        for prev, nxt, image in kept:
            with precision(None):
                r_state, r_mats, r_img = ref(prev)
            if mode is None:
                mats = self.fn.instance_matrices(nxt["physics"])
                got_state, got_img = nxt, image
            else:
                src = bf16_rounded(prev) if mode == "bf16" else prev
                with precision(mode):
                    got_state, mats, got_img = ref(src)
            nums = check.physics_gaps(got_state["physics"], r_state["physics"])
            nums["mats"] = float(torch.max(torch.abs(mats - r_mats)))
            nums["image_levels"] = check.image_gap(got_img, r_img)
            nums.update(frame_gaps(got_state["frame"], r_state["frame"]))
            nums["start_leaves"] = float(start)
            out.append(nums)
        return out
