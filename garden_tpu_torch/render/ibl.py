"""The environment BRDF of the split-sum specular ambient.

Port of the two functions of `garden_tpu.render.ibl` that the lighting
resolve needs: Lazarov's analytic fit of the DFG term and its application
to F0. The environment-map path (prefiltered lat-long chains, SH of a map)
is not ported (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def dfg_approx(nov: Tensor, roughness: Tensor) -> Tuple[Tensor, Tensor]:
    """Analytic environment-BRDF (scale, bias) for F0 (Lazarov 2013)."""
    r0 = roughness * -1.0 + 1.0
    r1 = roughness * -0.0275 + 0.0425
    r2 = roughness * -0.572 + 1.04
    r3 = roughness * 0.022 - 0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    scale = -1.04 * a004 + r2
    bias = 1.04 * a004 + r3
    return scale, bias


def specular_env_brdf(f0: Tensor, nov: Tensor, roughness: Tensor) -> Tensor:
    """Split-sum weight of the environment sample: f0 * scale + bias."""
    scale, bias = dfg_approx(nov, roughness)
    return f0 * scale[..., None] + bias[..., None]
