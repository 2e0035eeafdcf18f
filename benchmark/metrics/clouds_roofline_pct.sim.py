"""clouds_roofline_pct.sim: the least time the cloud march and the cloud
shadow need, over the device time of the program's `clouds` and
`cloud_shadow` spans (`clouds_device_ms.sim`), in %.

Least time: the larger of bytes over the card's memory bandwidth and
float32 operations over its float32 peak (`peaks.json`), from the cell's
shapes alone. An operation is one elementwise arithmetic, logic, compare,
select or conversion step on one element, counted from the plain
reference (`benchmark/reference/render/clouds.py`, `ops/noise.py`):

- one density evaluation (`_density`): 3,993. Two `perlin_worley3` of
  1,449 each (`perlin3` 368: floors, fades, 8 hashed corners of 37; and
  `worley3` 1,073: 27 hashed cells of 38, their set-up and the root; 8 to
  combine), a `worley3` for the detail erosion, 32 to scale, shape and
  erode.
- the march: only the half-res rays above the horizon (mu > 0.02) need
  it, found here from the file's camera and frame size as the program
  finds them (the view rays through the pixel centres, averaged over 2x2
  blocks and normalized). A ray takes `steps` steps of three density
  evaluations (the sample and two taps toward the sun) and 48 more, and
  69 for its set-up, phase, tints, fade and the composite over the sky;
  it reads its direction and the sky (24 B) and writes the sky (12 B).
- the shadow: every half-res pixel, two density evaluations and 17 more;
  each pixel reads its position (12 B) and the shadow factor (12 B) and
  writes the factor (12 B), 12 operations to decimate, upsample and apply.

At 1920x1080 with the world sim's camera: 279,996 of 518,400 rays up,
33.69 GFLOP for the march and 4.15 GFLOP for the shadow a step,
operations-bound (0.565 ms on an H100 SXM at 700 W).
"""

import math

from benchmark import trace

OPS_DENSITY = 3993
OPS_STEP = 3 * OPS_DENSITY + 48
OPS_RAY = 69
OPS_SHADOW = 2 * OPS_DENSITY + 17
OPS_SHADOW_PX = 12
RAY_B, SHADOW_PX_B = 36, 36


def _sub(a, b):
    return [x - y for x, y in zip(a, b)]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _unit(a):
    n = math.sqrt(sum(x * x for x in a))
    return [x / n for x in a]


def rays_up(cfg) -> int:
    """The half-res view rays of the file's camera whose direction points
    more than 0.02 above the horizon."""
    import numpy as np
    cam, w, h = cfg["camera"], cfg["width"], cfg["height"]
    fwd = _unit(_sub(cam["target"], cam["eye"]))
    right = _unit(_cross(fwd, [0.0, 1.0, 0.0]))
    up = _cross(right, fwd)
    ty = math.tan(cam["fov_y_rad"] / 2.0)
    tx = ty * w / h
    x = ((np.arange(w) + 0.5) / w * 2.0 - 1.0)[None, :, None] * tx
    y = (1.0 - (np.arange(h) + 0.5) / h * 2.0)[:, None, None] * ty
    d = np.asarray(fwd) + x * np.asarray(right) + y * np.asarray(up)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d[:h & ~1, :w & ~1]
    half = (d[0::2, 0::2] + d[0::2, 1::2] + d[1::2, 0::2] + d[1::2, 1::2]) * 0.25
    half /= np.linalg.norm(half, axis=-1, keepdims=True)
    return int((half[..., 1] > 0.02).sum())


def counts(cfg):
    """(bytes, float32 operations) of one frame's cloud march and shadow."""
    n_up = rays_up(cfg)
    half_px = (cfg["height"] // 2) * (cfg["width"] // 2)
    px = cfg["width"] * cfg["height"]
    steps = cfg["clouds"]["steps"]
    ops = (n_up * (steps * OPS_STEP + OPS_RAY) + half_px * OPS_SHADOW
           + px * OPS_SHADOW_PX)
    return n_up * RAY_B + px * SHADOW_PX_B, ops


def read(run):
    device_ms = trace.stage_device_ms(run, ["clouds", "cloud_shadow"])
    peak = run.peaks.get(run.kind)
    if device_ms is None or peak is None:
        return None
    nbytes, ops = counts(run.config)
    by_bytes = nbytes / peak["bytes_per_s"] * 1e3
    by_ops = ops / peak["fp32_flop_per_s"] * 1e3
    least = max(by_bytes, by_ops)
    return {"value": 100.0 * least / device_ms,
            "bound": "bytes" if by_bytes >= by_ops else "fp32_ops",
            "least_ms": least, "device_ms": device_ms, "rays_up": rays_up(run.config),
            "power_limit_w": run.power_limit_w}
