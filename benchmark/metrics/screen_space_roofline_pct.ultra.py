"""screen_space_roofline_pct.ultra: the least time the SSR march and the SSGI
gather need, over the device time of the program's `ssr` and `ssgi` spans
(`screen_space_device_ms.ultra`), in %.

Least time: the larger of bytes over the card's memory bandwidth and
float32 operations over its float32 peak (`peaks.json`), from the cell's
shapes alone, so that any design of the two passes is judged on the same
work. An operation is one elementwise arithmetic, logic, compare, select
or conversion step on one element (a clamp to both bounds two, a gather,
slice, pad or concatenation none), counted from the plain reference
(`benchmark/reference/render/ssr.py`, `ssgi.py`, `ops/blur.py`; a `dot` 5,
a `normalize` 10, a `reflect` 12, a 4x4 projection 28):

- SSR, at the trace resolution (a `trace_step` of 4: 480x270 rays): the
  2x2 decimations of position, normal, depth and roughness, 8 channels of
  4 operations each level; a ray's set-up (view vector, normals,
  reflection) 38; each of `steps` march samples 88 (the point 6, its
  projection 28, the divide to texels 11, the screen test 9, the texel
  index 9, the depth test 9, the first-hit mask 6, the hit's sums 10);
  the reprojection of the hit 53 and the confidence 28; the depth-guided
  upsample of colour and confidence to full size 91 a pixel, 2 to clamp
  the confidence and 1 to mask it by visibility.
- SSGI, at half resolution (960x540): the decimations 32, the visibility's
  conversion (a full pixel) and test; the reprojection gather 51; each of
  the 8 x 3 taps 41
  (the sender vector, its length and direction, two Lambert terms, the
  falloff, the weight and the sum); 6 to scale and mask; the upsample 78 a
  full pixel.
- bytes: each plane read once and written once at its resolution, the
  planes both passes read counted once: position, normal, depth,
  roughness and visibility at full size (33 B a pixel), the previous
  frame's lit HDR at one texel a ray and a GI pixel (12 B), and the
  reflection colour, its confidence and the GI written at full size (28 B
  a pixel).

At 1920x1080: 1.134 G operations and 134.3 MB a step, bytes-bound
(0.0401 ms on an H100 SXM at 700 W).
"""

from benchmark import trace

OPS_DOT, OPS_NORMALIZE, OPS_REFLECT, OPS_PROJECT = 5, 10, 12, 28
DECIMATE_OPS = 4                        # three adds and a scale, a channel
SSR_CHANNELS = 8                        # position 3, normal 3, depth, roughness
SSR_RAY_SETUP = 3 + OPS_NORMALIZE + 3 + OPS_NORMALIZE + OPS_REFLECT
SSR_SAMPLE = 6 + OPS_PROJECT + 1 + 4 + 3 + 3 + 9 + 6 + 3 + 1 + 8 + 5 + 1 + 6 + 2 + 2
SSR_REPROJECT = OPS_PROJECT + 1 + 2 + 3 + 3 + 7 + 6 + 3
SSR_CONFIDENCE = 3 + 3 + 3 + 4 + (OPS_DOT + 1) + 5 + 4
SSGI_CHANNELS = 8                       # position 3, normal 3, depth, visibility
SSGI_REPROJECT = 6 + 2 + 10 + 10 + 9 + 6 + 3 + 4 + 1
SSGI_TAP = 3 + OPS_DOT + 1 + 1 + 3 + (OPS_DOT + 1) + (3 + OPS_DOT + 1) + 4 + 3 + 6
SSGI_FINISH = 6


def upsample_ops(channels: int) -> int:
    """Operations a full-size pixel of `ops/blur.bilateral_upsample_to`:
    the guide's scale 2, six taps of a weight (5) and its sums (2 C + 1),
    the clamped division 1 + C."""
    return 2 + 6 * (5 + 2 * channels + 1) + 1 + channels


def counts(cfg):
    """(bytes, float32 operations) of one frame's SSR march and SSGI gather."""
    w, h = cfg["width"], cfg["height"]
    full = w * h
    ssr, gi = cfg["ssr"], cfg["ssgi"]
    step = ssr["trace_step"]
    levels = step.bit_length() - 1
    rays = (h // step) * (w // step)
    decimated = sum((h >> k) * (w >> k) for k in range(1, levels + 1))
    ssr_ops = (decimated * SSR_CHANNELS * DECIMATE_OPS
               + rays * (SSR_RAY_SETUP + ssr["steps"] * SSR_SAMPLE + SSR_REPROJECT
                         + SSR_CONFIDENCE)
               + full * (upsample_ops(4) + 2 + 1))
    half = (h // 2) * (w // 2) if gi["half_res"] else full
    taps = gi["directions"] * len(gi["radii_px"])
    gi_ops = (full + half * (SSGI_CHANNELS * DECIMATE_OPS + 1 + SSGI_REPROJECT
                             + taps * SSGI_TAP + SSGI_FINISH)
              + (full * upsample_ops(3) if gi["half_res"] else 0))
    nbytes = full * (33 + 28) + (rays + half) * 12
    return nbytes, ssr_ops + gi_ops


def read(run):
    device_ms = trace.stage_device_ms(run, ["ssr", "ssgi"])
    peak = run.peaks.get(run.kind)
    if device_ms is None or peak is None:
        return None
    nbytes, ops = counts(run.config)
    by_bytes = nbytes / peak["bytes_per_s"] * 1e3
    by_ops = ops / peak["fp32_flop_per_s"] * 1e3
    least = max(by_bytes, by_ops)
    return {"value": 100.0 * least / device_ms,
            "bound": "bytes" if by_bytes >= by_ops else "fp32_ops",
            "least_ms": least, "device_ms": device_ms, "bytes": nbytes, "ops": ops,
            "power_limit_w": run.power_limit_w}
