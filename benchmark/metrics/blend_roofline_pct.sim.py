"""blend_roofline_pct.sim: the least time the blend-family kernels need,
over their device time, in %: K5 (the refraction pass's visibility raster,
`raster_shade_kernel<false>`), K6 (`sorted_blend_kernel`: the sorted pass
and the translucent shadow map's tint) and K7 (`oit_kernel`), found by
kernel name in the device trace, per traced step.

Least time: the larger of bytes over the card's memory bandwidth and
float32 operations over its float32 peak (`peaks.json`), from the cell's
shapes alone, each input read once and each output written once, every
pixel or texel computed once (which layers cover it depends on the data):

- triangles: box k takes materials[k % 8]; each kind's boxes, 12
  triangles each, are read once as a 64 B record (16 floats) by their
  kernel, the OIT casters once a cascade by the tint.
- K5: a pixel's depth, triangle id and two barycentrics written (16 B);
  three edges and the depth (17 operations).
- K6, sorted: a pixel's opaque depth (4 B) and HDR (12 B) read, HDR
  written (12 B); edges and depth (17) and a source-over blend of three
  channels (10).
- K6, tint: the same per atlas texel (the cascades' squares: 2048^2 +
  2 x 1024^2 = 6,291,456 texels).
- K7: a pixel's opaque depth read (4 B), its accumulation (16 B) and
  reveal (4 B) written; edges and depth (17), the depth weight (5), four
  sums (8) and the reveal (1).

At 1920x1080 with 15,360 triangles of each kind: 323.1 MB and 0.325 GFLOP
a step, bytes-bound (0.0964 ms on an H100 SXM at 700 W).
"""

from benchmark import trace

BOX_TRIS, RECORD_B = 12, 64
KERNELS = ("raster_shade_kernel<false>", "sorted_blend_kernel", "oit_kernel")
# (bytes written or read per pixel, operations per pixel)
K5_PX, K6_PX, K7_PX = (16, 17), (28, 27), (24, 31)


def counts(cfg):
    """(bytes, float32 operations) of one frame's K5, K6 (both launches)
    and K7."""
    mats = cfg["materials"]
    n_box = cfg["n_bodies"] - 1

    def tris(mode):
        return BOX_TRIS * sum(1 for k in range(n_box)
                              if mats[k % len(mats)].get("blend_mode", "opaque") == mode)
    px = cfg["width"] * cfg["height"]
    cascades = cfg["render"]["shadow"]["cascade_sizes"]
    texels = sum(s * s for s in cascades)
    t_oit, t_sorted, t_refract = tris("oit"), tris("sorted"), tris("refract")
    nbytes = (RECORD_B * (t_refract + t_sorted + t_oit * (1 + len(cascades)))
              + px * (K5_PX[0] + K6_PX[0] + K7_PX[0]) + texels * K6_PX[0])
    ops = px * (K5_PX[1] + K6_PX[1] + K7_PX[1]) + texels * K6_PX[1]
    return nbytes, ops


def kernel_device_ms(run, names):
    """Device ms per traced step of the device ops whose name contains one
    of `names`; None without a trace or such an op."""
    if not run.prof:
        return None
    ops = run.prof[0]
    ns = sum(e - s for _, s, e, name, _ in ops if any(k in name for k in names))
    return ns / 1e6 / run.traffic["trace_steps"] if ns else None


def read(run):
    device_ms = kernel_device_ms(run, KERNELS)
    peak = run.peaks.get(run.kind)
    if device_ms is None or peak is None:
        return None
    nbytes, ops = counts(run.config)
    by_bytes = nbytes / peak["bytes_per_s"] * 1e3
    by_ops = ops / peak["fp32_flop_per_s"] * 1e3
    least = max(by_bytes, by_ops)
    return {"value": 100.0 * least / device_ms,
            "bound": "bytes" if by_bytes >= by_ops else "fp32_ops",
            "least_ms": least, "device_ms": device_ms,
            "power_limit_w": run.power_limit_w}
