"""raster_roofline_pct.play: the least time the main raster and the shadow
atlas need, over their device time, in %.

Device time: the kernels and copies launched inside the port's `raster` and
`csm_render` ranges, per traced step. Least time: the larger of bytes over
the card's memory bandwidth and float32 operations over its float32 peak
(`peaks.json`). Both counts come from the cell's shapes alone, each input
read once and each output written once, so the reading is the same work
whatever implements the stage:

- main raster: every vertex's position and normal (24 B) and instance id
  (4 B), every triangle's indices (12 B), every instance's matrix (64 B)
  read; per pixel depth, triangle id, normal, base colour, roughness and
  metallic (40 B) written. Operations: a vertex's clip transform (28) and
  normal transform (15), a triangle's setup (30), a pixel's three edges,
  depth and normal interpolation (32).
- shadow atlas: every vertex's position (12 B) and instance id (4 B), the
  indices and the matrices read; every atlas texel's depth (4 B) written.
  Operations: each cascade's transform of every vertex (28), a texel's
  three edges and depth (17).

The scene: a plane_grid ground (25 vertices, 32 triangles) and n_bodies - 1
boxes (24 vertices, 12 triangles each); the atlas holds one square per
cascade.
"""

from benchmark import trace

BOX_VERTS, BOX_TRIS, GROUND_VERTS, GROUND_TRIS = 24, 12, 25, 32


def counts(cfg):
    """(bytes, float32 operations) of one main raster and shadow atlas."""
    n_box = cfg["n_bodies"] - 1
    v = n_box * BOX_VERTS + GROUND_VERTS
    t = n_box * BOX_TRIS + GROUND_TRIS
    inst = cfg["n_bodies"]
    px = cfg["width"] * cfg["height"]
    shadow = cfg["render"]["shadow"]
    cascades = (shadow.get("cascade_sizes")
                or [shadow.get("map_size", 2048)] * shadow.get("cascade_count", 3))
    texels = sum(s * s for s in cascades)
    main_bytes = v * 28 + t * 12 + inst * 64 + px * 40
    shadow_bytes = v * 16 + t * 12 + inst * 64 + texels * 4
    main_ops = v * (28 + 15) + t * 30 + px * 32
    shadow_ops = len(cascades) * v * 28 + texels * 17
    return main_bytes + shadow_bytes, main_ops + shadow_ops


def read(run):
    device_ms = trace.stage_device_ms(run, ["raster", "csm_render"])
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
