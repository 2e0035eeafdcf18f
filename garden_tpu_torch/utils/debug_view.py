"""Debug visualizers: G-buffer channels, shadow cascades, physics shapes.

Rebuild of the editor's inspection surfaces (reference layer 9: the
gbuffer-data visualizer, shadow-cascade view and physics shape renderer,
include/garden/editor/**) as host-side image dumps — the observability
returns without an in-engine UI (SURVEY.md section 7 'What we deliberately
do NOT rebuild').

A copy of `garden_tpu.utils.debug_view` over the port's frame outputs
(`DeferredRenderer.render`) and physics state: each function takes tensors
on any device (or numpy arrays) and moves each one it reads to numpy once
(`host`); the PNG bytes and the stats are the reference's on the same
values.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from garden_tpu_torch.assets.images import save_png
from garden_tpu_torch.utils import profiler


def host(tree):
    """Nested dicts of tensors -> the same tree of numpy arrays (bfloat16
    widened to float32); numpy arrays and other leaves pass through."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return tree


def _save(img: np.ndarray, path: str) -> None:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:   # (H, W, 1) single channel
        img = img[..., 0]
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    save_png(path, img)      # PIL where present, else the port's own PNG writer


def dump_gbuffer(out: Dict, directory: str, prefix: str = "frame") -> list:
    """Save G-buffer channels of a DeferredRenderer output as PNGs
    (the gbuffer-data editor visualizer)."""
    os.makedirs(directory, exist_ok=True)
    out = host(out)
    g = out["gbuffer"]
    written = []

    def w(name, img):
        p = os.path.join(directory, f"{prefix}_{name}.png")
        _save(img, p)
        written.append(p)

    w("image", np.asarray(out["image"]))
    depth = np.asarray(out["depth"])
    w("depth", depth / max(depth.max(), 1e-6))
    w("normal", np.asarray(g["normal"]) * 0.5 + 0.5)
    w("base_color", np.asarray(g["base_color"]))
    w("roughness", np.asarray(g["roughness"]))
    w("metallic", np.asarray(g["metallic"]))
    w("visible", np.asarray(g["visible"]).astype(np.float32))
    if out.get("shadow") is not None:
        w("shadow", np.asarray(out["shadow"]))
    if out.get("ao") is not None:
        w("ao", np.asarray(out["ao"]))
    return written


def dump_physics_top_view(state: Dict, path: str, size: int = 512,
                          world_extent: float = 24.0) -> None:
    """Top-down scatter of body positions colored by speed (the physics
    shape renderer's role, editor physics debug)."""
    b = host(state["bodies"])
    pos = np.asarray(b["pos"])
    has = np.asarray(b["has"])
    vel = np.linalg.norm(np.asarray(b["linvel"]), axis=-1)
    img = np.zeros((size, size, 3), np.float32)
    scale = size / (2 * world_extent)
    for i in np.nonzero(has)[0]:
        x = int((pos[i, 0] + world_extent) * scale)
        z = int((pos[i, 2] + world_extent) * scale)
        if 0 <= x < size and 0 <= z < size:
            speed = min(vel[i] / 10.0, 1.0)
            img[z, x] = (speed, 1.0 - speed, 0.2)
    _save(img, path)


def contact_sheet(out: Dict, path: str, cols: int = 4) -> None:
    """ONE image tiling every G-buffer/aux channel with a caption strip —
    the editor's gbuffer-data visualizer as a single glanceable sheet
    (source/editor/** gbuffer visualizer role)."""
    out = host(out)
    g = out["gbuffer"]
    depth = np.asarray(out["depth"])
    panels = [
        ("image", np.asarray(out["image"]).astype(np.float32) / 255.0),
        ("depth", depth / max(depth.max(), 1e-6)),
        ("normal", np.asarray(g["normal"]) * 0.5 + 0.5),
        ("base_color", np.asarray(g["base_color"])),
        ("roughness", np.asarray(g["roughness"])),
        ("metallic", np.asarray(g["metallic"])),
        ("visible", np.asarray(g["visible"]).astype(np.float32)),
    ]
    for key in ("shadow", "ao", "velocity", "disocclusion", "trans_depth"):
        if out.get(key) is not None:
            img = np.asarray(out[key]).astype(np.float32)
            if key == "velocity":
                img = np.concatenate(
                    [np.abs(img) * 0.1, np.zeros(img.shape[:2] + (1,))], -1)
            panels.append((key, img))

    h, w = panels[0][1].shape[:2]
    sheet_rows = -(-len(panels) // cols)
    sheet = np.zeros((sheet_rows * h, cols * w, 3), np.float32)
    for i, (name, img) in enumerate(panels):
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        r, c = divmod(i, cols)
        sheet[r * h:(r + 1) * h, c * w:(c + 1) * w] = np.clip(
            img[:h, :w, :3], 0.0, 1.0)
        # caption: a small brightness tag strip (index bits) top-left
        sheet[r * h:r * h + 6, c * w:c * w + 6 * (i + 1):2] = 1.0
    _save(sheet, path)


def dump_cascade_atlas(depth_atlas, path: str) -> None:
    """Shadow cascade-atlas view (the editor's shadow-cascade visualizer):
    reverse-Z depth normalized per non-zero range."""
    d = np.asarray(host(depth_atlas))
    lo = d[d > 0].min() if (d > 0).any() else 0.0
    hi = d.max() if d.max() > 0 else 1.0
    vis = np.where(d > 0, (d - lo) / max(hi - lo, 1e-6) * 0.9 + 0.1, 0.0)
    _save(vis, path)


def render_stats(out: Dict, scene: Dict = None) -> Dict[str, int]:
    """Draw-statistics counters (mesh.cpp:530-546: total vs drawn):
    triangle totals, binned-visible triangles, covered pixels."""
    tri_id = np.asarray(host(out["tri_id"]))
    covered = tri_id >= 0
    stats = {
        "pixels": int(tri_id.size),
        "pixels_covered": int(covered.sum()),
        "triangles_visible": int(np.unique(tri_id[covered]).size),
    }
    if scene is not None and "tri_valid" in scene:
        stats["triangles_total"] = int(np.asarray(host(scene["tri_valid"])).sum())
    return stats


def physics_stats(state: Dict) -> Dict[str, int]:
    """Jolt-style phase stats (physics.cpp:1195-1211: body/contact
    counts): alive, active, sleeping bodies and live contact count."""
    state = host(state)
    b = state["bodies"]
    has = np.asarray(b["has"])
    stats = {
        "bodies_alive": int(has.sum()),
        "bodies_active": int((has & np.asarray(b.get("active", has))).sum()),
    }
    if "sleep" in b:
        stats["bodies_sleeping"] = int((has & np.asarray(b["sleep"])).sum())
    if "contacts" in state and "valid" in state["contacts"]:
        stats["contacts"] = int(np.asarray(state["contacts"]["valid"]).sum())
    return stats


def dump_debug_sheet(out: Dict, state: Optional[Dict], spans: Optional[List[Dict]],
                     directory: str, scene: Dict = None) -> Dict:
    """The full `--debug` dump: contact sheet + cascade atlas + stats text
    + per-pass ms table, the mean host ms of each span name in `spans`
    (`utils.profiler.recorded()`), where given (editor observability
    parity, SURVEY.md section 7)."""
    os.makedirs(directory, exist_ok=True)
    out, state = host(out), host(state)
    contact_sheet(out, os.path.join(directory, "gbuffer_sheet.png"))
    report = {"render": render_stats(out, scene)}
    if state is not None:
        report["physics"] = physics_stats(state)
        dump_physics_top_view(
            state, os.path.join(directory, "physics_top.png"))
    if spans is not None:
        report["passes_ms"] = "\n".join(
            f"  {name}: {ms:.2f} ms" for name, ms in sorted(profiler.host_ms(spans).items()))
    with open(os.path.join(directory, "stats.txt"), "w") as f:
        for k, v in report.items():
            f.write(f"[{k}]\n{v}\n\n")
    write_html_index(directory)
    return report


def write_html_index(directory: str, title: str = "garden-tpu debug") -> str:
    """Self-contained index.html over a debug-dump directory: every PNG the
    dumps produced plus stats.txt, viewable in any browser (the honest
    80/20 of the reference's interactive editor inspectors, reference
    layer 9 / editor/** — serve with `garden_tpu_torch debugview <dir> --serve`).
    Regenerable at any time from whatever files are present."""
    pngs = sorted(f for f in os.listdir(directory) if f.endswith(".png"))
    stats_path = os.path.join(directory, "stats.txt")
    stats = ""
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = f.read()
    cards = "\n".join(
        f'<figure><img src="{p}" loading="lazy"/>'
        f"<figcaption>{p}</figcaption></figure>" for p in pngs)
    html = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font: 14px system-ui; background: #14161a; color: #d7dae0;
       margin: 2rem; }}
h1 {{ font-size: 1.2rem; }}
.grid {{ display: grid; grid-template-columns: repeat(auto-fill,
         minmax(420px, 1fr)); gap: 1rem; }}
figure {{ margin: 0; background: #1d2026; padding: .5rem;
          border-radius: 8px; }}
img {{ width: 100%; image-rendering: pixelated; border-radius: 4px; }}
figcaption {{ color: #8b93a3; padding-top: .3rem; font-size: .85rem; }}
pre {{ background: #1d2026; padding: 1rem; border-radius: 8px;
      overflow-x: auto; }}
</style></head><body>
<h1>{title}</h1>
<pre>{stats}</pre>
<div class="grid">
{cards}
</div></body></html>
"""
    path = os.path.join(directory, "index.html")
    with open(path, "w") as f:
        f.write(html)
    return path
