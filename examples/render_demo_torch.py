"""Render one deferred-PBR frame on the PyTorch port and save it as PNG.

The twin of examples/render_demo.py. It renders on the card unless --cpu
is given.

Usage: PYTHONPATH=. python examples/render_demo_torch.py [out.png] [--cpu]
"""

import sys

import numpy as np
import torch

from garden_tpu_torch.assets.images import save_png
from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import RenderConfig
from garden_tpu_torch.render import mesh as rmesh
from garden_tpu_torch.render.deferred import DeferredRenderer
from garden_tpu_torch.systems.camera import common_constants


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    out_path = next((a for a in argv if not a.startswith("--")), "frame.png")
    cfg = RenderConfig(width=640, height=384, tile_size=128,
                       max_triangles=8192, max_vertices=8192,
                       max_tris_per_tile=1280, max_instances=16)
    scene = rmesh.SceneBuffers(cfg.max_vertices, cfg.max_triangles,
                               cfg.max_instances, max_textures=2,
                               texture_size=64)
    # checkerboard base-color texture (the ResourceSystem image-load path)
    check = np.zeros((64, 64, 4), np.float32)
    check[..., 3] = 1.0
    cells = (np.add.outer(np.arange(64) // 8,
                          np.arange(64) // 8) % 2).astype(bool)
    check[cells] = (0.9, 0.9, 0.85, 1.0)
    check[~cells] = (0.15, 0.2, 0.5, 1.0)
    tex = scene.add_texture(check)
    red = scene.add_material(rmesh.Material(base_color=(1.0, 1.0, 1.0),
                                            roughness=0.35,
                                            base_texture=tex))
    gold = scene.add_material(rmesh.Material(base_color=(1.0, 0.77, 0.34),
                                             metallic=1.0, roughness=0.3))
    grey = scene.add_material(rmesh.Material(base_color=(0.45, 0.45, 0.48), roughness=0.85))
    glow = scene.add_material(rmesh.Material(base_color=(0.05, 0.05, 0.05),
                                             emissive=(3.0, 1.2, 0.2)))
    scene.add_instance(rmesh.plane_grid(40.0, 16), material=grey)
    scene.add_instance(rmesh.cube(0.5), material=red)
    scene.add_instance(rmesh.uv_sphere(0.5, 16, 32), material=gold)
    scene.add_instance(rmesh.uv_sphere(0.3, 12, 24), material=glow)
    renderer = DeferredRenderer(cfg, scene, device)
    dev = renderer.device_scene()

    mats = np.tile(np.eye(4, dtype=np.float32), (cfg.max_instances, 1, 1))
    mats[1][:3, 3] = [-1.2, 0.5, 0.0]
    mats[2][:3, 3] = [0.6, 0.5, -0.5]
    mats[3][:3, 3] = [1.8, 0.3, 0.8]

    vec = lambda *c: torch.tensor(c, dtype=torch.float32, device=device)
    eye = vec(0.0, 1.8, 4.5)
    view = m3.look_at(eye, vec(0.0, 0.4, 0.0), vec(0.0, 1.0, 0.0))
    proj = m3.perspective_reverse_z(1.0, cfg.width / cfg.height, 0.1, device=device)
    constants = common_constants(eye, view, proj, vec(0.4, -0.7, -0.5),
                                 (cfg.width, cfg.height), 0.0, 1.0 / 60.0)

    out = renderer.render(dev, torch.as_tensor(mats, device=device), constants,
                          renderer.initial_frame_state())
    img = out["image"].cpu().numpy()
    save_png(out_path, img)
    print(f"wrote {out_path} ({img.shape[1]}x{img.shape[0]}), "
          f"covered={float((out['tri_id'] >= 0).float().mean()):.2f}")
    return out


if __name__ == "__main__":
    main()
