"""Flagship demo on the PyTorch port: procedural terrain + falling bodies +
deferred-PBR frames, dumping frames and G-buffer debug views.

The twin of examples/full_demo.py: the same worldgen, physics and render
stack, as plain PyTorch on the card (or on the CPU with --cpu).

Usage: PYTHONPATH=. python examples/full_demo_torch.py [out_dir] [--cpu] [--frames N] [--debug]
"""

import os
import sys
import time

import numpy as np
import torch

from garden_tpu_torch.assets.images import save_png
from garden_tpu_torch.core import math3d as m3
from garden_tpu_torch.core.config import PhysicsConfig, RenderConfig
from garden_tpu_torch.ops import noise
from garden_tpu_torch.physics import world as pw
from garden_tpu_torch.render import mesh as rmesh
from garden_tpu_torch.render.deferred import DeferredRenderer
from garden_tpu_torch.systems.camera import common_constants
from garden_tpu_torch.utils.debug_view import (dump_debug_sheet, dump_gbuffer,
                                               dump_physics_top_view)


def main(argv=None):
    """Runs the demo; returns {"frames", "finite" (per frame, the HDR),
    "written" (the debug dumps), "seconds", "last" (the last frame's render
    inputs: renderer, device scene, instance matrices, constants)}."""
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    args = [a for a in argv if not a.startswith("--")]
    frames = 24
    if "--frames" in argv:
        frames = int(argv[argv.index("--frames") + 1])
        args.remove(argv[argv.index("--frames") + 1])
    out_dir = args[0] if args else "demo_frames"
    os.makedirs(out_dir, exist_ok=True)

    # worldgen: noise heightfield terrain (config 2)
    hm = noise.terrain_heightmap(24, world_scale=0.08, height_scale=2.0,
                                 device=device).cpu().numpy()
    terrain = rmesh.heightfield(hm, cell=1.5)

    pcfg = PhysicsConfig(max_bodies=128, grid_dim=32, cell_size=2.0)
    w = pw.PhysicsWorld(pcfg)
    # bodies collide with the same heightfield the renderer draws
    w.add_body(w.shapes.heightfield(hm, cell=1.5), motion=pw.STATIC)
    box = w.shapes.box((0.4, 0.4, 0.4))
    sph = w.shapes.sphere(0.4)
    rng = np.random.default_rng(3)
    n_dyn = 60
    for i in range(n_dyn):
        w.add_body(box if i % 2 == 0 else sph,
                   position=(rng.uniform(-6, 6), 4.0 + i * 0.7,
                             rng.uniform(-6, 6)),
                   friction=0.5, restitution=0.2)

    rcfg = RenderConfig(width=640, height=384, tile_size=128,
                        max_triangles=8192, max_vertices=8192,
                        max_tris_per_tile=256, max_instances=n_dyn + 2,
                        use_clouds=True)
    scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles,
                               rcfg.max_instances)
    ground_mat = scene.add_material(rmesh.Material(base_color=(0.35, 0.4, 0.3),
                                                   roughness=0.9))
    mats_ids = [
        scene.add_material(rmesh.Material(base_color=(0.8, 0.2, 0.15), roughness=0.4)),
        scene.add_material(rmesh.Material(base_color=(0.9, 0.7, 0.3),
                                          metallic=1.0, roughness=0.35)),
        scene.add_material(rmesh.Material(base_color=(0.2, 0.4, 0.8), roughness=0.5)),
    ]
    scene.add_instance(terrain, material=ground_mat)
    for i in range(n_dyn):
        m = mats_ids[i % 3]
        scene.add_instance(rmesh.cube(0.4) if i % 2 == 0 else rmesh.uv_sphere(0.4, 8, 12),
                           material=m)
    renderer = DeferredRenderer(rcfg, scene, device)
    dev_scene = renderer.device_scene()

    vec = lambda *c: torch.tensor(c, dtype=torch.float32, device=device)
    eye = vec(0.0, 7.0, 16.0)
    view = m3.look_at(eye, vec(0.0, 1.0, 0.0), vec(0.0, 1.0, 0.0))
    proj = m3.perspective_reverse_z(1.0, rcfg.width / rcfg.height, 0.1, device=device)
    types = w.shapes.present_types()
    eye4 = torch.eye(4, device=device)

    def frame(phys, fstate, t):
        for _ in range(2):  # 2 physics substeps per frame
            phys = pw.step(phys, pcfg, 1.0 / 60.0, types)
        pos, quat = phys["bodies"]["pos"], phys["bodies"]["quat"]
        inst = m3.compose_trs(pos[: n_dyn + 2], quat[: n_dyn + 2],
                              torch.ones((n_dyn + 2, 3), device=device))
        # instance i+1 renders body i+1; instance 0 is the terrain
        inst_render = torch.cat([eye4[None], inst[1:]], dim=0)
        constants = common_constants(eye, view, proj, vec(0.4, -0.7, -0.5),
                                     (rcfg.width, rcfg.height), t, 1.0 / 30.0)
        out = renderer.render(dev_scene, inst_render, constants, fstate)
        return phys, out, (renderer, dev_scene, inst_render, constants)

    phys = w.device_state(device)
    fstate = renderer.initial_frame_state()
    finite = []
    t0 = time.perf_counter()
    for i in range(frames):
        phys, out, last = frame(phys, fstate, i / 30.0)
        fstate = out["frame_state"]
        finite.append(bool(torch.isfinite(out["hdr"].float()).all()))
        save_png(os.path.join(out_dir, f"frame_{i:03d}.png"), out["image"].cpu().numpy())
    dt = time.perf_counter() - t0
    print(f"{frames} frames in {dt:.1f}s ({frames/dt:.1f} fps incl host IO)")
    written = dump_gbuffer(out, out_dir, "debug")
    dump_physics_top_view(phys, os.path.join(out_dir, "physics_top.png"))
    written.append(os.path.join(out_dir, "physics_top.png"))
    if "--debug" in argv:
        # the full observability sheet (utils/debug_view.py): G-buffer
        # contact sheet, draw/contact counters, per-pass stats
        report = dump_debug_sheet(out, phys, None, out_dir)
        print("debug stats:", report)
    print(f"wrote {out_dir}/")
    return {"frames": frames, "finite": finite, "written": written, "seconds": dt,
            "last": last}


if __name__ == "__main__":
    main()
