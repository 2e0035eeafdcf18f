"""Standalone CLI tools over the asset pipeline.

The reference ships its asset tooling as command-line binaries (layer-10
CLI tools: equi2cube + the pack/json utilities of the cfnptr submodules,
and modelc for geometry baking — SURVEY.md section 2.3). Here the same
operations are argparse subcommands over the library functions:

    python -m garden_tpu_torch equi2cube sky.hdr out_dir --size 256
    python -m garden_tpu_torch modelc scene.glb baked.npz
    python -m garden_tpu_torch json2bson config.json config.bson
    python -m garden_tpu_torch bson2json config.bson config.json
    python -m garden_tpu_torch pack create bundle.pack assets/
    python -m garden_tpu_torch pack list bundle.pack
    python -m garden_tpu_torch pack extract bundle.pack textures/wood.png out/
    python -m garden_tpu_torch scene demo.scene --preview out.png [--cpu]
    python -m garden_tpu_torch debugview dump_dir [--serve PORT]

The port of `garden_tpu.cli`. `equi2cube` and the scene preview compute on
the card unless the caller asks for the CPU (`main(argv, device="cpu")`,
or `scene --cpu`); the preview renders through the port's
`DeferredRenderer`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _cmd_equi2cube(args) -> int:
    import numpy as np
    import torch

    from garden_tpu_torch.assets import images
    from garden_tpu_torch.ops.cubemap import equi_to_cube

    path = args.input
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        equi = images.load_hdr(path)
    elif ext == ".exr":
        equi = images.load_exr(path)
    else:
        equi = images.load_image(path, linearize=True)[..., :3]
    cube = equi_to_cube(torch.as_tensor(np.asarray(equi, np.float32),
                                         device=args.device),
                        args.size).cpu().numpy()        # (6, S, S, 3)
    os.makedirs(args.out_dir, exist_ok=True)
    names = ["px", "nx", "py", "ny", "pz", "nz"]
    base = os.path.splitext(os.path.basename(path))[0]
    for i, face in enumerate(names):
        out = os.path.join(args.out_dir, f"{base}_{face}")
        if args.float:
            np.save(out + ".npy", cube[i])
        else:
            ldr = (np.clip(cube[i] / (1.0 + cube[i]), 0, 1) ** (1 / 2.2))
            images.save_png(out + ".png", (ldr * 255).astype(np.uint8))
    print(f"wrote 6 faces to {args.out_dir}")
    return 0


def _cmd_modelc(args) -> int:
    """Bake glTF/GLB/OBJ geometry into a renderer-ready .npz (the modelc
    role: one decode at build time, zero parsing at load time)."""
    import numpy as np

    ext = os.path.splitext(args.input)[1].lower()
    if ext in (".gltf", ".glb"):
        from garden_tpu_torch.assets.gltf import load_gltf
        meshes = load_gltf(args.input)
    elif ext == ".obj":
        from garden_tpu_torch.assets.model import load_obj
        meshes = [load_obj(args.input)]
    else:
        print(f"unsupported model format: {ext}", file=sys.stderr)
        return 2
    arrays = {}
    for i, m in enumerate(meshes):
        arrays[f"mesh{i}_positions"] = m.positions
        arrays[f"mesh{i}_normals"] = m.normals
        arrays[f"mesh{i}_uvs"] = m.uvs
        arrays[f"mesh{i}_indices"] = m.indices
    np.savez_compressed(args.output, count=len(meshes), **arrays)
    tris = sum(int(m.indices.shape[0]) for m in meshes)
    print(f"baked {len(meshes)} meshes, {tris} triangles -> {args.output}")
    return 0


def _cmd_json2bson(args) -> int:
    from garden_tpu_torch.assets import bson
    bson.json2bson(args.input, args.output)
    print(f"{args.input} -> {args.output}")
    return 0


def _cmd_bson2json(args) -> int:
    from garden_tpu_torch.assets import bson
    bson.bson2json(args.input, args.output)
    print(f"{args.input} -> {args.output}")
    return 0


def _cmd_pack(args) -> int:
    from garden_tpu_torch.assets.pack import PackReader, PackWriter

    if args.action == "create":
        w = PackWriter(args.pack)
        root = args.source or args.name
        if not root:
            print("pack create needs a source directory", file=sys.stderr)
            return 2
        n = 0
        for dirpath, _, files in os.walk(root):
            for fn in sorted(files):
                full = os.path.join(dirpath, fn)
                name = os.path.relpath(full, root).replace(os.sep, "/")
                w.add_file(name, full)
                n += 1
        w.finish()
        print(f"packed {n} items -> {args.pack}")
        return 0
    r = PackReader(args.pack)
    if args.action == "list":
        for name in r.names():
            print(name)
        return 0
    if args.action == "extract":
        data = r.read(args.name)
        out = os.path.join(args.dest or ".", args.name)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "wb") as f:
            f.write(data)
        print(f"{args.name}: {len(data)} bytes -> {out}")
        return 0
    return 2


def _cmd_scene(args) -> int:
    """Validate + pretty-print a .scene JSON (round-trip through the
    serializer's JSON layer); with --preview, render the scene's collider
    geometry through the deferred renderer to a PNG (the editor-viewport
    80/20: reference editor/** physics-shape renderer)."""
    with open(args.input) as f:
        doc = json.load(f)
    ents = doc.get("entities", [])
    systems = set()
    for e in ents:
        systems.update(k for k in e if k != "uid")
    print(f"{args.input}: {len(ents)} entities, "
          f"components: {', '.join(sorted(systems)) or '(none)'}")
    if args.preview:
        _scene_preview(doc, args.preview, args.width, args.height,
                       "cpu" if args.cpu else args.device)
        print(f"preview -> {args.preview}")
    return 0


def _scene_preview(doc, out_path: str, width: int, height: int,
                   device) -> None:
    """Render `preview_frame`'s frame and save it as a PNG."""
    from garden_tpu_torch.utils.debug_view import _save
    renderer, scene, mats, constants = preview_frame(doc, width, height, device)
    out = renderer.render(scene, mats, constants, renderer.initial_frame_state())
    _save(out["image"].cpu().numpy(), out_path)


def preview_frame(doc, width: int, height: int, device):
    """The inputs of one deferred-PBR frame of a .scene's rigidbody shapes:
    (DeferredRenderer, device scene, instance matrices, camera constants).

    Scenes carry collider geometry (scene.py rigidbody serializer), which
    is exactly what the reference's editor viewport draws for physics
    inspection; visual-only model components are resource references and
    out of scope for a one-shot preview. Colors encode motion type
    (static grey / dynamic orange / kinematic blue, sensor translucent-
    green convention rendered opaque). A compound child keeps its parent's
    rotation, as in the reference (a coarse fold, copied as it is)."""
    import numpy as np
    import torch
    from garden_tpu_torch.core import math3d as m3
    from garden_tpu_torch.core.config import RenderConfig
    from garden_tpu_torch.render import mesh as rmesh
    from garden_tpu_torch.render.deferred import DeferredRenderer
    from garden_tpu_torch.systems.camera import common_constants

    def quat_mat(q):
        x, y, z, w = [float(v) for v in q]
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)

    items = []      # (mesh, world 4x4, motion)
    cam = None      # (eye, rot3, fov, near)

    def add_shape(d, pos, rot, scale, motion):
        st = d.get("shapeType", "box")
        extra = np.zeros(3, np.float32)
        if st == "sphere":
            mesh = rmesh.uv_sphere(1.0, 12, 24)
            s = np.full(3, d.get("radius", 0.5), np.float32)
        elif st == "capsule":
            # preview stand-in: sphere stretched to the capsule extents
            mesh = rmesh.uv_sphere(1.0, 12, 24)
            r, hh = d.get("radius", 0.3), d.get("halfHeight", 0.5)
            s = np.array([r, hh + r, r], np.float32)
        elif st == "plane":
            mesh = rmesh.plane_grid(40.0, 8, y=-d.get("distance", 0.0))
            s = np.ones(3, np.float32)
        elif st == "heightfield":
            mesh = rmesh.heightfield(
                np.asarray(d["heights"], np.float32), d.get("cellSize", 1.0))
            s = np.ones(3, np.float32)
        elif st == "hull":
            pts = np.asarray(d["points"], np.float32)
            lo, hi = pts.min(0), pts.max(0)     # bbox stand-in
            mesh = rmesh.cube(0.5)
            s = (hi - lo).astype(np.float32)
            extra = ((hi + lo) * 0.5).astype(np.float32)
        elif st == "compound":
            for kid in d.get("children", []):
                kpos = np.asarray(kid.get("position", (0, 0, 0)), np.float32)
                krot = kid.get("rotation", (0, 0, 0, 1))
                r3 = quat_mat(rot)
                add_shape(kid, pos + r3 @ (kpos * scale),
                          rot, scale, motion)   # child rot folded coarsely
            return
        else:  # box
            mesh = rmesh.cube(0.5)
            s = 2.0 * np.asarray(d.get("halfExtent", (0.5,) * 3), np.float32)
        r3 = quat_mat(rot)
        mat = np.eye(4, dtype=np.float32)
        mat[:3, :3] = r3 @ np.diag(s * np.asarray(scale, np.float32))
        mat[:3, 3] = pos + r3 @ (extra * scale)
        items.append((mesh, mat, d.get("motionType", "dynamic")))

    for e in doc.get("entities", []):
        t = e.get("transform", {})
        pos = np.asarray(t.get("position", (0, 0, 0)), np.float32)
        rot = t.get("rotation", (0, 0, 0, 1))
        scale = t.get("scale", (1, 1, 1))
        if "rigidbody" in e:
            add_shape(e["rigidbody"], pos, rot, scale, None)
        if "camera" in e and cam is None:
            c = e["camera"]
            cam = (pos, quat_mat(rot),
                   c.get("fieldOfView", 0.9), c.get("nearPlane", 0.1))

    if not items:
        raise SystemExit("scene preview: no rigidbody shapes to draw")

    n_tris = sum(m.indices.shape[0] for m, _, _ in items)
    n_verts = sum(m.positions.shape[0] for m, _, _ in items)
    pow2 = lambda v: 1 << max(int(np.ceil(np.log2(max(v, 64)))), 6)
    cfg = RenderConfig(width=width, height=height, tile_size=128,
                       max_triangles=pow2(n_tris), max_vertices=pow2(n_verts),
                       max_tris_per_tile=min(pow2(n_tris), 2048),
                       max_instances=pow2(len(items)) if len(items) > 16
                       else 16)
    scene = rmesh.SceneBuffers(cfg.max_vertices, cfg.max_triangles,
                               cfg.max_instances, max_textures=1,
                               texture_size=8)
    mat_by_motion = {
        "static": scene.add_material(rmesh.Material(
            base_color=(0.5, 0.5, 0.52), roughness=0.85)),
        "dynamic": scene.add_material(rmesh.Material(
            base_color=(0.9, 0.55, 0.2), roughness=0.45)),
        "kinematic": scene.add_material(rmesh.Material(
            base_color=(0.25, 0.45, 0.85), roughness=0.45)),
    }
    mats = np.tile(np.eye(4, dtype=np.float32), (cfg.max_instances, 1, 1))
    for i, (mesh, mat, motion) in enumerate(items):
        scene.add_instance(mesh, material=mat_by_motion.get(
            motion or "dynamic", mat_by_motion["dynamic"]))
        mats[i] = mat

    centers = np.stack([m[:3, 3] for _, m, _ in items])
    lo, hi = centers.min(0) - 1.0, centers.max(0) + 1.0
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - lo)) * 0.5 + 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if cam is not None:
        eye_np, r3, fov, near = cam
        eye = t(eye_np)
        fwd = t(r3 @ np.array([0, 0, -1], np.float32))
        up = t(r3 @ np.array([0, 1, 0], np.float32))
        view = m3.look_at(eye, eye + fwd, up)
    else:
        fov, near = 0.9, 0.1
        eye = t(center + np.array([1.0, 0.7, 1.0]) * radius * 1.2)
        view = m3.look_at(eye, t(center), t([0.0, 1.0, 0.0]))
    proj = m3.perspective_reverse_z(fov, cfg.width / cfg.height, near, device=device)
    constants = common_constants(
        eye, view, proj, t([0.4, -0.7, -0.5]),
        (cfg.width, cfg.height), 0.0, 1.0 / 60.0)

    renderer = DeferredRenderer(cfg, scene, device)
    return renderer, renderer.device_scene(), t(mats), constants


def _cmd_debugview(args) -> int:
    """(Re)generate index.html over a debug-dump directory and optionally
    serve it — the interactive layer over utils/debug_view dumps."""
    from garden_tpu_torch.utils.debug_view import write_html_index
    path = write_html_index(args.directory)
    print(f"index -> {path}")
    if args.serve:
        import functools
        import http.server
        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=args.directory)
        with http.server.ThreadingHTTPServer(("127.0.0.1", args.serve),
                                             handler) as srv:
            print(f"serving {args.directory} at http://127.0.0.1:{args.serve}"
                  " (ctrl-c to stop)")
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
    return 0


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="garden_tpu_torch",
        description="garden-tpu asset pipeline CLI on the PyTorch port "
                    "(SURVEY.md layer 10)")
    sub = p.add_subparsers(dest="cmd", required=True)

    e2c = sub.add_parser("equi2cube",
                         help="equirect panorama -> 6 cubemap faces")
    e2c.add_argument("input")
    e2c.add_argument("out_dir")
    e2c.add_argument("--size", type=int, default=256)
    e2c.add_argument("--float", action="store_true",
                     help="write HDR .npy faces instead of tonemapped PNGs")
    e2c.set_defaults(fn=_cmd_equi2cube)

    mc = sub.add_parser("modelc", help="bake glTF/GLB/OBJ -> .npz geometry")
    mc.add_argument("input")
    mc.add_argument("output")
    mc.set_defaults(fn=_cmd_modelc)

    jb = sub.add_parser("json2bson", help="JSON -> BSON")
    jb.add_argument("input")
    jb.add_argument("output")
    jb.set_defaults(fn=_cmd_json2bson)

    bj = sub.add_parser("bson2json", help="BSON -> JSON")
    bj.add_argument("input")
    bj.add_argument("output")
    bj.set_defaults(fn=_cmd_bson2json)

    pk = sub.add_parser("pack", help="GPK1 archive create/list/extract")
    pk.add_argument("action", choices=("create", "list", "extract"))
    pk.add_argument("pack", nargs="?")
    pk.add_argument("name", nargs="?")
    pk.add_argument("dest", nargs="?")
    pk.add_argument("--source", default=None,
                    help="source directory for 'create'")
    pk.set_defaults(fn=_cmd_pack)

    sc = sub.add_parser("scene",
                        help="inspect a .scene JSON (+ --preview PNG)")
    sc.add_argument("input")
    sc.add_argument("--preview", default=None, metavar="OUT_PNG",
                    help="render the scene's collider geometry to a PNG")
    sc.add_argument("--width", type=int, default=640)
    sc.add_argument("--height", type=int, default=384)
    sc.add_argument("--cpu", action="store_true",
                    help="render the preview on the CPU (default: the card)")
    sc.set_defaults(fn=_cmd_scene)

    dv = sub.add_parser(
        "debugview",
        help="build index.html over a debug-dump dir; --serve PORT serves it")
    dv.add_argument("directory")
    dv.add_argument("--serve", type=int, default=None, metavar="PORT")
    dv.set_defaults(fn=_cmd_debugview)
    return p


def main(argv: List[str] = None, device: Optional[str] = None) -> int:
    """Run one subcommand; tensor work runs on `device` (default "cuda")."""
    args = make_parser().parse_args(argv)
    args.device = device or "cuda"
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
