"""The port's command line (`python -m garden_tpu_torch`, `cli.py`) and its
debug views (`utils/debug_view.py`) against the JAX package's, on the CPU.

The mirrors of tests/test_cli.py's six tier-1 tests run through
`main(argv, device="cpu")` and compare the files they write with the
reference's where both write one. The scene preview renders at 256x128
on the CPU through the port's DeferredRenderer; its tier-1 test checks the
PNG's size and colour classes, and a `slow` test holds it to the JAX
preview's PNG under the image bar of chip_smoke's phases e and j (within
2 levels on >= 99.5% of the pixels). The debug views write the same PNG
bytes and stats as the reference on the same values (`convert.from_jax`).
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from garden_tpu import cli as jcli
from garden_tpu.utils import debug_view as jdv
from garden_tpu_torch import cli as tcli
from garden_tpu_torch.convert import from_jax
from garden_tpu_torch.utils import debug_view as tdv

SUBCOMMANDS = ("equi2cube", "modelc", "json2bson", "bson2json", "pack", "scene",
               "debugview")
SCENE = {"entities": [
    {"uid": 1, "transform": {"position": [0, 0, 0]},
     "rigidbody": {"shapeType": "plane", "normal": [0, 1, 0], "distance": 0.0,
                   "motionType": "static"}},
    {"uid": 2, "transform": {"position": [0, 0.5, 0]},
     "rigidbody": {"shapeType": "box", "halfExtent": [0.5, 0.5, 0.5]}},
    {"uid": 3, "transform": {"position": [0.1, 1.5, 0.0]},
     "rigidbody": {"shapeType": "sphere", "radius": 0.5}},
]}


def main(argv):
    return tcli.main(argv, device="cpu")


def test_help_lists_the_subcommands():
    out = subprocess.run([sys.executable, "-m", "garden_tpu_torch", "--help"],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert all(c in out.stdout for c in SUBCOMMANDS)


def test_pack_create_list_extract(tmp_path):
    src = tmp_path / "assets"
    (src / "textures").mkdir(parents=True)
    (src / "textures" / "a.bin").write_bytes(b"\x01\x02" * 100)
    (src / "readme.txt").write_text("hello")
    pack = str(tmp_path / "bundle.pack")
    assert main(["pack", "create", pack, str(src)]) == 0
    assert jcli.main(["pack", "create", str(tmp_path / "ref.pack"), str(src)]) == 0
    assert open(pack, "rb").read() == (tmp_path / "ref.pack").read_bytes()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["pack", "list", pack]) == 0
    assert set(buf.getvalue().split()) == {"textures/a.bin", "readme.txt"}
    dest = tmp_path / "out"
    assert main(["pack", "extract", pack, "textures/a.bin", str(dest)]) == 0
    assert (dest / "textures" / "a.bin").read_bytes() == b"\x01\x02" * 100


def test_json_bson_roundtrip(tmp_path):
    doc = {"name": "scene", "count": 3, "pos": [1.0, 2.0, 3.0], "nested": {"on": True}}
    (tmp_path / "doc.json").write_text(json.dumps(doc))
    assert main(["json2bson", str(tmp_path / "doc.json"), str(tmp_path / "doc.bson")]) == 0
    assert main(["bson2json", str(tmp_path / "doc.bson"), str(tmp_path / "doc2.json")]) == 0
    assert json.loads((tmp_path / "doc2.json").read_text()) == doc
    assert jcli.main(["json2bson", str(tmp_path / "doc.json"), str(tmp_path / "r.bson")]) == 0
    assert (tmp_path / "doc.bson").read_bytes() == (tmp_path / "r.bson").read_bytes()


def test_modelc_obj(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    assert main(["modelc", str(obj), str(tmp_path / "tri.npz")]) == 0
    assert jcli.main(["modelc", str(obj), str(tmp_path / "ref.npz")]) == 0
    data, ref = np.load(tmp_path / "tri.npz"), np.load(tmp_path / "ref.npz")
    assert int(data["count"]) == 1 and data["mesh0_positions"].shape == (3, 3)
    assert set(data.files) == set(ref.files)
    for k in data.files:
        np.testing.assert_array_equal(data[k], ref[k])


def test_equi2cube_cli(tmp_path):
    """Six faces; the HDR faces (--float) within 1e-5 of the reference's."""
    from garden_tpu_torch.assets.images import save_png
    equi = np.random.default_rng(0).uniform(0, 255, (8, 16, 3)).astype(np.uint8)
    save_png(str(tmp_path / "sky.png"), equi)
    assert main(["equi2cube", str(tmp_path / "sky.png"), str(tmp_path / "faces"),
                 "--size", "16"]) == 0
    assert len(os.listdir(tmp_path / "faces")) == 6
    assert main(["equi2cube", str(tmp_path / "sky.png"), str(tmp_path / "f"), "--size", "16",
                 "--float"]) == 0
    assert jcli.main(["equi2cube", str(tmp_path / "sky.png"), str(tmp_path / "r"),
                      "--size", "16", "--float"]) == 0
    for name in sorted(os.listdir(tmp_path / "r")):
        np.testing.assert_allclose(np.load(tmp_path / "f" / name),
                                   np.load(tmp_path / "r" / name), rtol=1e-5, atol=1e-5)


def test_scene_inspect(tmp_path, capsys):
    sc = tmp_path / "demo.scene"
    sc.write_text(json.dumps({"entities": [
        {"uid": 1, "transform": {"position": [0, 0, 0]}},
        {"uid": 2, "transform": {}, "rigidbody": {}},
    ]}))
    assert main(["scene", str(sc)]) == 0
    out = capsys.readouterr().out
    assert "2 entities" in out and "rigidbody" in out


def test_debugview_index(tmp_path):
    tdv._save(np.zeros((4, 4, 3), np.uint8), str(tmp_path / "a.png"))
    (tmp_path / "stats.txt").write_text("[render]\n{'tris': 1}\n")
    assert main(["debugview", str(tmp_path)]) == 0
    html = (tmp_path / "index.html").read_text()
    assert "a.png" in html and "tris" in html
    ref = tmp_path / "ref"
    ref.mkdir()
    for f in ("a.png", "stats.txt"):
        (ref / f).write_bytes((tmp_path / f).read_bytes())
    jdv.write_html_index(str(ref))
    assert html == (ref / "index.html").read_text()


def _preview(tmp_path, module, argv_extra, **kw):
    sc = tmp_path / "demo.scene"
    sc.write_text(json.dumps(SCENE))
    out = tmp_path / f"{module.__name__.split('.')[0]}.png"
    assert module.main(["scene", str(sc), "--preview", str(out), "--width", "256",
                        "--height", "128"] + argv_extra, **kw) == 0
    return np.asarray(Image.open(out)).astype(int), out


def test_scene_preview(tmp_path):
    """256x128 on the CPU: a PNG of that size, the dynamic bodies' orange
    (dynamic material) in the middle, the static grey ground below."""
    img, out = _preview(tmp_path, tcli, [], device="cpu")
    assert img.shape == (128, 256, 3) and out.stat().st_size > 1000
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    dynamic = (r - b > 40) & (g - b > 20)
    static = (b >= r) & (b - r < 30)
    assert dynamic.mean() > 0.01 and not dynamic[96:].any()
    assert static[96:].mean() > 0.9


def test_scene_preview_cpu_flag(tmp_path, monkeypatch):
    """--cpu selects the CPU whatever main's device is."""
    seen = []
    monkeypatch.setattr(tcli, "_scene_preview", lambda doc, p, w, h, dev: seen.append(dev))
    sc = tmp_path / "demo.scene"
    sc.write_text(json.dumps(SCENE))
    assert tcli.main(["scene", str(sc), "--preview", "x.png", "--cpu"], device="cuda") == 0
    assert tcli.main(["scene", str(sc), "--preview", "x.png"], device="cpu") == 0
    assert tcli.main(["scene", str(sc), "--preview", "x.png"]) == 0
    assert seen == ["cpu", "cpu", "cuda"]


@pytest.mark.slow
def test_scene_preview_matches_jax(tmp_path):
    port, _ = _preview(tmp_path, tcli, [], device="cpu")
    ref, _ = _preview(tmp_path, jcli, ["--cpu"])
    close = (np.abs(port - ref) <= 2).all(-1)
    assert close.mean() >= 0.995, close.mean()


# -- debug views ----------------------------------------------------------------------


def _frame(rng, h=24, w=32):
    vel = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    return {
        "image": rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
        "depth": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "tri_id": rng.integers(-1, 40, (h, w)).astype(np.int32),
        "gbuffer": {"normal": rng.normal(0, 1, (h, w, 3)).astype(np.float32),
                    "base_color": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
                    "roughness": rng.uniform(0, 1, (h, w)).astype(np.float32),
                    "metallic": rng.uniform(0, 1, (h, w)).astype(np.float32),
                    "visible": rng.uniform(0, 1, (h, w)) > 0.3},
        "shadow": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "ao": rng.uniform(0, 1, (h, w, 1)).astype(np.float32),
        "velocity": vel,
    }


def _state(rng, n=40):
    return {"bodies": {"pos": rng.uniform(-30, 30, (n, 3)).astype(np.float32),
                       "has": rng.uniform(0, 1, n) > 0.2,
                       "linvel": rng.normal(0, 6, (n, 3)).astype(np.float32),
                       "sleep": rng.uniform(0, 1, n) > 0.5},
            "contacts": {"valid": rng.uniform(0, 1, (n, 4)) > 0.5}}


def test_debug_views_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    out, state = _frame(rng), _state(rng)
    scene = {"tri_valid": rng.uniform(0, 1, 64) > 0.4}
    t_out, t_state, t_scene = (from_jax(x, "cpu") for x in (out, state, scene))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jw = jdv.dump_gbuffer(out, str(tmp_path / "j"), "f")
    tw = tdv.dump_gbuffer(t_out, str(tmp_path / "t"), "f")
    assert [os.path.basename(p) for p in tw] == [os.path.basename(p) for p in jw]
    jdv.dump_physics_top_view(state, str(tmp_path / "j" / "top.png"), size=64)
    tdv.dump_physics_top_view(t_state, str(tmp_path / "t" / "top.png"), size=64)
    atlas = np.where(rng.uniform(0, 1, (32, 48)) > 0.5, rng.uniform(0.2, 0.9, (32, 48)),
                     0.0).astype(np.float32)
    jdv.dump_cascade_atlas(atlas, str(tmp_path / "j" / "atlas.png"))
    tdv.dump_cascade_atlas(torch.as_tensor(atlas), str(tmp_path / "t" / "atlas.png"))
    assert tdv.render_stats(t_out, t_scene) == jdv.render_stats(out, scene)
    assert tdv.physics_stats(t_state) == jdv.physics_stats(state)
    jrep = jdv.dump_debug_sheet(out, state, None, str(tmp_path / "j"), scene)
    trep = tdv.dump_debug_sheet(t_out, t_state, None, str(tmp_path / "t"), t_scene)
    assert trep == jrep
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and "gbuffer_sheet.png" in names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
