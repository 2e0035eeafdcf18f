"""Parity of the port's asset pipeline (`garden_tpu_torch/assets/`) with the
JAX package's, on the same inputs: BSON bytes, OBJ and glTF meshes, PNG,
Radiance HDR and OpenEXR images, GPK1 pack archives written by either
package and read by the other on both the native and the Python paths,
and the async resource pipeline (each wait bounded by its own timeout).

Tolerance: none. Every byte and every array element is equal.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import json
import struct
import zlib

import numpy as np
import pytest

from garden_tpu.assets import bson as jbson
from garden_tpu.assets import gltf as jgltf
from garden_tpu.assets import images as jimages
from garden_tpu.assets import model as jmodel
from garden_tpu.assets import pack as jpack
from garden_tpu_torch.assets import bson as tbson
from garden_tpu_torch.assets import gltf as tgltf
from garden_tpu_torch.assets import images as timages
from garden_tpu_torch.assets import model as tmodel
from garden_tpu_torch.assets import pack as tpack
from garden_tpu_torch.assets.resources import IMAGE, MODEL, ResourceSystem
from garden_tpu_torch.render.mesh import Mesh

WAIT_S = 20.0    # each resource wait's own limit: a stuck pool fails, not hangs

DOC = {"name": "scene", "count": 3, "big": 2 ** 40, "pos": [1.0, 2.5, -3.0],
       "nested": {"on": True, "off": False, "none": None, "list": [1, "two", [3.0]]},
       "entities": [{"components": [{".type": "transform", "uid": "a1"}]}]}

OBJ = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
f 1/1 2/2 3/3 4/1
f 1 3 4
"""


def _same_mesh(a, b):
    assert type(b) is Mesh
    for f in ("positions", "normals", "uvs", "indices"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_bson_bytes_match(tmp_path):
    assert tbson.dumps(DOC) == jbson.dumps(DOC)
    data = jbson.dumps(DOC)
    assert tbson.loads(data) == jbson.loads(data) == DOC
    src = tmp_path / "doc.json"
    src.write_text(json.dumps(DOC))
    for mod, tag in ((jbson, "j"), (tbson, "t")):
        mod.json2bson(str(src), str(tmp_path / f"{tag}.bson"))
        mod.bson2json(str(tmp_path / f"{tag}.bson"), str(tmp_path / f"{tag}.json"))
    assert (tmp_path / "t.bson").read_bytes() == (tmp_path / "j.bson").read_bytes()
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_obj_meshes_match(tmp_path):
    t, j = tmodel.load_obj(OBJ, from_string=True), jmodel.load_obj(OBJ, from_string=True)
    _same_mesh(j, t)
    tmodel.save_obj(t, str(tmp_path / "t.obj"))
    jmodel.save_obj(j, str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    _same_mesh(jmodel.load_obj(str(tmp_path / "j.obj")),
               tmodel.load_obj(str(tmp_path / "t.obj")))


def _glb():
    """A two-primitive GLB: uint16 indices with UVs, and an unindexed
    primitive without normals or UVs."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    nrm = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    idx = np.array([0, 1, 2, 2, 1, 3], np.uint16)
    blobs = [pos, nrm, uv, idx, pos[:3] * 2.0]
    offs = np.cumsum([0] + [b.nbytes for b in blobs])
    bin_data = b"".join(b.tobytes() for b in blobs)
    acc = lambda v, ct, n, ty: {"bufferView": v, "componentType": ct, "count": n, "type": ty}
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(bin_data)}],
        "bufferViews": [{"buffer": 0, "byteOffset": int(o), "byteLength": b.nbytes}
                        for o, b in zip(offs, blobs)],
        "accessors": [acc(0, 5126, 4, "VEC3"), acc(1, 5126, 4, "VEC3"),
                      acc(2, 5126, 4, "VEC2"), acc(3, 5123, 6, "SCALAR"),
                      acc(4, 5126, 3, "VEC3")],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}, "indices": 3},
            {"attributes": {"POSITION": 4}}]}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    bd = bin_data + b"\0" * (-len(bin_data) % 4)
    out = struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8 + len(bd))
    return out + struct.pack("<II", len(js), 0x4E4F534A) + js \
        + struct.pack("<II", len(bd), 0x004E4942) + bd


def test_gltf_meshes_match(tmp_path):
    data = _glb()
    t, j = tgltf.load_gltf_bytes(data), jgltf.load_gltf_bytes(data)
    assert len(t) == len(j) == 2
    for a, b in zip(j, t):
        _same_mesh(a, b)
    (tmp_path / "m.glb").write_bytes(data)
    for a, b in zip(jgltf.load_gltf(str(tmp_path / "m.glb")),
                    tgltf.load_gltf(str(tmp_path / "m.glb"))):
        _same_mesh(a, b)


def _write_hdr(path, rgb, rle):
    h, w, _ = rgb.shape
    exp = np.ceil(np.log2(rgb.max(-1))).astype(np.int32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * (256.0 / 2.0 ** exp)[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = exp + 128
    body = b""
    for y in range(h):
        if not rle:
            body += rgbe[y].tobytes()
            continue
        body += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):            # one literal run and one repeat run
            half = w // 2
            body += bytes([half]) + rgbe[y, :half, c].tobytes()
            body += bytes([128 + w - half, int(rgbe[y, half, c])])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode() + body)


def _write_exr(path, img, zips):
    h, w, _ = img.shape
    px = np.float16 if zips else np.float32
    chans = b"".join(n + b"\x00" + struct.pack("<i", 1 if zips else 2) + b"\x00" * 4
                     + struct.pack("<ii", 1, 1) for n in (b"B", b"G", b"R")) + b"\x00"
    attr = lambda n, t, p: n + b"\x00" + t + b"\x00" + struct.pack("<i", len(p)) + p
    dw = struct.pack("<4i", 0, 0, w - 1, h - 1)
    hdr = (b"\x76\x2f\x31\x01" + struct.pack("<i", 2) + attr(b"channels", b"chlist", chans)
           + attr(b"compression", b"compression", bytes([2 if zips else 0]))
           + attr(b"dataWindow", b"box2i", dw) + attr(b"displayWindow", b"box2i", dw)
           + attr(b"lineOrder", b"lineOrder", b"\x00") + b"\x00")
    blocks = []
    for y in range(h):
        line = b"".join(img[y, :, c].astype(px).tobytes() for c in (2, 1, 0))
        if zips:
            a = np.frombuffer(line, np.uint8)
            inter = np.concatenate([a[0::2], a[1::2]]).astype(np.int64)
            enc = np.concatenate([inter[:1], (inter[1:] - inter[:-1] + 128) % 256])
            line = zlib.compress(enc.astype(np.uint8).tobytes())
        blocks.append(struct.pack("<ii", y, len(line)) + line)
    offsets, o = b"", len(hdr) + 8 * h
    for bl in blocks:
        offsets += struct.pack("<q", o)
        o += len(bl)
    with open(path, "wb") as f:
        f.write(hdr + offsets + b"".join(blocks))


@pytest.mark.parametrize("fmt", ["hdr_flat", "hdr_rle", "exr_f32", "exr_zips_f16"])
def test_hdr_and_exr_images_match(tmp_path, fmt):
    rng = np.random.default_rng(3)
    img = (np.abs(rng.normal(1.0, 2.0, (6, 10, 3))) + 0.1).astype(np.float32)
    p = str(tmp_path / ("x." + fmt[:3]))
    if fmt == "hdr_rle":
        img[:, 5:] = img[:, 5:6]       # the run half of each row is one pixel
    if fmt.startswith("hdr"):
        _write_hdr(p, img, rle=fmt == "hdr_rle")
        ref, out = jimages.load_hdr(p), timages.load_hdr(p)
    else:
        _write_exr(p, img, zips=fmt == "exr_zips_f16")
        ref, out = jimages.load_exr(p), timages.load_exr(p)
    assert out.dtype == ref.dtype and out.shape == ref.shape == (6, 10, 4)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(timages.load_image(p), jimages.load_image(p))
    np.testing.assert_allclose(out[..., :3], img, rtol=0.05, atol=0.05)


def test_png_images_match(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (9, 13, 4)).astype(np.float32)
    timages.save_png(str(tmp_path / "t.png"), img)
    jimages.save_png(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    for lin in (True, False):
        np.testing.assert_array_equal(timages.load_image(str(tmp_path / "j.png"), lin),
                                      jimages.load_image(str(tmp_path / "j.png"), lin))
    np.testing.assert_array_equal(timages.srgb_to_linear(img), jimages.srgb_to_linear(img))
    np.testing.assert_array_equal(timages.resize_image(img, (5, 7)),
                                  jimages.resize_image(img, (5, 7)))


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 3), (7, 5, 4)], ids=["grey", "rgb", "rgba"])
def test_png_without_pil_decodes_to_the_same_pixels(tmp_path, monkeypatch, shape):
    """The card's machine has no PIL: save_png writes its own PNG there,
    which PIL (here) decodes to the pixels PIL's own file holds."""
    from PIL import Image
    img = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    jimages.save_png(str(tmp_path / "pil.png"), img)
    monkeypatch.setattr(timages, "_HAS_PIL", False)
    timages.save_png(str(tmp_path / "own.png"), img)
    own = np.asarray(Image.open(tmp_path / "own.png"))
    np.testing.assert_array_equal(own, np.asarray(Image.open(tmp_path / "pil.png")))
    np.testing.assert_array_equal(own, img)


# -- pack archives -------------------------------------------------------------------


ITEMS = {"scenes/level1.scene": b"scene data " * 1000, "tiny.txt": b"x",
         "a/b.bin": bytes(range(256)) * 10}


def _write(mod, path, native):
    if not native:
        saved, mod._NATIVE = mod._NATIVE, None
    try:
        w = mod.PackWriter(str(path))
        for k, v in ITEMS.items():
            w.add(k, v)
        w.finish()
    finally:
        if not native:
            mod._NATIVE = saved


def _read(mod, path, native):
    if not native:
        saved, mod._NATIVE = mod._NATIVE, None
    try:
        r = mod.PackReader(str(path))
        out = {k: r.read(k) for k in r.names()}
        with pytest.raises(KeyError):
            r.read("missing")
        r.close()
        return out
    finally:
        if not native:
            mod._NATIVE = saved


def test_pack_builds_its_own_native_library():
    assert tpack.native_available()
    assert tpack.library_path().parent == tpack.BUILD_DIR
    assert "garden_tpu_torch" in str(tpack.BUILD_DIR) and tpack.library_path().exists()


@pytest.mark.parametrize("writer", ["jax_native", "jax_python", "port_native", "port_python"])
def test_pack_archives_interchange(tmp_path, writer):
    """test_pack.py's interop case both ways: an archive written by either
    package, on either path, reads in both, on both paths, byte for byte."""
    assert jpack.native_available(), "native libgardenpack.so should be built"
    path = tmp_path / "assets.gpk"
    side, way = writer.split("_")
    _write(jpack if side == "jax" else tpack, path, way == "native")
    data = path.read_bytes()
    for mod in (jpack, tpack):
        for native in (True, False):
            assert _read(mod, path, native) == ITEMS, (mod.__name__, native)
    # the same archive bytes from the other package's same path
    other = tmp_path / "other.gpk"
    _write(tpack if side == "jax" else jpack, other, way == "native")
    assert other.read_bytes() == data
    assert len(data) < len(ITEMS["scenes/level1.scene"]) // 2


def test_pack_reports_its_path(tmp_path):
    w = tpack.PackWriter(str(tmp_path / "n.gpk"))
    w.finish()
    assert w.native
    saved, tpack._NATIVE = tpack._NATIVE, None
    try:
        assert not tpack.native_available()
        assert not tpack.PackReader(str(tmp_path / "n.gpk")).native
    finally:
        tpack._NATIVE = saved


# -- the resource pipeline -------------------------------------------------------------


def test_async_resource_pipeline(tmp_path):
    """Background loads, drain, dedup, a failed load, hot reload and the
    pack source, with models decoded to the port's Mesh; each wait has its
    own limit (WAIT_S)."""
    img = np.zeros((8, 8, 4), np.float32)
    img[..., 1] = 0.5
    img[..., 3] = 1.0
    timages.save_png(str(tmp_path / "tex.png"), img)
    (tmp_path / "tri.obj").write_text(OBJ)
    (tmp_path / "m.glb").write_bytes(_glb())
    rs = ResourceSystem(root=str(tmp_path))
    events = []
    rs.on_loaded(IMAGE, lambda h: events.append(h.path))
    h1 = rs.load_image_async("tex.png", linearize=False)
    assert rs.load_image_async("tex.png", linearize=False) is h1     # dedup
    hb = rs.load_bytes_async("tex.png")
    ho = rs.load_model_async("tri.obj")
    hg = rs.load_model_async("m.glb")
    rs.wait_all(timeout=WAIT_S)
    assert h1.ready and h1.value.shape == (8, 8, 4) and events == ["tex.png"]
    np.testing.assert_array_equal(h1.value, jimages.load_image(str(tmp_path / "tex.png"),
                                                              linearize=False))
    assert hb.ready and hb.value == (tmp_path / "tex.png").read_bytes()
    _same_mesh(jmodel.load_obj(OBJ, from_string=True), ho.value)
    for a, b in zip(jgltf.load_gltf_bytes(_glb()), hg.value):
        _same_mesh(a, b)
    assert ho.kind == MODEL

    bad = rs.load_image_async("missing.png")
    rs.wait_all(timeout=WAIT_S)
    assert not bad.ready and "FileNotFoundError" in bad.error

    img[..., 1] = 1.0
    timages.save_png(str(tmp_path / "tex.png"), img)
    rs.reload("tex.png")
    rs.wait_all(timeout=WAIT_S)
    assert abs(float(h1.value[0, 0, 1]) - 1.0) < 2 / 255

    # release mode: a pack archive serves reads before loose files
    packed = tmp_path / "bundle.gpk"
    w = tpack.PackWriter(str(packed))
    w.add("only_in_pack.txt", b"from the pack")
    w.finish()
    rs.use_pack(str(packed))
    hp = rs.load_bytes_async("only_in_pack.txt")
    rs.wait_all(timeout=WAIT_S)
    assert hp.value == b"from the pack"
    rs.shutdown()


def test_resource_wait_times_out(tmp_path):
    """A load that never completes makes wait_all raise at its limit."""
    import threading
    gate = threading.Event()
    rs = ResourceSystem(root=str(tmp_path))
    rs._read = lambda path: gate.wait(WAIT_S) and b""
    rs.load_bytes_async("slow.bin")
    with pytest.raises(TimeoutError):
        rs.wait_all(timeout=0.2)
    gate.set()
    rs.wait_all(timeout=WAIT_S)
    rs.shutdown()


def test_bson_loads_a_document_in_a_stream():
    # a document embedded in a larger buffer reads by its own length prefix
    data = tbson.dumps(DOC)
    assert tbson.loads(data + b"trailing") == DOC
