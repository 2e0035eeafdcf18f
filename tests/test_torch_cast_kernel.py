"""The swept-sphere cast kernel (`csrc/queries.cu`) and the dispatch in
`physics/queries.py` that chooses it, and the metric that reads the
dispatch (`benchmark/metrics/cast_kernel_pct.engine.py`).

On the CPU: `cast_sphere` takes `cast_sphere_plain`, which gives the
values of the benchmark's frozen plain reference
(`benchmark/reference/physics/queries.py`) in every bit, batched and
single, and keeps the public function's signature; each call charges
`cast_calls` 1 and `cast_kernel_calls` 0 to its span, and the engine's
character system makes its three probes a tick through it; the CUDA
wrapper refuses CPU tensors and wrong dtypes (no fallback); `cuda_build`
declares the kernel; `cast_kernel_pct.engine` reads 100, a share, 0 and
None from hand-made span records.

On a card (`gpu`; run with
`python -m pytest --noconftest -m gpu tests/test_torch_cast_kernel.py -q`):
the kernel against the plain version on the same card, on the mixed world
(every shape class hit) and at the engine frame's shapes (8 casts over
10,248 bodies, the character system's three probes from the stepped
benchmark state): `hit` and `body` equal; on the mixed world the distance,
point and normal within TOL_QUERY; at the engine's shapes the distance
within CAST_ULPS ulps (the box pairs' einsums round as cuBLAS picks for
the batch; see the kernel's header). One call is one launch, with no host
synchronization; a batched row equals its single call in every bit; the
workspace stays clean across calls of every batch size.
"""

import torch_threads  # noqa: F401  (first: caps torch threads under xdist)

import inspect
import json

import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark.entries import engine_frame
from benchmark.reference.physics import queries as ref_queries
from garden_tpu_torch import cuda_build, entry
from garden_tpu_torch.physics import queries, scenes
from garden_tpu_torch.physics import shapes as sh
from garden_tpu_torch.utils import profiler
from engine_casts import engine_casts
from test_torch_engine_frame import small_config

TOL_QUERY = 1e-4      # chip_smoke's bar of the casts, card against CPU
CAST_ULPS = 4         # the engine probes' distances, kernel against the plain version (0 seen)
CELL = "engine_frame_1080p.engine"
SEED = 2 ** 31 + 1234


def _mixed_casts(state, device):
    """Casts over the mixed world that hit every shape class: the twelve
    random rows of `test_cast_sphere_batched_equals_single_calls`, then
    from above each live body down and from its side across, and a few
    onto the plane away from the bodies -> (origin, direction, radius,
    max_distance, exclude_body), each a tensor with a leading cast axis."""
    rng = np.random.default_rng(5)
    e = 12
    org = [np.c_[rng.uniform(-5, 5, e), rng.uniform(0.3, 4, e), rng.uniform(-3, 3, e)]]
    dirs = rng.normal(size=(e, 3))
    dirs[:6] = (0.0, -1.0, 0.0)
    dirs = [dirs]
    rad = [rng.uniform(0.1, 0.5, e)]
    dist = [rng.uniform(1, 10, e)]
    excl = [rng.integers(-1, 8, e)]
    b = state["bodies"]
    stype = state["shapes"]["type"][b["shape"].long()]
    for j in torch.nonzero(b["has"]).squeeze(-1).tolist():
        if int(stype[j]) == sh.PLANE:
            continue
        p = b["pos"][j].cpu().numpy().astype(np.float64)
        org.append(np.stack([p + (0.05, 3.0, -0.03), p + (-4.0, 0.1, 0.02)]))
        dirs.append(np.array([(0.0, -1.0, 0.0), (1.0, 0.0, 0.05)]))
        rad.append(np.array([0.2, 0.25]))
        dist.append(np.array([10.0, 10.0]))
        excl.append(np.array([-1, -1]))
    org.append(np.array([(8.0, 3.0, 8.0), (-8.0, 2.0, 7.0), (7.0, 1.0, -8.0)]))
    dirs.append(np.array([(0.0, -1.0, 0.0), (0.3, -1.0, 0.1), (-0.2, -0.5, 0.4)]))
    rad.append(np.array([0.2, 0.3, 0.1]))
    dist.append(np.array([10.0, 10.0, 10.0]))
    excl.append(np.array([-1, -1, 3]))
    f = lambda parts: torch.tensor(np.concatenate(parts), dtype=torch.float32, device=device)
    return (f(org), f(dirs), f(rad), f(dist),
            torch.tensor(np.concatenate(excl), dtype=torch.int32, device=device))


def _spans(fn):
    """fn() inside a recorded root step -> {span name: counters}."""
    first = profiler.RECORDER.next_step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("step"):
            fn()
    return {s["name"]: s["counters"] for s in profiler.recorded() if s["step"] >= first}


def _same_hit(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and x.dtype == y.dtype, f
        assert torch.equal(x, y), f


# -- the CPU: the plain path ---------------------------------------------------

def test_cpu_tensors_give_the_plain_reference_bits():
    state, _, _ = scenes.mixed_world("cpu")
    org, dirs, rad, dist, excl = _mixed_casts(state, "cpu")
    launches = dict(cuda_build.launches)
    got = queries.cast_sphere(state, org, dirs, rad, dist, excl)
    _same_hit(got, queries.cast_sphere_plain(state, org, dirs, rad, dist, excl))
    _same_hit(got, ref_queries.cast_sphere(state, org, dirs, rad, dist, excl))
    for i in range(0, org.shape[0], 7):
        args = (org[i], dirs[i], float(rad[i]), float(dist[i]), int(excl[i]))
        _same_hit(queries.cast_sphere(state, *args), ref_queries.cast_sphere(state, *args))
    hit_types = state["shapes"]["type"][state["bodies"]["shape"].long()][got.body[got.hit]]
    assert set(hit_types.tolist()) == set(range(sh.SPHERE, sh.MESH + 1))
    assert cuda_build.launches == launches


def test_plain_version_keeps_the_signature():
    sig = inspect.signature(queries.cast_sphere)
    assert inspect.signature(queries.cast_sphere_plain) == sig
    assert inspect.signature(queries.cast_sphere_cuda) == sig
    assert inspect.signature(ref_queries.cast_sphere) == sig


def test_cpu_calls_are_charged_as_plain_calls():
    state, _, _ = scenes.mixed_world("cpu")
    org, dirs, rad, dist, excl = _mixed_casts(state, "cpu")

    def calls():
        with profiler.span("probe"):
            queries.cast_sphere(state, org, dirs, rad, dist, excl)
        with profiler.span("single"):
            queries.cast_sphere(state, org[0], dirs[0], 0.2)
    by = _spans(calls)
    for name in ("probe", "single"):
        assert (by[name]["cast_calls"], by[name]["cast_kernel_calls"]) == (1, 0)
    assert "cast_calls" not in by["step"]


def test_the_character_system_casts_through_the_dispatch():
    """A small engine frame in the cell's layout: one tick makes the three
    probes (foot, step height, floor) over its active characters, each
    charged to `CharacterSystem.update` as a plain call on the CPU, and
    `engine_casts` hands back their arguments."""
    cfg = small_config()
    traffic = harness.load_cell(CELL)["traffic"]
    run = engine_frame.build(cfg, traffic, SEED, [torch.device("cpu")])
    state, calls = engine_casts(run.fn, run.state, ticks=2)
    assert len(calls) == 3
    for phys, org, dirs, rad, dist, excl in calls:
        assert org.shape == dirs.shape == (2, 3) and rad.shape == dist.shape == (2,)
        assert excl.dtype == torch.int32 and phys["bodies"]["pos"].shape[0] == 66
    by = _spans(lambda: run.fn.tick(state, entry.ENGINE_DT))
    got = by["CharacterSystem.update"]
    assert (got["cast_calls"], got["cast_kernel_calls"]) == (3, 0)


def test_cast_kernel_is_declared():
    source, _ = cuda_build.KERNELS["cast_sphere"]
    assert source == "queries" and "queries" in cuda_build.SOURCES
    assert "cast_sphere" in cuda_build.launches


def test_cuda_wrapper_refuses_cpu_and_wrong_dtypes():
    state, _, _ = scenes.mixed_world("cpu")
    down = torch.tensor([0.0, -1.0, 0.0])
    with pytest.raises(ValueError, match="CUDA"):
        queries.cast_sphere_cuda(state, torch.tensor([0.0, 3.0, 0.0]), down, 0.2)
    with pytest.raises(ValueError, match="float32"):
        queries.cast_sphere_cuda(state, torch.zeros(3, dtype=torch.float64), down, 0.2)


def test_other_devices_have_no_path():
    state, _, _ = scenes.mixed_world("cpu")
    meta = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no path"):
        queries.cast_sphere(state, meta, meta, 0.2)


# -- the metric: cast_kernel_pct.engine ----------------------------------------

METRIC = "cast_kernel_pct.engine"
RANGES = [(0, 1000, "bench.step"), (10, 990, "step"), (100, 600, "tick"),
          (200, 500, "CharacterSystem.update")]


def _span(i, name, parent, **counters):
    start, end = next((r[0], r[1]) for r in RANGES if r[2] == name)
    return {"id": i, "name": name, "start_ns": start - 1, "end_ns": end + 1,
            "parent": parent, "step": 3, "device": 0, "attrs": {},
            "counters": dict({"syncs": 0}, **counters)}


def _run():
    return harness.Run(prof=([(0, 210, 230, "cast_sphere_kernel", 1)], [(210, 1)], RANGES),
                       devices=[torch.device("cuda", 0)], traffic={"trace_steps": 1},
                       worlds=1, config=harness.load_cell(CELL)["config"],
                       peaks=json.loads((harness.BENCH / "peaks.json").read_text()),
                       kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0)


def _read(monkeypatch, character, tick=None):
    recorded = [_span(0, "step", None), _span(1, "tick", 0, **(tick or {})),
                _span(2, "CharacterSystem.update", 1, **character)]
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    return harness.reader(METRIC)(_run())


@pytest.mark.parametrize("calls,kernel,want", [(3, 3, 100.0), (3, 0, 0.0)])
def test_metric_reads_the_kernels_share(monkeypatch, calls, kernel, want):
    got = _read(monkeypatch, {"cast_calls": calls, "cast_kernel_calls": kernel})
    assert got["value"] == pytest.approx(want)
    assert (got["cast_kernel_calls"], got["cast_calls"]) == (float(kernel), float(calls))
    assert got["by_span"] == {"CharacterSystem.update": {"cast_kernel_calls": float(kernel),
                                                         "cast_calls": float(calls)}}


def test_metric_counts_plain_calls_against_it(monkeypatch):
    got = _read(monkeypatch, {"cast_calls": 3, "cast_kernel_calls": 3},
                tick={"cast_calls": 1, "cast_kernel_calls": 0})
    assert got["value"] == pytest.approx(75.0)
    assert set(got["by_span"]) == {"tick", "CharacterSystem.update"}


@pytest.mark.parametrize("recorded", ["bare", "none", "untraced"])
def test_metric_reads_none_without_the_counters(monkeypatch, recorded):
    if recorded == "bare":   # the parent's program: the spans, not the counters
        assert _read(monkeypatch, {"atmosphere_calls": 1}) is None
    elif recorded == "none":
        monkeypatch.setattr(spans, "recorded", lambda: None)
        assert harness.reader(METRIC)(_run()) is None
    else:
        monkeypatch.setattr(spans, "recorded",
                            lambda: [_span(0, "step", None, cast_calls=3)])
        run = _run()
        run.prof = None
        assert harness.reader(METRIC)(run) is None


def test_metric_reports_in_the_engine_cell():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    got = [m for m in spec["per_layer"] if m["name"] == METRIC]
    assert len(got) == 1 and got[0]["workloads"] == [CELL]
    assert got[0]["moves"] == "step_p95_ms" and got[0]["layer"] == "systems"
    assert got[0]["source"] == "program_counter"
    assert METRIC in {m["name"] for m in harness.metrics_of(spec, CELL, "per_layer")}


# -- the card: the kernel against the plain version ----------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ulps(a, b):
    """The distance in ulps of two float32 tensors of one sign."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


@pytest.mark.gpu
def test_kernel_matches_the_plain_version_on_the_mixed_world(cuda):
    state, _, _ = scenes.mixed_world(cuda)
    args = _mixed_casts(state, cuda)
    got = queries.cast_sphere(state, *args)
    want = queries.cast_sphere_plain(state, *args)
    assert torch.equal(got.hit, want.hit) and torch.equal(got.body, want.body)
    for f in ("distance", "point", "normal"):
        d = (getattr(got, f) - getattr(want, f))[want.hit].abs().max().item()
        assert d <= TOL_QUERY, (f, d)
    hit_types = state["shapes"]["type"][state["bodies"]["shape"].long()][got.body[got.hit]]
    assert set(hit_types.tolist()) == set(range(sh.SPHERE, sh.MESH + 1))
    # a batched row is its single call; the workspace is clean after
    # every batch size (1, the rows, and more than its first 64 casts)
    org, dirs, rad, dist, excl = args
    for i in range(org.shape[0]):
        one = queries.cast_sphere(state, org[i], dirs[i], rad[i], dist[i], excl[i])
        for f in one._fields:
            assert torch.equal(getattr(got, f)[i], getattr(one, f)), (i, f)
    many = queries.cast_sphere(state, *(x.repeat(3, *[1] * (x.dim() - 1)) for x in args))
    for f in got._fields:
        assert torch.equal(getattr(many, f)[:org.shape[0]], getattr(got, f)), f
    _same_hit(queries.cast_sphere(state, *args), got)


@pytest.mark.gpu
def test_kernel_matches_the_plain_version_at_the_engine_cells_shapes(cuda):
    """The character system's three probes (8 casts over 10,248 bodies)
    from the cell's state, 12 ticks from its start: hit and body equal,
    the distances of the hits within CAST_ULPS ulps; some probe hits."""
    cell = harness.load_cell(CELL)
    run = engine_frame.build(cell["config"], cell["traffic"], SEED, [cuda])
    state, hits, exact, total, worst = run.state, 0, 0, 0, 0
    for _ in range(12):
        state, calls = engine_casts(run.fn, state)
        assert len(calls) == 3
        for phys, *args in calls:
            assert args[0].shape == (8, 3) and phys["bodies"]["pos"].shape[0] == 10248
            got = queries.cast_sphere(phys, *args)
            want = queries.cast_sphere_plain(phys, *args)
            assert torch.equal(got.hit, want.hit) and torch.equal(got.body, want.body)
            u = _ulps(got.distance, want.distance)[want.hit]
            hits += int(want.hit.sum())
            exact += int((u == 0).sum())
            total += u.numel()
            worst = max(worst, int(u.max()) if u.numel() else 0)
    print(f"engine probes: {hits} hits of {12 * 3 * 8} casts, {exact} distances exact, "
          f"worst {worst} ulps")
    assert hits > 0 and worst <= CAST_ULPS


@pytest.mark.gpu
def test_one_call_is_one_launch_and_no_sync(cuda):
    state, _, _ = scenes.mixed_world(cuda)
    org, dirs, rad, dist, excl = _mixed_casts(state, cuda)
    queries.cast_sphere(state, org, dirs, rad, dist, excl)      # builds the library
    torch.cuda.synchronize()
    before = cuda_build.launches["cast_sphere"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        queries.cast_sphere(state, org, dirs, rad, dist, excl)
        queries.cast_sphere(state, org[0], dirs[0], 0.2)
        queries.cast_sphere(state, org[1], dirs[1], 0.3, 5.0, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_build.launches["cast_sphere"] == before + 3


@pytest.mark.gpu
def test_kernel_calls_are_charged(cuda):
    state, _, _ = scenes.mixed_world(cuda)
    org, dirs, rad, dist, excl = _mixed_casts(state, cuda)
    queries.cast_sphere(state, org, dirs, rad, dist, excl)
    torch.cuda.synchronize()

    def calls():
        with profiler.span("probe"):
            queries.cast_sphere(state, org, dirs, rad, dist, excl)
    by = _spans(calls)
    assert (by["probe"]["cast_calls"], by["probe"]["cast_kernel_calls"]) == (1, 1)
    assert by["probe"]["syncs"] == 0
