"""Every cell's files load by name, and the benchmark's definition keeps
to its own rules."""

import json
import re

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = harness.load_cell(name)
    assert c["config"]["n_bodies"] > 1
    assert c["traffic"]["entry"]
    mod = harness.entry(c["traffic"]["entry"])
    assert callable(mod.build)
    assert c["limits"], f"no limits file for {name}"
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(SPEC, name, kind):
            assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_cell_reports_enough():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for name in CELLS:
        e2e = {m["name"] for m in harness.metrics_of(SPEC, name, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        assert harness.metrics_of(SPEC, name, "per_layer"), name


def test_names_units_and_layers_keep_the_rules():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(name.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
