"""The run's last line, and run.py without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import cells, tiny

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["flagship_1080p.headless"] + cells("world_batch"))
def test_result_line_has_its_keys(cell, traced):
    res = harness.run_cell(cell, 2 ** 31 + 3, 0.5, traced, ["cpu"], 0.0,
                           tiny(harness.load_cell(cell)))
    keys = list(res)
    # the compared numbers come last, under a key of their own
    assert keys[-1] == "checks"
    assert set(keys) - {"checks", "breakdown"} == REQUIRED
    assert ("breakdown" in keys) == traced
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, d in res["checks"].items():
        assert set(d) == {"value", "limit"}, name
    json.dumps(res)
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(res["device"]) >= {"busy_s", "window_s"}


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "flagship_1080p.play", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
