"""On a card (`-m gpu`): the program comes out correct, and the control does
not. The control is the plain reference, put in the program's place in the
precision below the configuration's; it fails at least one of the cell's
numbers, while the program passes them all.

At the cells' own sizes over a 2 s window (about 30 s a cell), and the
program alone at a test's size (`conftest.tiny` at 1,000 bodies and
256x128), where its kernels meet shapes the cells do not give them;
`benchmark/calibrate.py` reads the same over more seeds.
"""

import pytest

from benchmark import check, harness
from benchmark.tests.conftest import cells, tiny

# the control of each cell: TF32 for the frame's matrix products, the state
# kept in bfloat16 for the physics, whose products TF32 does not touch
CONTROLS = dict({c: ("tf32", "bf16") for c in cells("combined_step")},
                **{c: ("bf16",) for c in cells("physics_tick") + cells("world_batch")})


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CONTROLS)
def test_control_fails_where_the_program_passes(cell, card):
    loaded = harness.load_cell(cell)
    res = harness.run_cell(cell, 2 ** 31 + 99, 2.0, False, [card], 0.0, loaded,
                           controls=CONTROLS[cell])
    assert res["correct"], res["checks"]
    for mode in CONTROLS[cell]:
        ok, got = check.judge(res["controls"][mode], loaded["limits"])
        assert not ok, (mode, got)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CONTROLS)
def test_program_is_correct_at_a_small_size(cell, card):
    loaded = tiny(harness.load_cell(cell), n_bodies=1000)
    res = harness.run_cell(cell, 2 ** 31 + 98, 2.0, False, [card], 0.0, loaded)
    assert res["correct"], res["checks"]
