"""The character system's sphere casts of an engine tick, recorded: the
inputs of the cast kernel at the engine frame's shapes, for its tests
(tests/test_torch_cast_kernel.py) and chip_smoke's phase n.2."""

from unittest import mock

from garden_tpu_torch.entry import ENGINE_DT
from garden_tpu_torch.physics import queries


def engine_casts(frame, state, ticks=1):
    """`ticks` engine ticks of `frame` (an `entry.EngineFrame`) from `state`
    -> (the state after them, the arguments of the last tick's sphere casts
    in their order: (physics state, origin, direction, radius, max_distance,
    exclude_body) a call, as the character system's stair and floor probes
    pass them)."""
    with mock.patch.object(queries, "cast_sphere", wraps=queries.cast_sphere) as spy:
        for _ in range(ticks):
            spy.reset_mock()
            state = frame.tick(state, ENGINE_DT)
        return state, [c.args for c in spy.call_args_list]
