"""graph_replay_pct.engine: 100 x the calls of the engine tick's fixed-step
loop that replayed a CUDA graph over all its calls, the `graph_replays` and
`graph_calls` counters of the `PhysicsSystem.update` spans inside the
`step` root spans (EngineFrame.__call__), with both a traced step. None
where the spans do not count them."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", "PhysicsSystem.update", "graph_replays",
                           "graph_calls")
