"""graph_replay_pct.tick: 100 x the calls of the program's physics step
that replayed a CUDA graph over all its calls, the `graph_replays` and
`graph_calls` counters of the `physics` root spans (CombinedStep.physics),
with both a traced step."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "physics", "physics", "graph_replays", "graph_calls")
