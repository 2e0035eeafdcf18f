"""graph_replay_pct.play: 100 x the calls of the program's physics step
that replayed a CUDA graph over all its calls, the `graph_replays` and
`graph_calls` counters of the `physics` spans inside the `step` root
spans (CombinedStep.__call__), with both a traced step."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", "physics", "graph_replays", "graph_calls")
