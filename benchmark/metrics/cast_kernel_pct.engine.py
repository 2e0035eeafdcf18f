"""cast_kernel_pct.engine: 100 x the calls of the program's swept-sphere
cast that ran its hand-written kernel (`csrc/queries.cu`) over all its
calls, the `cast_kernel_calls` and `cast_calls` counters of the spans of
the `step` root steps (the character system's three probes a tick, in
`CharacterSystem.update`), with both a traced step. 100 where a CUDA
tensor always takes the kernel; None for a program without the counters."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", None, "cast_kernel_calls", "cast_calls")
