"""ui_kernel_pct.engine: 100 x the calls of the program's HUD composite
that ran its hand-written kernel (`csrc/sprites.cu`) over all its calls,
the `ui_kernel_calls` and `ui_calls` counters of the spans of the `step`
root steps (one call a frame, in `ui`), with both a traced step. 100 where
a CUDA image always takes the kernel; None for a program without the
counters."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", None, "ui_kernel_calls", "ui_calls")
