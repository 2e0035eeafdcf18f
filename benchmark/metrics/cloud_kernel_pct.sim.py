"""cloud_kernel_pct.sim: 100 x the calls of the program's cloud march and
cloud shadow that ran their hand-written kernels (`csrc/clouds.cu`) over
all their calls, the `cloud_kernel_calls` and `cloud_calls` counters of
the spans of the `step` root steps (the `clouds` and `cloud_shadow`
spans), with both a traced step. 100 where a CUDA tensor always takes the
kernels; None for a program without the counters."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", None, "cloud_kernel_calls", "cloud_calls")
