"""atmosphere_kernel_pct.sim: 100 x the calls of the program's sky and
aerial perspective that ran their hand-written kernels
(`csrc/atmosphere.cu`) over all their calls, the `atmosphere_kernel_calls`
and `atmosphere_calls` counters of the spans of the `step` root steps
(the view sky, the specular sky, the SH sky and the aerial perspective,
all in `sky_lighting`), with both a traced step. 100 where a CUDA tensor
always takes the kernels; None for a program without the counters."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", None, "atmosphere_kernel_calls", "atmosphere_calls")
