"""render_host_ms.play: host ms a traced step of the program's `render` span
(CombinedStep.render), in the unsynchronized traced steps."""

from benchmark import spans


def read(run):
    got = spans.host_ms(run, "step", "render")
    return got and got["value"]
