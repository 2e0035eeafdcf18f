"""physics_host_ms.tick: host ms a traced step of the program's `physics`
span (CombinedStep.physics, the root of the headless step)."""

from benchmark import spans


def read(run):
    got = spans.host_ms(run, "physics", "physics")
    return got and got["value"]
