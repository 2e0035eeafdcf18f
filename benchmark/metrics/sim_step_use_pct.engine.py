"""sim_step_use_pct.engine: 100 x the physics steps the fixed-rate
accumulator keeps over the steps it runs (`world.simulate` runs
max_steps_per_tick a tick and keeps the first nsteps), the
`sim_steps_kept` and `sim_steps_run` counters of every span of the
program's `step` root steps, with both a traced step."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", None, "sim_steps_kept", "sim_steps_run")
