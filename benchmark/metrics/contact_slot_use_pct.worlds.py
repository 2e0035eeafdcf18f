"""contact_slot_use_pct.worlds: 100 x the touching contact pairs over the
solver's pair slots (bodies x K_act x worlds), the `touching_pairs` and
`pair_slots` counters of the program's `shard` spans over every world, with
both a traced step."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "worlds.step", "shard", "touching_pairs", "pair_slots")
