"""contact_slot_use_pct.tick: 100 x the touching contact pairs over the
solver's pair slots (bodies x K_act), the `touching_pairs` and `pair_slots`
counters of the program's `physics` spans, with both a traced step."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "physics", "physics", "touching_pairs", "pair_slots")
