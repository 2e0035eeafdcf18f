"""tile_pairs_dropped_pct.play: 100 x the (tile, triangle) pairs the frame's
binnings (main raster and cascades) cut off at their caps over the pairs
they binned, the `tile_pairs_dropped` and `tile_pairs` counters of the
`step` root steps, with both a traced step."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", None, "tile_pairs_dropped", "tile_pairs")
