"""raster_roofline_pct.sim: the least time the main raster (K1) and the
split shadow atlas (K2, K3) need, over the device time of the program's
`raster` and `csm_render` ranges, in %: `raster_roofline_pct.play`'s
reader, whose counts take the file's `cascade_sizes` (here 2048, 1024 and
1024: 6.29 M atlas texels against play's 12.58 M). `csm_render` here also
draws the translucent casters' map (K4, then K6's tint), which play does
not have: its time is in the denominator and none of its work in the
least time, so the share reads lower than the opaque atlas alone would."""

from benchmark import harness


def read(run):
    return harness.reader("raster_roofline_pct.play")(run)
