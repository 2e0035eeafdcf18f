"""ssgi_lit_pct.ultra: 100 x the pixels whose GI is above 0 before the
upsample over the pixels gathered at the march resolution, the
`ssgi_pixels_lit` and `ssgi_pixels` counters of the program's `ssgi` spans
in the `step` root steps."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", "ssgi", "ssgi_pixels_lit", "ssgi_pixels")
