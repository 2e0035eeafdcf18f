"""ui_pixel_use_pct.engine: 100 x the pixels inside a HUD sprite's rect
(each rect clipped to the frame) over the pixels the composite's loop
passes over (a full frame a sprite), the `ui_pixels_covered` and
`ui_pixels` counters of the program's `ui` spans in the `step` root
steps, with both a traced step."""

from benchmark import spans


def read(run):
    return spans.ratio_pct(run, "step", "ui", "ui_pixels_covered", "ui_pixels")
