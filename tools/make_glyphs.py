#!/usr/bin/env python3
"""Write the port's default glyph set, `garden_tpu_torch/render/glyphs_default.npz`.

Rasterizes PIL's default font at its default size with
`render.text.FontAtlas` and saves it with `FontAtlas.save_glyphs`, so that
`FontAtlas.load_glyphs` can rebuild the same atlas where PIL is missing.
Needs PIL. Run from the repository root: `python3 tools/make_glyphs.py`.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from garden_tpu_torch.render import sprites, text  # noqa: E402


def main() -> None:
    font = text.FontAtlas(sprites.TextureAtlas(256))
    font.save_glyphs(str(text.DEFAULT_GLYPHS))
    print(f"wrote {len(font.glyphs)} glyphs, {len(font.kerning)} kerning pairs to "
          f"{text.DEFAULT_GLYPHS}")


if __name__ == "__main__":
    main()
