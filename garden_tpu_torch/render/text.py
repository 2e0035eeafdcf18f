"""Text: a glyph atlas and text as sprites.

Port of `garden_tpu.render.text`. Glyphs are rasterized on the host with
PIL's FreeType binding and packed into the shared sprite atlas, each with
its real advance (`font.getlength`), its bearing (the ink box's offset
from the pen origin) and the face's ascent and descent; kerning pairs are
measured with the font's own layout, kern(a, b) = len(a + b) - len(a) -
len(b), keeping the nonzero ones. Text becomes a run of sprites drawn by
`sprites.composite_sprites`. Without PIL, `FontAtlas` raises RuntimeError.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from garden_tpu_torch.render.sprites import Sprite, SpriteBatch, TextureAtlas

try:
    from PIL import Image, ImageDraw, ImageFont
    _HAS_PIL = True
except ImportError:
    _HAS_PIL = False


class FontAtlas:
    """A rasterized glyph set packed into a TextureAtlas."""

    CHARS = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
             "0123456789 .,:;!?+-*/=()[]{}<>_#%&@'\"~^|\\$")

    def __init__(self, atlas: TextureAtlas, font_path: Optional[str] = None,
                 size: int = 16):
        if not _HAS_PIL:
            raise RuntimeError("PIL required for font rasterization")
        self.atlas = atlas
        self.size = size
        font = ImageFont.truetype(font_path, size) if font_path else ImageFont.load_default()
        self.font = font
        try:
            self.ascent, self.descent = font.getmetrics()
        except AttributeError:  # the default bitmap font
            self.ascent, self.descent = size, max(size // 4, 1)
        # glyphs[ch] = (atlas region, advance, bearing_x, bearing_y)
        self.glyphs: Dict[str, Tuple[Tuple[int, int, int, int], float, int, int]] = {}
        for ch in self.CHARS:
            x0, y0, x1, y1 = font.getbbox(ch)       # the ink box from the pen origin
            w = max(x1 - x0, 1)
            h = max(y1 - y0, 1)
            img = Image.new("L", (w, h), 0)
            ImageDraw.Draw(img).text((-x0, -y0), ch, fill=255, font=font)
            arr = np.asarray(img, np.float32) / 255.0
            region = atlas.add(np.stack([np.ones_like(arr)] * 3 + [arr], axis=-1))
            try:
                advance = float(font.getlength(ch))
            except AttributeError:
                advance = float(x1)
            self.glyphs[ch] = (region, advance, x0, y0)
        self.kerning: Dict[Tuple[str, str], float] = {}
        if hasattr(font, "getlength"):
            singles = {ch: float(font.getlength(ch)) for ch in self.CHARS}
            for a in self.CHARS:
                for b in self.CHARS:
                    k = float(font.getlength(a + b)) - singles[a] - singles[b]
                    if abs(k) > 1e-3:
                        self.kerning[(a, b)] = k

    def measure(self, text: str) -> float:
        """The line's width: advances and kerning; a glyph the atlas lacks
        advances half the size."""
        w = 0.0
        prev = None
        for ch in text:
            entry = self.glyphs.get(ch)
            if entry is None:
                w += self.size / 2
                prev = None
                continue
            if prev is not None:
                w += self.kerning.get((prev, ch), 0.0)
            w += entry[1]
            prev = ch
        return w

    def line_height(self) -> int:
        return self.ascent + self.descent

    def draw(self, batch: SpriteBatch, text: str, x: float, y: float,
             color=(1.0, 1.0, 1.0, 1.0), scale: float = 1.0) -> None:
        """Append the text's glyph sprites to a batch: (x, y) is the top
        left of the line's em box, each quad at pen + bearing, so
        baselines align."""
        pen = x
        prev = None
        for ch in text:
            entry = self.glyphs.get(ch)
            if entry is None:
                pen += (self.size / 2) * scale
                prev = None
                continue
            region, adv, bx, by = entry
            if prev is not None:
                pen += self.kerning.get((prev, ch), 0.0) * scale
            _, _, gw, gh = region
            batch.push(Sprite(pen + bx * scale, y + by * scale, gw * scale, gh * scale,
                              region, color))
            pen += adv * scale
            prev = ch
