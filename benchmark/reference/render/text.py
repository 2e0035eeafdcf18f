"""Text: a glyph atlas and text as sprites.

Port of `garden_tpu.render.text`. Glyphs are rasterized on the host with
PIL's FreeType binding and packed into the shared sprite atlas, each with
its real advance (`font.getlength`), its bearing (the ink box's offset
from the pen origin) and the face's ascent and descent; kerning pairs are
measured with the font's own layout, kern(a, b) = len(a + b) - len(a) -
len(b), keeping the nonzero ones. Text becomes a run of sprites drawn by
`sprites.composite_sprites`. Without PIL, `FontAtlas` raises RuntimeError.

`save_glyphs` writes a rasterized glyph set (alpha images, advances,
bearings, metrics, kerning) to an .npz, and `FontAtlas.load_glyphs` packs
such a file into an atlas without PIL, giving the same atlas and layout as
the font it was written from. `DEFAULT_GLYPHS` is PIL's default font at
the default size (written by `tools/make_glyphs.py`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from benchmark.reference.render.sprites import Sprite, SpriteBatch, TextureAtlas

try:
    from PIL import Image, ImageDraw, ImageFont
    _HAS_PIL = True
except ImportError:
    _HAS_PIL = False


DEFAULT_GLYPHS = Path(__file__).resolve().parent / "glyphs_default.npz"


def _glyph_rgba(alpha: np.ndarray) -> np.ndarray:
    """A glyph's atlas image: white, its coverage in alpha."""
    return np.stack([np.ones_like(alpha)] * 3 + [alpha], axis=-1)


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
            region = atlas.add(_glyph_rgba(arr))
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

    def save_glyphs(self, path: str) -> None:
        """Write the glyph set to `path` (.npz): each glyph's 8-bit coverage
        read back from the atlas, its advance and bearing, the face's
        metrics and the kerning pairs."""
        chars = "".join(self.glyphs)
        alphas, shapes, metrics = [], [], []
        for ch in chars:
            (x, y, w, h), adv, bx, by = self.glyphs[ch]
            alphas.append(np.rint(self.atlas.data[y:y + h, x:x + w, 3] * 255.0)
                          .astype(np.uint8).ravel())
            shapes.append((w, h))
            metrics.append((adv, bx, by))
        pairs = sorted(self.kerning)
        np.savez_compressed(
            path, chars=np.array(chars), alpha=np.concatenate(alphas),
            shapes=np.array(shapes, np.int32), metrics=np.array(metrics, np.float64),
            face=np.array([self.size, self.ascent, self.descent], np.int32),
            kern_pairs=np.array(["".join(p) for p in pairs]),
            kern=np.array([self.kerning[p] for p in pairs], np.float64))

    @classmethod
    def load_glyphs(cls, atlas: TextureAtlas, path=DEFAULT_GLYPHS) -> "FontAtlas":
        """A FontAtlas from a `save_glyphs` file, packed into `atlas` in the
        file's glyph order; needs no PIL."""
        self = cls.__new__(cls)
        self.atlas = atlas
        with np.load(path) as f:
            chars, alpha, shapes = str(f["chars"]), f["alpha"], f["shapes"]
            metrics, face = f["metrics"], f["face"]
            kern_pairs, kern = f["kern_pairs"], f["kern"]
        self.size, self.ascent, self.descent = (int(v) for v in face)
        self.font = None
        self.glyphs = {}
        at = 0
        for ch, (w, h), (adv, bx, by) in zip(chars, shapes, metrics):
            arr = alpha[at:at + w * h].reshape(h, w).astype(np.float32) / 255.0
            at += w * h
            self.glyphs[ch] = (atlas.add(_glyph_rgba(arr)), float(adv), int(bx), int(by))
        self.kerning = {(str(p)[0], str(p)[1]): float(k) for p, k in zip(kern_pairs, kern)}
        return self

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
