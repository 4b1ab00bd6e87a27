"""A numpy canvas with the drawing calls of `utils/pdf.Page`, for
figures written as PNG.

Coordinates are points from the top-left corner, as on a PDF page,
rasterised at `dpi` (matplotlib's savefig default, 100). Images are
placed by nearest-neighbour sampling, lines stamped along their path,
and text drawn with `FONT_5X8`, a 5x8 ASCII bitmap font kept here, at
an integer multiple of its size.
"""

from __future__ import annotations

import numpy as np

# ASCII 32..126, five column bytes per glyph (bit 0 the top row)
FONT_5X8 = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462"
    "3649562050" "0008070300" "001c224100" "0041221c00" "2a1c7f1c2a" "08083e0808"
    "0080703000" "0808080808" "0000606000" "2010080402" "3e5149453e" "00427f4000"
    "7249494946" "2141494d33" "1814127f10" "2745454539" "3c4a494931" "4121110907"
    "3649494936" "464949291e" "0000140000" "0040340000" "0008142241" "1414141414"
    "0041221408" "0201590906" "3e415d594e" "7c1211127c" "7f49494936" "3e41414122"
    "7f4141413e" "7f49494941" "7f09090901" "3e41415173" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f021c027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "2649494932" "03017f0103" "3f4040403f"
    "1f2040201f" "3f4038403f" "6314081463" "0304780403" "6159494d43" "007f414141"
    "0204081020" "004141417f" "0402010204" "4040404040" "0003070800" "2054547840"
    "7f28444438" "3844444428" "384444287f" "3854545418" "00087e0902" "18a4a49c78"
    "7f08040478" "00447d4000" "2040403d00" "7f10284400" "00417f4000" "7c04780478"
    "7c08040478" "3844444438" "fc18242418" "18242418fc" "7c08040408" "4854545424"
    "04043f4424" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "4c9090907c"
    "4464544c44" "0008364100" "0000770000" "0041360800" "0201020402")


def glyphs(s: str) -> np.ndarray:
    """(8, 6 * len(s)) bool mask of `s`, one blank column after each glyph."""
    cols = []
    for c in s:
        code = ord(c) - 32 if 32 <= ord(c) < 127 else ord("?") - 32
        for byte in FONT_5X8[5 * code:5 * code + 5] + b"\0":
            cols.append([(byte >> r) & 1 for r in range(8)])
    return np.array(cols, bool).T.reshape(8, -1) if cols else np.zeros((8, 0), bool)


class Canvas:
    """A white RGB image of `width` by `height` points at `dpi`."""

    def __init__(self, width: float, height: float, dpi: float = 100.0):
        self.scale = dpi / 72.0
        self.pixels = np.full((max(1, round(height * self.scale)),
                               max(1, round(width * self.scale)), 3), 255, np.uint8)

    def _px(self, v: float) -> int:
        return int(round(v * self.scale))

    def image(self, img: np.ndarray, x: float, y: float, w: float, h: float) -> None:
        x0, y0 = self._px(x), self._px(y)
        pw, ph = max(1, self._px(x + w) - x0), max(1, self._px(y + h) - y0)
        rows = (np.arange(ph) * img.shape[0]) // ph
        cols = (np.arange(pw) * img.shape[1]) // pw
        self._paste(img[rows][:, cols], x0, y0)

    def _paste(self, tile: np.ndarray, x0: int, y0: int, mask: np.ndarray | None = None):
        H, W = self.pixels.shape[:2]
        ys, xs = max(0, -y0), max(0, -x0)
        ye, xe = min(tile.shape[0], H - y0), min(tile.shape[1], W - x0)
        if ye <= ys or xe <= xs:
            return
        region = self.pixels[y0 + ys:y0 + ye, x0 + xs:x0 + xe]
        part = tile[ys:ye, xs:xe]
        if mask is None:
            region[...] = part
        else:
            region[mask[ys:ye, xs:xe]] = part[mask[ys:ye, xs:xe]]

    def text(self, s: str, x: float, y: float, size: float, anchor: str = "left",
             vertical: bool = False) -> None:
        k = max(1, round(size * self.scale / 8))
        mask = np.repeat(np.repeat(glyphs(s), k, 0), k, 1)
        if vertical:
            mask = np.rot90(mask)
        tile = np.zeros(mask.shape + (3,), np.uint8)
        along = mask.shape[0] if vertical else mask.shape[1]
        shift = int({"left": 0.0, "center": 0.5, "right": 1.0}[anchor] * along)
        px, py = self._px(x), self._px(y)
        if vertical:  # the baseline is the column x, the text runs upwards from y
            self._paste(tile, px - mask.shape[1], py - mask.shape[0] + shift, mask)
        else:
            self._paste(tile, px - shift, py - mask.shape[0], mask)

    def polyline(self, points, color=(0.0, 0.0, 0.0), width: float = 1.0,
                 dashed: bool = False) -> None:
        pts = np.asarray(points, np.float64) * self.scale
        rgb = np.round(np.asarray(color) * 255).astype(np.uint8)
        r = max(0, round(width * self.scale / 2))
        walked = 0.0
        for a, b in zip(pts[:-1], pts[1:]):
            length = float(np.hypot(*(b - a)))
            n = max(2, int(length * 2) + 1)
            for t in np.linspace(0.0, 1.0, n):
                if dashed and (walked + t * length) % (7 * self.scale) > 4 * self.scale:
                    continue
                cx, cy = np.round(a + t * (b - a)).astype(int)
                self.pixels[max(0, cy - r):cy + r + 1, max(0, cx - r):cx + r + 1] = rgb
            walked += length

    def rect(self, x: float, y: float, w: float, h: float, width: float = 0.8) -> None:
        self.polyline([(x, y), (x + w, y), (x + w, y + h), (x, y + h), (x, y)], width=width)
