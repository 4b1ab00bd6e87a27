"""A minimal PDF 1.4 writer in the standard library (zlib) and numpy.

The JAX package draws its figures with matplotlib, which the card's
machine lacks. This writes pages of a given size (in points, 72 to the
inch) that hold RGB images as Flate-compressed image XObjects at their
own pixels, text in the base-14 Helvetica font (which every reader
has, so no font file is embedded), rectangles and polylines. Page
coordinates here run from the top-left corner, y down; they are flipped
to PDF's bottom-left origin on output.
"""

from __future__ import annotations

import zlib

import numpy as np

# Helvetica's advance widths (1/1000 em) for ASCII 32..126, from its AFM
HELVETICA_WIDTHS = (
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333, 278, 278,
    556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278, 584, 584, 584, 556,
    1015, 667, 667, 722, 722, 667, 611, 778, 722, 278, 500, 667, 556, 833, 722, 778,
    667, 778, 722, 667, 611, 722, 667, 944, 667, 667, 611, 278, 278, 278, 469, 556,
    333, 556, 556, 500, 556, 556, 278, 556, 556, 222, 222, 500, 222, 833, 556, 556,
    556, 556, 333, 500, 278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584)


def _ascii(s: str) -> str:
    return "".join(c if 32 <= ord(c) < 127 else "?" for c in s)


def text_width(s: str, size: float) -> float:
    """The width in points of `s` set in Helvetica at `size` points."""
    return sum(HELVETICA_WIDTHS[ord(c) - 32] for c in _ascii(s)) * size / 1000.0


def _num(v: float) -> str:
    return f"{v:.3f}".rstrip("0").rstrip(".")


class Page:
    """One page: drawing calls append to its content stream."""

    def __init__(self, width: float, height: float):
        self.width, self.height = width, height
        self.images: list[np.ndarray] = []
        self._ops: list[str] = []

    def image(self, img: np.ndarray, x: float, y: float, w: float, h: float) -> None:
        """Place an (H, W, 3) uint8 RGB image in the box whose top-left
        corner is (x, y), w by h points."""
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"images must be (H, W, 3) uint8, got {img.shape} {img.dtype}")
        self.images.append(np.ascontiguousarray(img))
        self._ops.append(f"q {_num(w)} 0 0 {_num(h)} {_num(x)} {_num(self.height - y - h)} "
                         f"cm /Im{len(self.images) - 1} Do Q")

    def text(self, s: str, x: float, y: float, size: float, anchor: str = "left",
             vertical: bool = False) -> None:
        """`s` with its baseline through (x, y), starting there ("left"),
        centred on it or ending there; `vertical` runs it bottom to top."""
        s = _ascii(s)
        shift = {"left": 0.0, "center": 0.5, "right": 1.0}[anchor] * text_width(s, size)
        yy = self.height - y
        if vertical:
            matrix = f"0 1 -1 0 {_num(x)} {_num(yy - shift)}"
        else:
            matrix = f"1 0 0 1 {_num(x - shift)} {_num(yy)}"
        escaped = s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
        self._ops.append(f"BT /F1 {_num(size)} Tf {matrix} Tm ({escaped}) Tj ET")

    def polyline(self, points, color=(0.0, 0.0, 0.0), width: float = 1.0,
                 dashed: bool = False) -> None:
        """A stroked line through `points` ((N, 2) page coordinates)."""
        pts = np.asarray(points, np.float64)
        path = " ".join(f"{_num(px)} {_num(self.height - py)} {'m' if i == 0 else 'l'}"
                        for i, (px, py) in enumerate(pts))
        dash = "[4 3] 0 d " if dashed else ""
        r, g, b = color
        self._ops.append(f"q {_num(r)} {_num(g)} {_num(b)} RG {_num(width)} w {dash}{path} S Q")

    def rect(self, x: float, y: float, w: float, h: float, width: float = 0.8) -> None:
        """A black frame around the box whose top-left corner is (x, y)."""
        self._ops.append(f"q 0 0 0 RG {_num(width)} w {_num(x)} {_num(self.height - y - h)} "
                         f"{_num(w)} {_num(h)} re S Q")

    def content(self) -> bytes:
        return "\n".join(self._ops).encode("latin-1")


class Document:
    """Pages in order, written out by `save`."""

    def __init__(self):
        self.pages: list[Page] = []

    def add_page(self, width: float, height: float) -> Page:
        page = Page(width, height)
        self.pages.append(page)
        return page

    def save(self, path: str) -> str:
        # objects: 1 catalog, 2 page tree, 3 font, then per page its page
        # object, its content stream and its images
        objects: list[bytes] = [b"", b"", b"<< /Type /Font /Subtype /Type1 /BaseFont "
                                          b"/Helvetica /Encoding /WinAnsiEncoding >>"]
        kids = []
        for page in self.pages:
            page_id = len(objects) + 1
            kids.append(page_id)
            objects += [b"", b""]
            xobjects = []
            for i, img in enumerate(page.images):
                h, w, _ = img.shape
                data = zlib.compress(img.tobytes(), 6)
                objects.append(
                    f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} /ColorSpace "
                    f"/DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode /Length {len(data)} "
                    f">>\nstream\n".encode() + data + b"\nendstream")
                xobjects.append(f"/Im{i} {len(objects)} 0 R")
            data = zlib.compress(page.content(), 6)
            objects[page_id] = (f"<< /Filter /FlateDecode /Length {len(data)} >>\nstream\n"
                                .encode() + data + b"\nendstream")
            objects[page_id - 1] = (
                f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {_num(page.width)} "
                f"{_num(page.height)}] /Resources << /Font << /F1 3 0 R >> /XObject << "
                f"{' '.join(xobjects)} >> >> /Contents {page_id + 1} 0 R >>").encode()
        objects[0] = b"<< /Type /Catalog /Pages 2 0 R >>"
        objects[1] = (f"<< /Type /Pages /Kids [{' '.join(f'{k} 0 R' for k in kids)}] "
                      f"/Count {len(kids)} >>").encode()
        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for i, body in enumerate(objects, 1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref = len(out)
        out += f"xref\n0 {len(objects) + 1}\n0000000000 65535 f \n".encode()
        out += b"".join(f"{o:010d} 00000 n \n".encode() for o in offsets)
        out += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\nstartxref\n{xref}\n"
                f"%%EOF\n").encode()
        with open(path, "wb") as f:
            f.write(out)
        return path
