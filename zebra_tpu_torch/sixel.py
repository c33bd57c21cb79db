"""Minimal sixel encoder: render query-hit images inline in the terminal (the
port's own copy of ``zebra_tpu/sixel.py``, unchanged below).

The reference CLI draws retrieved images straight into the terminal with the
viuer crate (``src/main.rs:217-247``); this is the dependency-free Python
analogue for sixel-capable terminals (xterm -ti vt340, mlterm, wezterm,
foot, iTerm2 ...). Pure stdlib + PIL + numpy; no escape-sequence libraries.

Format refresher: ``ESC P q`` enters sixel mode; ``#i;2;R;G;B`` defines
palette color ``i`` (RGB in 0..100); image data is bands of 6 pixel rows —
per color, one character per column whose low 6 bits select the rows set in
that band (offset by 63), ``!n`` run-length-repeats the next character,
``$`` rewinds to the band start (to overlay the next color), ``-`` moves to
the next band; ``ESC \\`` exits.
"""

from __future__ import annotations

import io

import numpy as np

_COLORS = 64


def sixel_encode(image_bytes: bytes, max_width: int = 320) -> str:
    """Encode image bytes (any PIL-readable container) as a sixel string."""
    from PIL import Image

    img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
    if img.width > max_width:
        img = img.resize(
            (max_width, max(1, img.height * max_width // img.width))
        )
    pal_img = img.convert("P", palette=Image.ADAPTIVE, colors=_COLORS)
    # PIL truncates the palette to the colors actually used — pad it out
    palette = (pal_img.getpalette() or []) + [0] * (3 * _COLORS)
    palette = palette[: 3 * _COLORS]
    px = np.asarray(pal_img, dtype=np.uint8)  # [h, w] palette indices
    h, w = px.shape

    out = [f'\x1bPq"1;1;{w};{h}']
    for i in range(_COLORS):
        r, g, b = palette[3 * i : 3 * i + 3]
        out.append(f"#{i};2;{r * 100 // 255};{g * 100 // 255};{b * 100 // 255}")

    weights = (1 << np.arange(6, dtype=np.uint8))[:, None]  # [6, 1]
    for y0 in range(0, h, 6):
        band = px[y0 : y0 + 6]  # [<=6, w]
        rows = band.shape[0]
        colors = np.unique(band)
        for ci, color in enumerate(colors):
            bits = ((band == color) * weights[:rows]).sum(axis=0)  # [w] 0..63
            out.append(f"#{color}{_rle(bits)}")
            out.append("$" if ci + 1 < len(colors) else "-")
    out.append("\x1b\\")
    return "".join(out)


def _rle(bits: np.ndarray) -> str:
    """Run-length encode one color's band row (chars are 63 + 6-bit mask)."""
    chunks = []
    start = 0
    n = len(bits)
    boundaries = np.nonzero(np.diff(bits))[0] + 1
    for end in list(boundaries) + [n]:
        run = end - start
        ch = chr(63 + int(bits[start]))
        if run > 3:
            chunks.append(f"!{run}{ch}")
        else:
            chunks.append(ch * run)
        start = end
    return "".join(chunks)


def terminal_supports_sixel() -> bool:
    """Best-effort detection (overridable by forcing ``--preview``)."""
    import os

    term = os.environ.get("TERM", "")
    return "sixel" in term or term in ("mlterm", "yaft-256color", "foot")
