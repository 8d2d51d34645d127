"""Title-card / settings-overlay rendering for generated tracks (a copy of
``audiocraft_tpu/io/titlecard.py``, PIL only, which the port may not
import).

Capability counterpart of the fork's PIL pipeline
(the reference's ``audiocraft/utils/extend.py``:239-440: color parsing,
font loading, centered wrapped title + settings text over a background).
Re-designed for a network-free host: fonts resolve from local paths or PIL's
default bitmap font; no hub/url downloads.
"""

from __future__ import annotations

import re
import textwrap
import typing as tp
from pathlib import Path

from PIL import Image, ImageColor, ImageDraw, ImageFont

ColorLike = tp.Union[str, tp.Tuple[float, ...]]


def parse_color(color: ColorLike, default=(255, 255, 0, 255)) -> tp.Tuple[int, int, int, int]:
    """Any of '#rrggbb[aa]', 'rgb(...)', 'rgba(...)', a named color, or a
    3/4-tuple -> RGBA ints.  Falls back to `default` on garbage (the UI
    passes through user-typed strings)."""
    def clamp(v: float) -> int:
        return max(0, min(255, int(round(v))))

    if isinstance(color, tuple) and len(color) in (3, 4):
        r, g, b = (clamp(c) for c in color[:3])
        a = color[3] if len(color) == 4 else 255
        return (r, g, b, clamp(a * 255) if isinstance(a, float) and a <= 1 else clamp(a))
    if isinstance(color, str):
        text = color.strip()
        try:
            return ImageColor.getcolor(text, "RGBA")
        except ValueError:
            pass
        m = re.match(r"rgba?\(\s*([\d.]+)\s*,\s*([\d.]+)\s*,\s*([\d.]+)"
                     r"(?:\s*,\s*([\d.]+))?\s*\)", text)
        if m:
            r, g, b = (clamp(float(v)) for v in m.groups()[:3])
            a_raw = m.group(4)
            a = 255 if a_raw is None else float(a_raw)
            return (r, g, b, clamp(a * 255) if a <= 1 else clamp(a))
    return default


def load_font(font: tp.Optional[str], size: int) -> ImageFont.ImageFont:
    """Local font path (or bare name resolvable by PIL) -> FreeType font;
    falls back to the built-in bitmap font rather than touching the network."""
    if font:
        for candidate in (font, str(Path(font).expanduser())):
            try:
                return ImageFont.truetype(candidate, size)
            except OSError:
                continue
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL: no size kwarg
        return ImageFont.load_default()


def _center_wrapped(draw: ImageDraw.ImageDraw, text: str, font, width: int,
                    y: int, color) -> int:
    """Draw wrapped text centered horizontally at vertical offset y; returns
    the y just below the drawn block."""
    if not text:
        return y
    wrapped = "\n".join(textwrap.wrap(text, max(8, width // 12)))
    box = draw.multiline_textbbox((0, 0), wrapped, font=font, align="center")
    x = max((width - (box[2] - box[0])) // 2, 0)
    draw.multiline_text((x, y), wrapped, fill=color, font=font,
                        align="center")
    return y + (box[3] - box[1])


def render_title_card(title: str = "", description: str = "",
                      width: int = 768, height: int = 512,
                      background: tp.Optional[str] = None,
                      font: tp.Optional[str] = None,
                      font_color: ColorLike = "#ffffff",
                      font_size: int = 28) -> Image.Image:
    """Compose the card: background (image path or solid), centered wrapped
    title near the top, settings/description text below at 2/3 size."""
    if background and Path(background).is_file():
        base = Image.open(background).convert("RGBA")
        if base.size != (width, height):
            base = base.resize((width, height))
    else:
        base = Image.new("RGBA", (width, height), (20, 20, 24, 255))
    overlay = Image.new("RGBA", (width, height), (255, 255, 255, 0))
    draw = ImageDraw.Draw(overlay)
    color = parse_color(font_color)
    y = 10
    y = _center_wrapped(draw, title, load_font(font, font_size),
                        width, y, color)
    _center_wrapped(draw, description, load_font(font, font_size * 2 // 3),
                    width, y + 20, color)
    base.alpha_composite(overlay)
    return base


def settings_text(metadata: tp.Mapping[str, tp.Any]) -> str:
    """Human-readable settings block for the overlay (the fork embeds the
    generation parameters on the card, app.py:469-538)."""
    order = ["prompt", "model", "Seed", "duration", "topk", "topp",
             "temperature", "cfg_coef"]
    parts = [f"{k}: {metadata[k]}" for k in order if k in metadata]
    extra = [f"{k}: {v}" for k, v in metadata.items()
             if k not in order and isinstance(v, (str, int, float))]
    return " | ".join(parts + extra)
