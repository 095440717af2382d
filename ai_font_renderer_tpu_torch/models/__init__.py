"""Models of the port."""

from . import font_renderer
from .font_renderer import AttentionFontRenderer

__all__ = ["AttentionFontRenderer", "font_renderer"]
