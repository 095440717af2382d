"""Inference: batched string rendering and atlas generation."""

from .render import render_atlas, render_batch, render_batch_u8_async, render_strings

__all__ = ["render_atlas", "render_batch", "render_batch_u8_async", "render_strings"]
