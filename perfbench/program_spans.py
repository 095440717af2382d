"""The program's own spans, as the per-layer readers read them: the records
of ``ai_font_renderer_tpu_torch.utils.profiling.spans()``. Spans are on
while a torch profiler window is open, so the records with a device time
are those of the traced stretch; the first call of each span name is
recorded with host times only, traced or not. A program without spans
gives None."""

from __future__ import annotations

import statistics


def records() -> list | None:
    """The program's span records, or None where it has none, or where some
    were dropped at its cap (a median of what is left would mislead)."""
    try:
        from ai_font_renderer_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None or profiling.spans_dropped():
        return None
    return read() or None


def median_device_ms(run: dict, name: str):
    """The median over the traced steps of span ``name``'s device time
    (ms): the device's time between the span's edges, with the device's
    idle time inside the span included. None outside a training cell or
    where no record of ``name`` has a device time."""
    if run["kind"] != "train":
        return None
    values = [r["device_ms"] for r in records() or () if r["name"] == name and r["device_ms"] is not None]
    return statistics.median(values) if values else None
