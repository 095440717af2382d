"""Host-side data pipeline of the port: TTF parsing, rasterization, the
seeded corpus, layout, the BMP codec, and sheet synthesis on the device."""

from .atlas import GlyphAtlas, bake_atlas
from .bmp import encode_bmp, read_bmp, write_bmp
from .dataset import DeviceDataset, build_device_dataset, build_layouts
from .layout import AdvanceTable, encode_codes, encode_grids, wrap_text
from .sheets import make_synth_ops, synthesize_sheets, synthesize_sheets_host
from .textgen import generate_corpus, generate_text

__all__ = [
    "AdvanceTable",
    "DeviceDataset",
    "GlyphAtlas",
    "bake_atlas",
    "build_device_dataset",
    "build_layouts",
    "encode_bmp",
    "encode_codes",
    "encode_grids",
    "generate_corpus",
    "generate_text",
    "make_synth_ops",
    "read_bmp",
    "synthesize_sheets",
    "synthesize_sheets_host",
    "wrap_text",
    "write_bmp",
]
