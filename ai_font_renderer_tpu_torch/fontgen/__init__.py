"""Host-side data pipeline of the port: TTF parsing, rasterization, the
seeded corpus, layout (monospace and proportional), GSUB/GPOS shaping, the
BMP codec, and sheet synthesis on the device."""

from .atlas import GlyphAtlas, bake_atlas
from .bmp import encode_bmp, read_bmp, write_bmp
from .dataset import DeviceDataset, build_device_dataset, build_device_dataset_prop, build_layouts
from .glyphs import coverage_to_sdf, rasterize_charset, sdf_charset, unicode_charset
from .kerning import KerningTable
from .layout import AdvanceTable, encode_codes, encode_grids, wrap_text
from .proportional import (
    PropAtlas,
    bake_prop_atlas,
    encode_prop_grids,
    synthesize_prop_host,
    synthesize_prop_sheets,
)
from .sheets import SynthOps, make_synth_ops, synthesize_sheets, synthesize_sheets_host
from .textgen import generate_corpus, generate_text
from .ttf import TrueTypeFont

__all__ = [
    "AdvanceTable",
    "DeviceDataset",
    "GlyphAtlas",
    "KerningTable",
    "PropAtlas",
    "SynthOps",
    "TrueTypeFont",
    "bake_atlas",
    "bake_prop_atlas",
    "build_device_dataset",
    "build_device_dataset_prop",
    "build_layouts",
    "coverage_to_sdf",
    "encode_bmp",
    "encode_codes",
    "encode_grids",
    "encode_prop_grids",
    "generate_corpus",
    "generate_text",
    "make_synth_ops",
    "rasterize_charset",
    "read_bmp",
    "sdf_charset",
    "synthesize_prop_host",
    "synthesize_prop_sheets",
    "synthesize_sheets",
    "synthesize_sheets_host",
    "unicode_charset",
    "wrap_text",
    "write_bmp",
]
