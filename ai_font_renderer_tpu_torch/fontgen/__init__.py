"""Host-side text and image helpers of the port (no dataset synthesis yet)."""

from .bmp import encode_bmp, read_bmp, write_bmp
from .layout import encode_codes

__all__ = ["encode_bmp", "encode_codes", "read_bmp", "write_bmp"]
