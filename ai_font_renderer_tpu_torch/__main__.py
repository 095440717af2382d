"""``python -m ai_font_renderer_tpu_torch`` entry point."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
