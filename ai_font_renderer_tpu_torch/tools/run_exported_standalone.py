#!/usr/bin/env python
"""Run a torch.export render artifact with no model code.

The port's counterpart of tools/run_exported_standalone.py: the
deployment-side proof of the ``export`` contract (utils/export.py). It
imports ``torch`` and ``numpy`` and renders strings to BMP files from the
artifact alone: int32[b, max_length] codes in, uint8[b, H, W] sheets out,
the batch symbolic, the contract in the program's shapes.

An artifact whose graph calls the port's kernels as operators (``export
--kernels ...`` or ``--int8``; its ``afr.json`` lists them) needs those
operators registered before it loads: for such an artifact, and only then,
this script imports ``ai_font_renderer_tpu_torch.ops``, the operator library,
which imports nothing else of the port (it builds the CUDA kernels from its
sources at first use on the card). An artifact without them needs torch and
numpy alone.

Usage:
    python run_exported_standalone.py ARTIFACT OUT_DIR STRING... [--device cpu|cuda]

The device is the card unless ``--device cpu`` is given, and must be one of
the platforms the artifact was exported for.
"""

import json
import os
import struct
import sys
import zipfile

import numpy as np


def encode(strings, max_length):
    """Strings -> int32[b, max_length] ASCII codes masked to 7 bits,
    zero-padded or cut (the package's encode_codes)."""
    out = np.zeros((len(strings), max_length), dtype=np.int32)
    for i, s in enumerate(strings):
        codes = [ord(c) & 0x7F for c in s[:max_length]]
        out[i, : len(codes)] = codes
    return out


def write_bmp_gray(path, img):
    """uint8[H, W] -> 24-bit BGR top-down BMP (the reference byte format)."""
    h, w = img.shape
    row = (w * 3 + 3) & ~3
    size = 54 + row * h
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, row * h, 2835, 2835, 0, 0))
        pad = b"\x00" * (row - w * 3)
        for y in range(h):
            f.write(np.repeat(img[y], 3).tobytes() + pad)


def read_meta(path):
    """The artifact's afr.json: platforms, operators, sheets per call."""
    with zipfile.ZipFile(path) as z:
        (name,) = [n for n in z.namelist() if n.endswith("extra/afr.json")]
        return json.loads(z.read(name))


def main(argv):
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    if len(argv) < 2:
        print(__doc__)
        return 1
    artifact, out_dir, strings = argv[0], argv[1], argv[2:] or ["HELLO WORLD"]

    import torch
    from torch.export.passes import move_to_device_pass

    meta = read_meta(artifact)
    if device not in meta["platforms"]:
        print(f"{artifact} was exported for {meta['platforms']}, not {device}")
        return 1
    if device == "cuda" and not torch.cuda.is_available():
        print("--device cuda, but torch.cuda.is_available() is False; pass --device cpu")
        return 1
    if meta["operators"]:
        import ai_font_renderer_tpu_torch.ops  # noqa: F401  (registers the afr:: operators)
    # float32 products at full precision, as the package runs them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = torch.export.load(artifact)
    if device != "cpu":
        program = move_to_device_pass(program, device)
    (name,) = program.graph_signature.user_inputs
    codes_node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    max_length = int(codes_node.meta["val"].shape[1])

    module = program.module()
    codes = torch.from_numpy(encode(strings, max_length)).to(device)
    step = meta["sheets_per_call"] or len(strings)
    with torch.inference_mode():
        sheets = torch.cat([module(codes[i : i + step]) for i in range(0, len(strings), step)])
    sheets = sheets.cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    for i, sheet in enumerate(sheets):
        write_bmp_gray(os.path.join(out_dir, f"string_{i}.bmp"), sheet)
    print(f"standalone: rendered {len(sheets)} sheets {sheets.shape[1:]} to {out_dir}/ on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
