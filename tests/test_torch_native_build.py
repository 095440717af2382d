"""The JAX package's native libraries for the port's tests, and tests of
that build.

The JAX package compiles ``fontgen/native/<name>.cpp`` at first use straight
to ``native/lib<name>.so``, guarded by a thread lock alone
(``ai_font_renderer_tpu/fontgen/native.py``). Test processes that run side
by side race on that file: one that dlopens it half-written gets OSError,
caches None, and from then on takes the pure-Python rasterizer, whose bits
differ from the native one's; an equality test of the port against the JAX
package then fails on arrays, not on the build.

:func:`install_reference_native` keeps the port's tests out of that race.
It compiles the same sources with the JAX package's flags into a private
directory under a cross-process ``fcntl.flock``, to a temporary file that
``os.replace`` renames to a name keyed by the source's hash, and installs
the loaded libraries as the JAX module's own for this process. So no port
test writes ``ai_font_renderer_tpu/fontgen/native/*.so`` or loads one that
another process is still writing, and both packages still run the same C++
source compiled natively. Every port test file that reaches the JAX
package's fontgen calls it at import. The JAX package's own tests keep
their race among themselves (ROADMAP §3, "In the reference itself").
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO, "ai_font_renderer_tpu_torch", "_build", "reference_native")
NAMES = ("rasterizer", "corpus")
# The JAX package's g++ flags (ai_font_renderer_tpu/fontgen/native.py).
JAX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def build_reference_library(name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile the JAX package's ``native/<name>.cpp`` into ``build_dir``
    once for all processes -> the path of the library."""
    from ai_font_renderer_tpu.fontgen import native as jnative

    src = os.path.join(jnative._NATIVE_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(JAX_FLAGS).encode()).hexdigest()[:12]
    so = os.path.join(build_dir, f"lib{name}-{digest}.so")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".tmp")
            os.close(fd)
            try:
                done = subprocess.run(["g++", *JAX_FLAGS, src, "-o", tmp], capture_output=True, text=True)
                if done.returncode:
                    raise RuntimeError(f"g++ could not build {src}: {done.stderr[-2000:]}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return so


def install_reference_native(build_dir: str = BUILD_DIR) -> None:
    """Load the privately built libraries as the JAX module's own in this
    process (replacing whatever it cached, None included) and check that
    the JAX rasterizer is native."""
    from ai_font_renderer_tpu.fontgen import native as jnative

    with jnative._LOCK:
        for name in NAMES:
            lib = jnative._LIBS.get(name)
            if lib is None or not getattr(lib, "_private_build", False):
                lib = ctypes.CDLL(build_reference_library(name, build_dir))
                lib._private_build = True
                jnative._LIBS[name] = lib
    if jnative._load() is None or not jnative.corpus_available():
        raise AssertionError("the JAX package's native libraries did not load from the private build")


def _glyph_segments(font_path: str):
    """A few glyph outlines at subpixel offsets -> (segments, offsets)."""
    from ai_font_renderer_tpu_torch.fontgen import raster
    from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont

    font = TrueTypeFont.load(font_path)
    scale = 12.0 / font.units_per_em
    segs, offsets = [], [0]
    for ch, dx in (("A", 2.3), ("g", 1.7), ("@", 2.0), ("W", 1.25), ("%", 0.6)):
        s = raster.flatten_glyph(font.glyph(font.glyph_id(ord(ch))), scale).copy()
        s[:, [1, 3]] = 13.4 - s[:, [1, 3]]
        s[:, [0, 2]] += dx
        segs.append(s)
        offsets.append(offsets[-1] + len(s))
    return np.concatenate(segs).astype(np.float32), np.asarray(offsets, np.int64)


def test_processes_started_together_each_get_the_native_rasterizer(tmp_path):
    """Four processes install from one fresh build directory at the same
    moment: each gets the native library (none falls back to Python), all
    the same file, and the directory holds that file and no temporary."""
    build_dir = str(tmp_path / "native")
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); import test_torch_native_build as t; "
        "from ai_font_renderer_tpu.fontgen import native as n; t.install_reference_native(sys.argv[2]); "
        "print(n._LIBS['rasterizer']._name)"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [
        subprocess.Popen([sys.executable, "-c", code, os.path.dirname(__file__), build_dir],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err[-2000:] for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and os.path.dirname(paths.pop()) == build_dir
    names = sorted(n for n in os.listdir(build_dir) if not n.startswith("."))
    assert len(names) == 2 and all(n.endswith(".so") for n in names), names


def test_reference_coverage_equals_the_ports_bit_for_bit():
    """The privately built JAX rasterizer and the port's own native build of
    its copy of the source give the same coverage, bit for bit."""
    from ai_font_renderer_tpu.config import FIRACODE_PATH
    from ai_font_renderer_tpu.fontgen import native as jnative
    from ai_font_renderer_tpu_torch.fontgen import native as tnative

    install_reference_native()
    assert tnative._load() is not None
    segments, offsets = _glyph_segments(FIRACODE_PATH)
    want = jnative.rasterize_batch(segments, offsets, 12, 18)
    got = tnative.rasterize_batch(segments, offsets, 12, 18)
    assert got.shape == (5, 18, 12) and want.max() > 0.5
    np.testing.assert_array_equal(got, want)
