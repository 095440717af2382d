"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a shared library with a plain C interface, loaded through ``ctypes``:
a build takes seconds, where an extension that includes PyTorch's headers
takes minutes. Libraries go to ``_build/`` beside the package (listed in
``.gitignore``), named by a hash of their source, so an edited source is
rebuilt and an unchanged one is reused (the headers, csrc/*.cuh, count as
part of every source). Nothing here runs at import time:
the CPU tests import every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_output", "fused_attention", "attention_mma", "attention_wide", "fused_dw_adamw", "gather_rows")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def _lib_path(name: str) -> Path:
    """The library of csrc/{name}.cu, named by a hash of the source and of
    every header in csrc/ (which it may include)."""
    digest = hashlib.sha1((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(SRC_DIR / f"{name}.cu"),
    ]


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once. Returns {name: ptxas report} for the
    sources built in this call; raises with the compiler's output on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _command(name, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for csrc/{name}.cu, built first if needed.
    ``signatures`` maps each C entry point to its (argtypes, restype),
    declared once when the library is loaded. The build and load are the
    span ``ops.load.<name>`` (utils/profiling.py)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            # Imported here: utils/ imports models/, which imports ops/.
            from ..utils.profiling import span

            with span(f"ops.load.{name}"):
                build((name,))
                lib = ctypes.CDLL(str(_lib_path(name)))
                for fn_name, (argtypes, restype) in signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = restype
            _libs[name] = lib
        return lib


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the integer handle
    the C entry points take."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
