"""Deployment artifacts through ``torch.export``: the whole render function,
weights included, as one ``.pt2`` file that runs with no model code.

The port of ai_font_renderer_tpu/utils/export.py. An artifact holds the
program ``codes int32[b, max_length] -> uint8[b, H, W]``, round(sheet * 255)
with half to even (as ``jnp.round``), for a symbolic batch b >= 1: one file
serves any batch. The weights are the program's buffers; the contract
(max_length and the sheet's size) is in its input and output shapes.

The TPU kernels of the path stay kernels inside the graph: it calls the
operators of ``ai_font_renderer_tpu_torch.ops`` (``afr::fused_output_fwd``,
K1, on W's bf16 shadow, which the file holds in W's place;
``afr::attention_fwd``, K5/K7, with a fused attention flag;
``afr::int8_product`` with ``--int8``), which pick the kernel or its plain
version by their tensors' device each time they run. So an artifact exported
on the CPU launches the kernels on the card, and loading one needs that
operator library (``load_exported`` imports it).

Beside the program the file holds ``afr.json``: the platforms it may be
loaded onto (``--platforms``; any other raises, as ``jax.export`` refuses a
platform it was not exported for), the operators its graph calls, and the
most sheets one call takes. The fully neural program composes its whole
batch in one SIREN evaluation, so callers (:class:`Artifact`) feed it at
most ``compose_chunk_size`` sheets a call, as ``compose`` chunks them; the
flagship has no such limit.

Surfaces: ``export --weights W --out F`` (``--int8``, ``--fast``) or
``export --placement NET --implicit BANK`` writes an artifact; ``render
--exported F`` and ``serve --exported F`` run one, with no weights file.
"""

from __future__ import annotations

import json
import os
import warnings
import zipfile

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, SheetSpec
from ..device import resolve_device

PLATFORMS = ("cpu", "cuda")  # those the port runs on; an artifact's default
META = "afr.json"


class _Program(nn.Module):
    """``fn(tensors, codes)`` with ``tensors`` held as buffers, so that
    ``torch.export`` keeps them in the program."""

    def __init__(self, tensors: dict, fn):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v.detach())
        self._fn = fn

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        return self._fn(dict(self.named_buffers()), codes)


def _u8(sheets: torch.Tensor) -> torch.Tensor:
    return torch.round(sheets * 255.0).to(torch.uint8)


def check_platforms(platforms) -> tuple[str, ...]:
    """``platforms`` as a tuple; raises ValueError on a platform the port
    does not run on."""
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms {list(platforms)}: the port runs on {', '.join(PLATFORMS)}")
    return platforms


def _save(program: _Program, max_length: int, path: str, platforms, sheets_per_call=None) -> int:
    """Trace ``program`` on its buffers' device with a symbolic batch and
    write it, moved to the CPU (the file names no card), with its
    ``afr.json``. Returns the file's bytes."""
    from torch.export.passes import move_to_device_pass

    platforms = check_platforms(platforms)
    device = next(program.buffers()).device
    example = torch.zeros((2, max_length), dtype=torch.int32, device=device)
    batch = torch.export.Dim("b", min=1)
    # no_grad, not inference_mode: the tracer records no inference tensors.
    with torch.no_grad():
        ep = torch.export.export(program, (example,), dynamic_shapes={"codes": {0: batch}})
    ep = move_to_device_pass(ep, "cpu")
    operators = sorted({
        n.target.name() for n in ep.graph.nodes
        if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
        and n.target.namespace == "afr"
    })
    meta = {"platforms": list(platforms), "operators": operators, "sheets_per_call": sheets_per_call}
    with warnings.catch_warnings():
        # Weights loaded from a JAX npz may be column-major; the archive
        # warns that it stores such a tensor's storage whole, which is right
        # here: every tensor is on the CPU by now.
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(ep, path, extra_files={META: json.dumps(meta)})
    return os.path.getsize(path)


def export_render(params: dict, mcfg: ModelConfig, path: str, platforms=PLATFORMS) -> int:
    """Write the render function (codes -> uint8 sheets) of ``params`` to
    ``path``, traced on their device; returns the file's bytes.

    ``render._forward`` is the body (a serving bundle of
    ``quantize_params`` runs the int8 product, its W_q held column-major as
    the card's product reads it), except with ``use_pallas_output`` on the
    linear decoder: the file holds W's bf16 shadow in W's place, made here
    through ``round_bf16``, and the graph calls ``afr::fused_output_fwd`` on
    it. Every other configuration keeps f32 W, as the JAX artifact does."""
    from ..models import font_renderer
    from ..ops.fused_output import round_bf16
    from ..render.render import _forward

    tensors = dict(params)
    k1 = mcfg.use_pallas_output and mcfg.decoder == "linear" and "out_w" in tensors
    with torch.no_grad():
        if k1:
            tensors["out_w16"] = round_bf16(tensors.pop("out_w").contiguous())
        if "out_w_q" in tensors:
            # Held transposed: its .t() in the graph is W_q column-major.
            tensors["out_w_q_t"] = tensors.pop("out_w_q").t().contiguous()

    def fn(p, codes):
        if "out_w_q_t" in p:
            p["out_w_q"] = p.pop("out_w_q_t").t()
        if not k1:
            return _u8(_forward(p, codes, mcfg))
        flat = font_renderer.frontend(p, codes, mcfg)
        sheet, _ = torch.ops.afr.fused_output_fwd(flat, p["out_w16"], p["out_b"])
        return _u8(sheet.reshape(codes.shape[0], mcfg.sheet_height, mcfg.sheet_width))

    return _save(_Program(tensors, fn), mcfg.max_length, path, platforms)


def export_neural_render(
    placement_params: dict,
    pcfg: ModelConfig,
    siren_params: dict,
    scfg,
    charset: str,
    font_path: str,
    path: str,
    platforms=PLATFORMS,
    scale: float = 1.0,
    hard: bool = False,
    monotone: bool = False,
) -> int:
    """Write the fully neural pipeline to ``path``: the placement net
    (codes -> midpoints and visibility; ``hard``/``monotone``: its discrete
    decodes), the charset as a lookup table, and the SIREN bank composed at
    the midpoints at ``scale``; the same contract as :func:`export_render`,
    so ``render --exported`` and the standalone runner run either. The font
    gives only the static cell geometry; the file holds no font and no
    layout engine. Returns the file's bytes."""
    from ..fontgen.ttf import TrueTypeFont
    from ..models import placement
    from ..render.implicit_sheet import build_layout, compose_all, compose_chunk_size, origins_from_midpoints

    lay = build_layout(TrueTypeFont.load(font_path), SheetSpec(), scfg.cell, scale=scale,
                       max_glyphs=pcfg.max_length)
    # Charset index per ASCII code, -1 where the code places no glyph.
    lut = np.full(128, -1, np.int32)
    for i, c in enumerate(charset):
        if ord(c) < 128:
            lut[ord(c)] = i
    device = siren_params["embed"].device
    tensors = {"lut": torch.from_numpy(lut).to(device)}
    tensors.update({f"p_{k}": v for k, v in placement_params.items()})
    tensors.update({f"s_{k}": v for k, v in siren_params.items()})
    space = ord(" ")

    def fn(p, codes):
        pp = {k[2:]: v for k, v in p.items() if k.startswith("p_")}
        sp = {k[2:]: v for k, v in p.items() if k.startswith("s_")}
        mids, logits = placement.apply(pp, codes, pcfg, hard=hard, monotone=monotone)
        origins = origins_from_midpoints(mids, lay)
        ci = p["lut"][codes.clamp(0, 127).long()]
        valid = (ci >= 0) & (codes != space) & (torch.sigmoid(logits) > 0.5)
        return _u8(compose_all(sp, ci.clamp(min=0), origins, valid, scfg, lay))

    return _save(_Program(tensors, fn), pcfg.max_length, path, platforms,
                 compose_chunk_size(pcfg.max_length, lay))


def read_meta(path: str) -> dict:
    """The ``afr.json`` of an artifact, read from the archive without
    loading the program; raises ValueError for any other file."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is no torch.export artifact of this package (a .hlo file is the JAX "
            "package's: run it with python -m ai_font_renderer_tpu render --exported)"
        )
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.endswith(f"extra/{META}")]
        if not names:
            raise ValueError(f"{path} holds no {META}: it was not written by this package's export")
        return json.loads(z.read(names[0]))


def exported_contract(program) -> tuple[int, int, int]:
    """(max_length, sheet height, sheet width) from the program's input
    and output shapes (an :class:`Artifact` or an ExportedProgram)."""
    ep = program.program if isinstance(program, Artifact) else program
    (name,) = ep.graph_signature.user_inputs
    codes = next(n for n in ep.graph.nodes if n.op == "placeholder" and n.name == name)
    out = next(n for n in ep.graph.nodes if n.op == "output").args[0][0]
    _, height, width = out.meta["val"].shape
    return int(codes.meta["val"].shape[1]), int(height), int(width)


class Artifact:
    """A loaded artifact: the program on ``device``, its contract and the
    most sheets one call of it takes. Calling it on codes [N, max_length]
    int32 on ``device`` -> uint8 sheets [N, H, W] on ``device``."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self.module = program.module()
        self.device = device
        self.platforms = tuple(meta["platforms"])
        self.operators = tuple(meta["operators"])
        self.sheets_per_call = meta["sheets_per_call"]
        self.max_length, self.height, self.width = exported_contract(program)

    def __call__(self, codes: torch.Tensor) -> torch.Tensor:
        n = codes.shape[0]
        step = self.sheets_per_call or max(n, 1)
        with torch.inference_mode():
            parts = [self.module(codes[i : i + step]) for i in range(0, n, step)]
        if not parts:
            return torch.empty((0, self.height, self.width), dtype=torch.uint8, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def load_exported(path: str, device: str | torch.device | None = None) -> Artifact:
    """Load an artifact onto ``device`` (the card unless ``"cpu"``); raises
    ValueError when it was not exported for that platform or is no
    artifact of this package."""
    from torch.export.passes import move_to_device_pass

    from .. import ops  # noqa: F401  (registers the operators a graph calls)

    meta = read_meta(path)
    kind = torch.device("cuda" if device is None else device).type
    if kind not in meta["platforms"]:
        raise ValueError(f"{path} was exported for platforms {meta['platforms']}, not {kind}")
    dev = resolve_device(device)
    with warnings.catch_warnings():
        # The archive's reader wraps its read-only bytes in tensors and
        # warns that they are not writable; nothing writes to them.
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        program = torch.export.load(path)
    if dev.type != "cpu":
        program = move_to_device_pass(program, dev)
    return Artifact(program, meta, dev)


def render_exported_u8(artifact: Artifact, strings: list[str]) -> torch.Tensor:
    """Strings -> uint8 sheets [N, H, W] on the artifact's device (the
    render server's wire format), without waiting for the card."""
    from ..fontgen.layout import encode_codes

    codes = torch.from_numpy(encode_codes(strings, artifact.max_length)).to(artifact.device)
    return artifact(codes)


def render_exported(artifact: Artifact, strings: list[str]) -> np.ndarray:
    """Strings -> float32 sheets [N, H, W] on the host, on the artifact's
    uint8 grid (as ``render_batch``'s 0..1 floats)."""
    return render_exported_u8(artifact, strings).cpu().numpy().astype(np.float32) / 255.0
