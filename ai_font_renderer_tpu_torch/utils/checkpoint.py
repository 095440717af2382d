"""Model weights in one npz file, interchangeable with the JAX package's, and
step checkpoints of a training run.

The npz format is that of ai_font_renderer_tpu/utils/checkpoint.py: one
array per flat parameter key plus a ``__config__`` entry holding the
architecture fields as JSON. A file written by either package loads in the
other with the same arrays and config. A name ending in ``.pth`` is the
reference's bare torch state_dict instead (``torch_interop.py``); it holds
no config, so loading infers it from the shapes, as the JAX package does.
A SIREN glyph bank has its own npz (``save_siren``/``load_siren``): the
weights plus a ``__siren_config__`` entry, the same file in both packages.

:class:`CheckpointManager` keeps a run's full state (parameters, AdamW
moments, step count), its best-weights snapshot and the host's control
state per epoch, written with ``torch.save``; ``save_tree``/``restore_tree``
keep any tree of tensors instead (the placement fine-tune's tunable
parameters and Adam state). It cannot read the JAX package's orbax
checkpoints, nor they its own, so a fine-tune cannot resume across the
packages; weights cross between them through the npz file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.font_renderer import infer_model_config, params_from_jax
from .torch_interop import load_pth, save_pth

MODEL_FILENAME = "font_renderer.npz"

# Architecture fields persisted inside the npz. Runtime knobs (bf16_matmul,
# fused_attention, ...) change how the weights run, not the function they
# define, and are not saved.
_CONFIG_KEY = "__config__"
_CONFIG_FIELDS = (
    "vocab_size",
    "embedding_dim",
    "num_heads",
    "max_length",
    "hidden_dim",
    "num_blocks",
    "sheet_height",
    "sheet_width",
    "decoder",
    "decoder_grid",
    "decoder_channels",
)


def save_params(params, filename: str = MODEL_FILENAME, mcfg: ModelConfig | None = None) -> None:
    """Save weights (tensors or arrays) to one npz; with ``mcfg``, embed its
    architecture fields as the ``__config__`` JSON entry. A ``.pth`` name
    writes the reference's state_dict, without the config."""
    d = os.path.dirname(filename)
    if d:
        os.makedirs(d, exist_ok=True)
    if filename.endswith(".pth"):
        save_pth(params, filename)
        print(f"Model saved to {filename}")
        return
    flat = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in params.items()
    }
    if mcfg is not None:
        flat[_CONFIG_KEY] = np.array(json.dumps({f: getattr(mcfg, f) for f in _CONFIG_FIELDS}))
    np.savez(filename, **flat)
    print(f"Model saved to {filename}")


def load_params_with_config(
    filename: str = MODEL_FILENAME,
    base="default",
    device: str | torch.device | None = None,
):
    """Load weights plus their architecture config -> (params, mcfg | None).

    The config comes from the ``__config__`` entry when the file has one,
    else (an npz without it, or a ``.pth``) from the shapes
    (``infer_model_config``). ``base`` supplies the fields a file does not
    fix; ``base=None`` returns (params, None).
    """
    dev = resolve_device(device)
    if filename.endswith(".pth"):
        params, cfg_json = load_pth(filename, dev), None
    else:
        with np.load(filename) as z:
            cfg_json = str(z[_CONFIG_KEY][()]) if _CONFIG_KEY in z.files else None
            arrays = {k: z[k] for k in z.files if k != _CONFIG_KEY}
        params = params_from_jax(arrays, dev)
    print(f"Model loaded from {filename}")
    if base is None:
        return params, None
    base_cfg = ModelConfig() if base == "default" else base
    if cfg_json is not None:
        kw = json.loads(cfg_json)
        for tup_field in ("decoder_grid", "decoder_channels"):
            if tup_field in kw:
                kw[tup_field] = tuple(kw[tup_field])
        return params, dataclasses.replace(base_cfg, **kw)
    return params, infer_model_config(params, base_cfg)


_SIREN_CONFIG_KEY = "__siren_config__"


def save_siren(params, cfg, charset: str, filename: str, font: str | None = None) -> None:
    """Save a SIREN glyph bank (models/siren.py) to one npz: its weights and
    a ``__siren_config__`` JSON entry holding the SirenConfig fields, the
    charset and, with ``font`` (a TTF path), the font's basename, so a
    render can flag a bank used with another font's metrics. The JAX
    package's ``save_siren`` writes the same file."""
    flat = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in params.items()
    }
    meta = {"cfg": dataclasses.asdict(cfg), "charset": charset}
    if font:
        meta["font"] = os.path.basename(font)
    flat[_SIREN_CONFIG_KEY] = np.array(json.dumps(meta))
    d = os.path.dirname(filename)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(filename, **flat)
    print(f"SIREN bank saved to {filename}")


def load_siren(filename: str, device: str | torch.device | None = None):
    """Load a bank saved by either package's ``save_siren`` -> (params on
    ``device``, SirenConfig, charset)."""
    from ..models.siren import SirenConfig

    dev = resolve_device(device)
    with np.load(filename) as z:
        if _SIREN_CONFIG_KEY not in z.files:
            raise ValueError(f"{filename} is not a SIREN bank (no {_SIREN_CONFIG_KEY} entry)")
        meta = json.loads(str(z[_SIREN_CONFIG_KEY][()]))
        arrays = {k: z[k] for k in z.files if k != _SIREN_CONFIG_KEY}
    print(f"SIREN bank loaded from {filename}")
    return params_from_jax(arrays, dev), SirenConfig(**meta["cfg"]), meta["charset"]


def siren_font(filename: str) -> str | None:
    """The basename of the font a bank was trained against, or None for an
    untagged bank (the committed artifacts among them)."""
    with np.load(filename) as z:
        if _SIREN_CONFIG_KEY not in z.files:
            return None
        return json.loads(str(z[_SIREN_CONFIG_KEY][()])).get("font")


def _state_record(state) -> dict:
    """A training state as a plain dict of tensors and ints for torch.save,
    with its type's name."""
    record = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    record["params"] = {k: v.detach() for k, v in state.params.items()}
    record["type"] = type(state).__name__
    return record


def _shape(tree) -> str:
    if isinstance(tree, dict):
        return f"keys {sorted(tree)}"
    if isinstance(tree, (tuple, list)):
        return f"{len(tree)} entries"
    return type(tree).__name__


def _like(saved, template):
    """``saved`` (a tree read back by torch.load) in ``template``'s form:
    the same dict keys and sequence lengths (else ValueError), tuples where
    the template has tuples, each tensor on the device and in the dtype of
    the template's, requiring a gradient where the template's does."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"checkpoint holds {_shape(saved)} where the template has keys {sorted(template)}")
        return {k: _like(saved[k], template[k]) for k in template}
    if isinstance(template, (tuple, list)):
        if not isinstance(saved, (tuple, list)) or len(saved) != len(template):
            raise ValueError(f"checkpoint holds {_shape(saved)} where the template has {len(template)} entries")
        return type(template)(_like(a, b) for a, b in zip(saved, template))
    if isinstance(template, torch.Tensor):
        return saved.to(device=template.device, dtype=template.dtype).requires_grad_(template.requires_grad)
    return saved


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _state_from_record(record: dict, template):
    """Rebuild a state of ``template``'s type (TrainState or
    FusedTrainState) from a saved record, each tensor on the device and in
    the dtype of ``template``'s matching tensor."""
    if record["type"] != type(template).__name__:
        raise ValueError(f"checkpoint holds a {record['type']}, not a {type(template).__name__}")

    fields = {f.name: _like(record[f.name], getattr(template, f.name)) for f in dataclasses.fields(template)}
    fields["params"] = {k: v.requires_grad_() for k, v in fields["params"].items()}
    return type(template)(**fields)


class CheckpointManager:
    """Step checkpoints of a training run, one directory per step:
    ``step_XXXXXXXX/tree.pt`` (``torch.save`` of the state and the
    best-weights snapshot, or of any tree) and ``host_state.json`` (the
    host's control state), written last, which marks the checkpoint
    complete. The newest ``keep`` are kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.directory, name, "host_state.json")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, best_params: dict, host_state: dict, mesh=None) -> None:
        """Save the training state, the best-weights snapshot and the host
        state for ``step``, then drop all but the newest ``keep`` steps.
        On a mesh (parallel.Mesh) every rank calls it with its shards:
        out_w's columns and their moments are gathered, and rank (0, 0)
        writes the file a one-device run writes."""
        if mesh is not None:
            from ..parallel.sharding import gather_params, gather_state

            state, best_params = gather_state(mesh, state), gather_params(mesh, best_params)
            if not mesh.is_main:
                return
        tree = {"state": _state_record(state), "best_params": _detached(best_params)}
        self.save_tree(step, tree, host_state)

    def save_tree(self, step: int, tree, host_state: dict) -> None:
        """Save any tree of tensors, numbers, dicts, tuples and lists (the
        fine-tune's (tunable, Adam state)) and the host state for ``step``,
        then drop all but the newest ``keep`` steps."""
        path = self._step_dir(step)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_detached(tree), os.path.join(tmp, "tree.pt"))
        os.replace(tmp, path)
        with open(os.path.join(path, "host_state.json"), "w") as f:
            json.dump(host_state, f)
        for old in self.steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def host_state(self, step: int | None = None) -> dict:
        """Read just the JSON sidecar (no tensor IO)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        with open(os.path.join(self._step_dir(step), "host_state.json")) as f:
            return json.load(f)

    def restore(self, step: int | None, template, mesh=None):
        """-> (step, state, best_params, host_state); step None restores the
        latest. The state comes back as ``template``'s type (TrainState or
        FusedTrainState) with each tensor on the device and in the dtype of
        ``template``'s; the best-weights snapshot follows its parameters.
        On a mesh each rank takes its own shard of the whole state, so a
        run moves between one device and any mesh both ways."""
        step, tree, host = self.restore_tree(step)
        state = _state_from_record(tree["state"], template)
        best = {k: v.to(device=template.params[k].device) for k, v in tree["best_params"].items()}
        if mesh is not None:
            from ..parallel.sharding import shard_params, shard_state

            state, best = shard_state(mesh, state), shard_params(mesh, best)
        return step, state, best, host

    def restore_tree(self, step: int | None = None, template=None):
        """-> (step, tree, host_state) of a :meth:`save_tree` checkpoint;
        step None restores the latest. With ``template`` the tree comes
        back in its form (tuples, devices, dtypes, gradients), and a tree
        of another structure raises ValueError."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree = torch.load(os.path.join(self._step_dir(step), "tree.pt"), map_location="cpu", weights_only=True)
        if template is not None:
            tree = _like(tree, template)
        return step, tree, self.host_state(step)
