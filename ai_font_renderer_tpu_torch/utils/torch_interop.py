"""The reference's weight file, ``font_renderer.pth``, read and written.

The reference saves its model as a bare torch state_dict of
``AttentionFontRenderer``. This module maps that state_dict onto the port's
flat parameter dict (the JAX package's layout) and back, losslessly, as
ai_font_renderer_tpu/utils/torch_interop.py does, with its own copy of the
key map. The layouts differ in three ways:

  * ``nn.Linear`` stores ``weight`` as [out, in] and computes ``x @ W.T``;
    the flat dict keeps [in, out] and computes ``x @ W``: a transpose;
  * ``attention.in_proj_weight`` stacks q, k and v as [3E, E] (q first);
    the flat dict keeps wq/wk/wv as [E, E] each, in x-then-W order: split
    the rows, then transpose each block;
  * ``layer_norm.weight/bias`` are ``ln_scale``/``ln_bias``; the embedding
    and ``positional_encoding`` map one to one.

A file written by either package's ``save_pth`` loads in the other with
the same arrays. Only the linear decoder exists in the reference, so a
conv-decoder dict has no state_dict.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# flat key -> (state_dict key, transposed)
_DIRECT = {
    "embedding": ("embedding.weight", False),
    "pos": ("positional_encoding", False),
    "wo": ("attention.out_proj.weight", True),
    "bo": ("attention.out_proj.bias", False),
    "ln_scale": ("layer_norm.weight", False),
    "ln_bias": ("layer_norm.bias", False),
    "fc1_w": ("fc1.weight", True),
    "fc1_b": ("fc1.bias", False),
    "out_w": ("fc_output.weight", True),
    "out_b": ("fc_output.bias", False),
}


def _f32(a) -> torch.Tensor:
    """A tensor or an array -> a float32 CPU tensor."""
    t = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device="cpu", dtype=torch.float32)


def from_state_dict(sd: dict, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """The reference's state_dict -> the flat parameter dict, float32 on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    params = {}
    for ours, (theirs, transpose) in _DIRECT.items():
        a = _f32(sd[theirs])
        params[ours] = a.T if transpose else a
    in_w = _f32(sd["attention.in_proj_weight"])  # [3E, E]
    in_b = _f32(sd["attention.in_proj_bias"])  # [3E]
    e = in_w.shape[1]
    if in_w.shape[0] != 3 * e:
        raise ValueError(f"attention.in_proj_weight must be [3E, E], got {tuple(in_w.shape)}")
    for i, k in enumerate("qkv"):
        params[f"w{k}"] = in_w[i * e : (i + 1) * e].T
        params[f"b{k}"] = in_b[i * e : (i + 1) * e]
    return {k: v.contiguous().to(dev) for k, v in params.items()}


def to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The flat parameter dict (tensors or arrays) -> a state_dict of
    contiguous float32 CPU tensors that the reference model loads."""
    if "out_w" not in params:
        raise ValueError(
            "only the linear-decoder architecture has a torch counterpart; "
            "conv/conv_ps checkpoints cannot be exported to .pth"
        )
    sd = {}
    for ours, (theirs, transpose) in _DIRECT.items():
        a = _f32(params[ours])
        sd[theirs] = (a.T if transpose else a).contiguous()
    sd["attention.in_proj_weight"] = torch.cat([_f32(params[k]).T for k in ("wq", "wk", "wv")]).contiguous()
    sd["attention.in_proj_bias"] = torch.cat([_f32(params[k]) for k in ("bq", "bk", "bv")])
    return sd


def load_pth(path: str, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Load a ``font_renderer.pth`` state_dict into the flat parameter dict
    on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_state_dict(sd, device)


def save_pth(params: dict, path: str) -> None:
    """Write the flat parameter dict as a state_dict the reference loads. A
    bare state_dict carries no config: the reference builds the model from
    its own constants, and the port's loader infers it from the shapes."""
    torch.save(to_state_dict(params), path)
