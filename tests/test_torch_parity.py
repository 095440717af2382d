"""Forward-numerics parity against the actual reference torch model.

Imports /root/reference/model.py UNMODIFIED, copies its randomly
initialized state_dict into our param layout (utils/torch_interop.py), and
asserts the two frameworks compute the same function — converting the
"functionally equivalent" claim (models/font_renderer.py docstring) from
assertion to measured evidence. Also locks the .pth round trip in both
directions (consume a reference checkpoint; produce one the reference can
load).
"""

import os
import sys

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

REFERENCE = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REFERENCE, "model.py")),
    reason="reference checkout not present",
)

from ai_font_renderer_tpu.config import ModelConfig  # noqa: E402
from ai_font_renderer_tpu.models import font_renderer  # noqa: E402
from ai_font_renderer_tpu.utils.torch_interop import (  # noqa: E402
    from_state_dict,
    load_pth,
    save_pth,
    to_state_dict,
)
from test_torch_native_build import install_reference_native

install_reference_native()

# Strict-f32 config: parity is measured without the bf16 fast paths.
F32_CFG = ModelConfig(bf16_matmul=False)


def _reference_module():
    sys.path.insert(0, REFERENCE)
    try:
        import model as ref  # noqa: F401  (module-level: seeds + cpu pick)
    finally:
        sys.path.remove(REFERENCE)
    return ref


@pytest.fixture(scope="module")
def ref_model():
    ref = _reference_module()
    torch.manual_seed(123)
    m = ref.AttentionFontRenderer(max_length=100)
    m.eval()
    return ref, m


def _codes(strings, max_length=100):
    batch = np.full((len(strings), max_length), ord(" "), np.int32)
    for i, s in enumerate(strings):
        arr = [ord(c) for c in s[:max_length]]
        batch[i, : len(arr)] = arr
    return batch


def test_forward_parity_on_test_strings(ref_model):
    ref, m = ref_model
    params = from_state_dict(m.state_dict())
    codes = _codes(ref.test_strings)

    with torch.no_grad():
        theirs = m(torch.from_numpy(codes.astype(np.int64))).numpy()
    ours = np.asarray(
        font_renderer.apply(params, jnp.asarray(codes), F32_CFG, train=False)
    )

    assert ours.shape == theirs.shape == (len(ref.test_strings), 80, 240)
    max_abs = float(np.max(np.abs(ours - theirs)))
    assert max_abs < 1e-5, f"forward parity broken: max|diff|={max_abs}"


def test_forward_parity_short_sequence_zero_pad(ref_model):
    """The reference zero-pads the FLAT features of short sequences
    (model.py:190-193); we zero-pad the same tensor. Feed a genuinely
    short batch (seq_len < max_length) to both."""
    ref, m = ref_model
    params = from_state_dict(m.state_dict())
    codes = _codes(["HI", "SHORT SEQ"], max_length=9)

    with torch.no_grad():
        theirs = m(torch.from_numpy(codes.astype(np.int64))).numpy()
    ours = np.asarray(
        font_renderer.apply(params, jnp.asarray(codes), F32_CFG, train=False)
    )
    max_abs = float(np.max(np.abs(ours - theirs)))
    assert max_abs < 1e-5, f"short-seq parity broken: max|diff|={max_abs}"


def test_state_dict_round_trip(ref_model):
    _, m = ref_model
    params = from_state_dict(m.state_dict())
    back = to_state_dict(params)
    for k, v in m.state_dict().items():
        assert k in back
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_pth_file_round_trip(ref_model, tmp_path):
    """Our export loads cleanly into a fresh reference model (strict keys),
    and load_pth reads back what save_pth wrote."""
    ref, m = ref_model
    params = from_state_dict(m.state_dict())
    path = str(tmp_path / "font_renderer.pth")
    save_pth(params, path)

    m2 = ref.AttentionFontRenderer(max_length=100)
    m2.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))

    again = load_pth(path)
    for k in params:
        np.testing.assert_array_equal(
            np.asarray(again[k]), np.asarray(params[k]), err_msg=k
        )


def test_conv_checkpoint_export_refuses():
    import jax

    cfg = ModelConfig(decoder="conv_ps", max_length=100)
    params = font_renderer.init(jax.random.PRNGKey(0), cfg)
    with pytest.raises(ValueError, match="torch counterpart"):
        to_state_dict(params)


def test_save_load_params_pth_dispatch(ref_model, tmp_path):
    """The generic persistence surface accepts .pth transparently, so
    `afr render --weights font_renderer.pth` serves reference weights."""
    from ai_font_renderer_tpu.utils.checkpoint import (
        load_params,
        load_params_with_config,
        save_params,
    )

    _, m = ref_model
    params = from_state_dict(m.state_dict())
    path = str(tmp_path / "font_renderer.pth")
    save_params(params, path, ModelConfig())
    loaded = load_params(path)
    for k in params:
        np.testing.assert_array_equal(np.asarray(loaded[k]), np.asarray(params[k]))
    _, mcfg = load_params_with_config(path)
    assert mcfg.decoder == "linear" and mcfg.num_heads == 4
