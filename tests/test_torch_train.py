"""The port's trainer against the JAX package's, on the CPU at small sizes.

Steps start from a JAX state that has already taken 3 steps (carried over by
``train_state_from_jax``), so Adam's update is no longer lr * sign(g), which
flips on rounding noise. Dropout is off where numbers are compared: the two
frameworks cannot draw the same masks.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import config as jcfg
from ai_font_renderer_tpu.fontgen import bake_atlas as jax_bake_atlas
from ai_font_renderer_tpu.fontgen.dataset import build_device_dataset as jax_build_dataset
from ai_font_renderer_tpu.train import loop as jloop
from ai_font_renderer_tpu.train import step as jstep
from ai_font_renderer_tpu.train.schedule import CosineSchedule as JaxCosine
from ai_font_renderer_tpu_torch import config as tcfg
from ai_font_renderer_tpu_torch.fontgen import bake_atlas, build_device_dataset
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.train import loop as tloop
from ai_font_renderer_tpu_torch.train import step as tstep
from ai_font_renderer_tpu_torch.train.schedule import CosineSchedule
from ai_font_renderer_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_native_build import install_reference_native

install_reference_native()

SMALL = dict(max_length=24, sheet_height=20, sheet_width=60)
NO_DROPOUT = dict(dropout_rate=0.0, fc_dropout_rate=0.0)
# bk's gradient is zero in exact arithmetic (softmax is invariant to a bias
# on the keys), so its moments hold rounding noise on both sides.
NOISE_KEYS = ("bk",)


def _pair(mkw=None, tkw=None):
    jm = jcfg.ModelConfig(**SMALL, **(mkw or {}))
    jt = jcfg.TrainConfig(**{"batch_size": 16, "num_samples": 96, **(tkw or {})})
    tm = tcfg.ModelConfig(**dataclasses.asdict(jm))
    tt = tcfg.TrainConfig(**dataclasses.asdict(jt))
    return jm, jt, tm, tt


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The tiny setup of tests/test_train.py:74-84, built by each package;
    the JAX package's caches in a directory of this module's own."""
    spec = dict(width=60, height=20, max_chars=24)
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    jds = jax_build_dataset(
        jax_bake_atlas(jcfg.FIRACODE_PATH, jcfg.SheetSpec(**spec), cache_dir=cache), 96, synth_batch=32,
        cache_dir=cache,
    )
    tds = build_device_dataset(bake_atlas(tcfg.FIRACODE_PATH, tcfg.SheetSpec(**spec)), 96, synth_batch=32, device="cpu")
    return jds, tds


@pytest.fixture(scope="module")
def batch(datasets):
    jds, _ = datasets
    codes = np.asarray(jds.codes[:16])
    targets = np.asarray(jds.targets_u8[:16]).astype(np.float32) / 255.0
    return codes, targets


def test_train_config_fields_and_checks_match_jax():
    assert dataclasses.asdict(tcfg.TrainConfig()) == dataclasses.asdict(jcfg.TrainConfig())
    for kw in (dict(remat_frontend="dots"), dict(remat_frontend="bogus", handrolled_bwd=True)):
        with pytest.raises(ValueError):
            jcfg.TrainConfig(**kw)
        with pytest.raises(ValueError):
            tcfg.TrainConfig(**kw)


# Moments: a bf16 mu to one bf16 step of its largest value. nu to 1e-4 of
# its largest value in f32; under bf16 products to 1e-3, since the
# projection's input is rounded to bf16 and, where the frameworks' frontends
# differ by an ulp, some entries round to the other neighbour (2.2e-4
# measured on out_w's nu).
F32_MOMENTS, BF16_MOMENTS = (2.0**-8, 1e-4), (2.0**-8, 1e-3)
STEP_CASES = {
    # name: (model kw, train kw, loss rel tol, (mu, nu) tol of the largest value)
    "standard_f32": (dict(bf16_matmul=False), {}, 1e-5, F32_MOMENTS),
    "standard_bf16": ({}, {}, 1e-4, BF16_MOMENTS),
    # Batch 16 is no multiple of 128, so the JAX side computes the Pallas
    # custom VJP's function with XLA ops and the same strict mask.
    "pallas_output": (dict(use_pallas_output=True), {}, 1e-4, BF16_MOMENTS),
    "handrolled_f32": (dict(bf16_matmul=False), dict(handrolled_bwd=True), 1e-5, F32_MOMENTS),
    # The hand-rolled step rounds the masked cotangent to bf16. The two
    # frameworks' f32 forwards differ by an ulp in places, and about 1 in
    # 1400 cotangent entries rounds to the other bf16 neighbour (14 of 19200
    # on this batch); Adam amplifies those flips over the steps: the third
    # loss agrees to 1.3e-4, the moments of out_w to 8e-2.
    "handrolled_bf16": ({}, dict(handrolled_bwd=True), 1e-3, (0.1, 0.1)),
    "fused": ({}, dict(fused_dw_adamw=True), 1e-4, BF16_MOMENTS),
    # The port's fused step with use_pallas_output runs K1 and K2 for the
    # forward and dX: the same function as the JAX fused step's XLA dots.
    "fused_pallas_output": (dict(use_pallas_output=True), dict(fused_dw_adamw=True), 1e-4, BF16_MOMENTS),
}


def _close_of_max(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-30, f"{what}: max err {err} > {tol} of {scale}"


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_jax(case, batch):
    """Three steps of the port from a JAX state 3 steps in: losses to the
    case's relative tolerance, then mu and nu (bf16 mu: one bf16 step of the
    largest value)."""
    mkw, tkw, loss_tol, (mu_tol, nu_tol) = STEP_CASES[case]
    jm, jt, tm, tt = _pair({**mkw, **NO_DROPOUT}, tkw)
    fused = tt.fused_dw_adamw
    init = jstep.init_fused_state if fused else jstep.init_state
    step = jstep.train_step_fused if fused else jstep.train_step
    codes, targets = batch
    jc, jtg = jnp.asarray(codes), jnp.asarray(targets)
    state = init(jax.random.PRNGKey(0), jm, jt)
    for i in range(3):
        state, _ = step(state, jc, jtg, jnp.float32(1e-3), jax.random.PRNGKey(i), jm, jt)
    port = tstep.train_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    assert isinstance(port, tstep.FusedTrainState if fused else tstep.TrainState)
    assert port.count == 3
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        state, jl = step(state, jc, jtg, jnp.float32(1e-3), jax.random.PRNGKey(10 + i), jm, jt)
        port, tl = tstep.train_step(port, torch.from_numpy(codes), torch.from_numpy(targets), 1e-3, gen, tm, tt)
        assert abs(float(tl) - float(jl)) <= loss_tol * float(jl), (i, float(tl), float(jl))
    assert port.count == 6
    adam = state.opt_state[0]
    for k in port.mu:
        if k in NOISE_KEYS:
            continue
        assert port.mu[k].dtype == torch.bfloat16  # adam_mu_bf16 by default
        _close_of_max(port.mu[k].float(), np.asarray(adam.mu[k]).astype(np.float32), mu_tol, f"mu {k}")
        _close_of_max(port.nu[k], adam.nu[k], nu_tol, f"nu {k}")
    if fused:
        _close_of_max(port.mu_w.float(), np.asarray(state.mu_w).astype(np.float32), mu_tol, "mu_w")
        _close_of_max(port.nu_w, state.nu_w, nu_tol, "nu_w")


def test_train_state_from_jax_keeps_bf16_bits():
    jm, jt, tm, tt = _pair()
    state = jstep.init_fused_state(jax.random.PRNGKey(1), jm, jt)
    mu_w = (jax.random.normal(jax.random.PRNGKey(2), state.mu_w.shape) * 1e-3).astype(jnp.bfloat16)
    state = state._replace(mu_w=mu_w, count=jnp.int32(7))
    port = tstep.train_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    assert port.mu_w.dtype == torch.bfloat16 and port.count == 7
    np.testing.assert_array_equal(port.mu_w.float().numpy(), np.asarray(mu_w).astype(np.float32))
    assert all(p.requires_grad for p in port.params.values())
    assert set(port.mu) == set(port.params) - {"out_w"}


def _count_kept(x):
    return float((x != 0).float().mean())


@pytest.mark.parametrize(
    "rate,bits,keep",
    # bits: a uint8 draw kept below int(0.8 * 256) = 204, so 204/256.
    [(0.2, False, 0.8), (0.25, False, 0.75), (0.2, True, 0.796875), (0.25, True, 0.75)],
)
def test_dropout_keep_rates(rate, bits, keep):
    """Keep rates within 4 sigma of their target over 2^20 draws (sigma
    about 4e-4: 0.796875 and 0.8 lie 7.7 sigma apart); kept values are
    x / (1 - rate), as the JAX package scales them."""
    n = 1 << 20
    x = torch.ones(n)
    out = tfr._dropout(x, rate, torch.Generator().manual_seed(int(rate * 100) + bits), True, bits)
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(_count_kept(out) - keep) <= 4 * sigma
    kept = out[out != 0]
    assert torch.all(kept == torch.tensor(1.0) / (1 - rate))
    assert tfr._dropout(x, rate, None, False, bits) is x  # eval: untouched


def test_train_forward_draws_from_its_generator():
    _, _, tm, _ = _pair()
    params = tfr.init(torch.Generator().manual_seed(0), tm, "cpu")
    codes = torch.randint(32, 127, (4, 24), generator=torch.Generator().manual_seed(1))
    run = lambda seed: tfr.apply(params, codes, tm, train=True, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="Generator"):
        tfr.apply(params, codes, tm, train=True)
    with torch.no_grad():
        assert torch.equal(tfr.apply(params, codes, tm), tfr.apply(params, codes, tm))


def test_leaky_clamp_and_bf16_cotangent_match_jax():
    """Gradients of the MSE through the leaky clamp (strict f32, rel 1e-4 of
    the largest value) and through the bf16 cotangent projection (rel 1e-3:
    the cotangent is rounded to bf16, and where the frameworks' f32 values
    differ by an ulp some entries round to the other neighbour; 2.7e-4
    measured) against jax.grad, dropout off."""
    from ai_font_renderer_tpu.models import font_renderer as jfr

    rng = np.random.default_rng(0)
    codes = rng.integers(32, 127, (8, 24)).astype(np.int32)
    for mkw, tol in ((dict(leaky_clamp=0.05, bf16_matmul=False), 1e-4), (dict(bf16_cotangent=True), 1e-3)):
        jm, _, tm, _ = _pair({**mkw, **NO_DROPOUT})
        params = jfr.init(jax.random.PRNGKey(0), jm)
        params["out_b"] = params["out_b"] + 0.6  # saturate some pixels
        t = rng.uniform(size=(8, 20, 60)).astype(np.float32)

        def jloss(p):
            return jnp.mean((jfr.apply(p, jnp.asarray(codes), jm, train=True, key=jax.random.PRNGKey(0)) - t) ** 2)

        want = jax.grad(jloss)(params)
        tp = tstep._trainable({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
        loss = tstep.mse_loss(tfr.apply(tp, torch.from_numpy(codes), tm, train=True, generator=torch.Generator()), torch.from_numpy(t))
        got = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
        for k in ("out_w", "out_b", "fc1_w", "embedding"):
            _close_of_max(got[k], want[k], tol, f"{mkw} {k}")


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_same_step_with_dropout_on(remat, batch):
    """remat_frontend recomputes the frontend in the backward; the dropout
    generator is replayed, so the step equals the one without remat."""
    codes, targets = (torch.from_numpy(a) for a in batch)
    _, _, tm, _ = _pair()
    params = tfr.init(torch.Generator().manual_seed(0), tm, "cpu")
    results = {}
    for mode in ("none", remat):
        tt = tcfg.TrainConfig(batch_size=16, handrolled_bwd=True, remat_frontend=mode)
        state = tstep.state_from_params(params, tt)
        gen = torch.Generator().manual_seed(5)
        state, loss = tstep.train_step(state, codes, targets, 1e-3, gen, tm, tt)
        results[mode] = (float(loss), state, gen.get_state())
    (l0, s0, g0), (l1, s1, g1) = results["none"], results[remat]
    assert l0 == l1 and torch.equal(g0, g1)
    for k in s0.params:
        torch.testing.assert_close(s1.params[k], s0.params[k], atol=1e-7, rtol=0, msg=k)


def _tiny_tcfg(epochs, **kw):
    return {**dict(batch_size=16, num_samples=96, num_epochs=epochs, eval_every=10, checkpoint_every=1), **kw}


@pytest.fixture(scope="module")
def jax_run(datasets, tmp_path_factory):
    """One JAX training run at the tiny setup, dropout off, with its outputs."""
    jds, _ = datasets
    out = str(tmp_path_factory.mktemp("jax_run"))
    jm, jt, tm, tt = _pair(NO_DROPOUT, _tiny_tcfg(4, eval_every=2, checkpoint_every=0))
    result = jloop.train(jds, jm, jt, output_dir=out, eval_strings=["HI"], log=lambda *_: None)
    init = jstep.init_state(jax.random.PRNGKey(jt.seed), jm, jt)  # train()'s own start
    return result, out, init, tm, tt


def test_val_loss_per_epoch_matches_jax_train(jax_run, datasets, tmp_path):
    """The loop from the same start: same split, shuffles and schedule, so
    the per-epoch losses agree to rel 1e-4 (f32 sums in another order over
    4 epochs of bf16 products)."""
    jres, _, init, tm, tt = jax_run
    _, tds = datasets
    state = tstep.train_state_from_jax(jax.tree.map(np.asarray, init), "cpu")
    res = tloop.train(tds, tm, tt, output_dir=str(tmp_path / "o"), eval_strings=["HI"], state=state, log=lambda *_: None)
    assert len(res.history) == len(jres.history) == 4
    for h, jh in zip(res.history, jres.history):
        for key in ("train_loss", "val_loss"):
            assert abs(h[key] - jh[key]) <= 1e-4 * jh[key], (h, jh)
        assert h["lr"] == jh["lr"]
    assert res.final_epoch == jres.final_epoch and res.early_stopped == jres.early_stopped
    assert abs(res.best_val_loss - jres.best_val_loss) <= 1e-4 * jres.best_val_loss


def test_manifests_and_metrics_have_the_jax_keys(jax_run, datasets, tmp_path):
    _, jout, _, tm, tt = jax_run
    _, tds = datasets
    out = str(tmp_path / "o")
    tloop.train(tds, tm, tt, output_dir=out, eval_strings=["HI"], log=lambda *_: None)

    def keys(path):
        with open(path) as f:
            return [line.split("=")[0].strip() for line in f if "=" in line]

    for name in ("config.txt", "training_results.txt"):
        assert keys(os.path.join(out, name)) == keys(os.path.join(jout, name))
    with open(os.path.join(out, "config.txt")) as f, open(os.path.join(jout, "config.txt")) as g:
        assert f.read() == g.read()
    lines = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    jlines = [json.loads(s) for s in open(os.path.join(jout, "metrics.jsonl"))]
    assert len(lines) == len(jlines) == 4 and [sorted(d) for d in lines] == [sorted(d) for d in jlines]
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    assert os.listdir(os.path.join(out, "epoch_0")) == ["string_0.bmp"]


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_resume_replays_uninterrupted_run(fused, datasets, tmp_path):
    """A 2+2-epoch resumed run equals a 4-epoch run exactly (dropout on:
    each epoch's generator is seeded from (seed, epoch)), and metrics.jsonl
    is appended across the resume."""
    _, tds = datasets
    _, _, tm, _ = _pair()
    mk = lambda epochs: tcfg.TrainConfig(**_tiny_tcfg(epochs, fused_dw_adamw=fused))
    quiet = lambda *_: None
    full = tloop.train(tds, tm, mk(4), output_dir=str(tmp_path / "full"), checkpoint_dir=str(tmp_path / "ckf"), log=quiet)
    ckdir, out = str(tmp_path / "ck"), str(tmp_path / "split")
    tloop.train(tds, tm, mk(2), output_dir=out, checkpoint_dir=ckdir, log=quiet)
    resumed = tloop.train(tds, tm, mk(4), output_dir=out, checkpoint_dir=ckdir, resume=True, log=quiet)
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    for h, f in zip(resumed.history, full.history[2:]):
        assert (h["train_loss"], h["val_loss"], h["lr"]) == (f["train_loss"], f["val_loss"], f["lr"])
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
    assert resumed.best_val_loss == full.best_val_loss and resumed.final_epoch == 4
    assert len(open(os.path.join(out, "metrics.jsonl")).readlines()) == 4


def test_checkpoint_manager_keeps_three_and_restores_typed(tmp_path):
    _, _, tm, tt = _pair()
    params = tfr.init(torch.Generator().manual_seed(0), tm, "cpu")
    state = tstep.state_from_params(params, dataclasses.replace(tt, fused_dw_adamw=True))
    state.count = 9
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    for step in range(5):
        ckpt.save(step, state, params, {"lr": 0.5, "step": step})
    assert ckpt.steps() == [2, 3, 4] and ckpt.latest_step() == 4
    template = tstep.init_fused_state(torch.Generator().manual_seed(1), tm, tt, "cpu")
    step, restored, best, host = ckpt.restore(None, template)
    assert step == 4 and host == {"lr": 0.5, "step": 4} and restored.count == 9
    assert isinstance(restored, tstep.FusedTrainState) and restored.mu_w.dtype == torch.bfloat16
    assert all(torch.equal(restored.params[k], state.params[k]) and restored.params[k].requires_grad for k in params)
    assert all(torch.equal(best[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="FusedTrainState"):
        ckpt.restore(4, tstep.state_from_params(params, tt))


def test_cosine_schedule_and_time_budget(datasets):
    _, tds = datasets
    sched = CosineSchedule(peak_lr=2e-3, total_epochs=7, warmup_epochs=2, min_lr=1e-5)
    jsched = JaxCosine(peak_lr=2e-3, total_epochs=7, warmup_epochs=2, min_lr=1e-5)
    assert [sched.lr_at(e) for e in range(9)] == [jsched.lr_at(e) for e in range(9)]
    _, _, tm, _ = _pair()
    tt = tcfg.TrainConfig(**_tiny_tcfg(5, schedule="cosine", max_train_seconds=0.0))
    res = tloop.train(tds, tm, tt, log=lambda *_: None)
    assert res.early_stopped and res.final_epoch == 0 and len(res.history) == 1
    assert res.history[0]["lr"] == sched.__class__(1e-3, 5, 1, 1e-6).lr_at(0)


def test_train_refuses_a_state_of_the_other_kind(datasets):
    _, tds = datasets
    _, _, tm, tt = _pair()
    state = tstep.init_state(torch.Generator().manual_seed(0), tm, tt, "cpu")
    with pytest.raises(ValueError, match="fused_dw_adamw"):
        tloop.train(tds, tm, dataclasses.replace(tt, fused_dw_adamw=True), state=state, log=lambda *_: None)
