"""Backward-pass roofline decomposition of the flagship train step on the
card.

The port of tools/roofline_bwd.py: the parity step (ModelConfig()
defaults, batch 1024; ``--fast``: bf16_frontend + bits_dropout) split into
segments, each timed against its roofline on the H100 (989 TFLOP/s dense
bf16, 3.35 TB/s HBM; NVIDIA's data sheet, SXM part, at 700 W). Each segment
runs ITERS times chained (its outputs perturb the next iteration's inputs),
timed by CUDA events around the window, best of 4 windows:

    full_step           train_step: fwd + bwd + AdamW
    fwd                 loss value only (train=True dropout, as the step)
    fwd_bwd             gradients of every parameter
    fwd_bwd_dw_side     gradient of out_w only -> fwd + chain + dW GEMM
    fwd_bwd_dx_side     gradients of the frontend only -> fwd + chain + dX
                        GEMM + frontend backward
    chain_only          gradient of mean((clamp(sheet) - t)^2) wrt sheet
    raw dX / dW GEMMs   the projection's backward products as the plain
                        step computes them: f32 products of bf16-rounded
                        operands (TF32 off)
    frontend fwd/bwd    attention + MLP block alone
    adamw_only          the optimizer's update with fixed gradients

Derived: bwd_total = fwd_bwd - fwd; dW side = fwd_bwd_dw_side - fwd;
dX side = fwd_bwd_dx_side - fwd; frontend bwd = frontend_fwd_bwd -
frontend_fwd.

    python -m ai_font_renderer_tpu_torch.tools.roofline_bwd [--fast] [--kernels K] [--device cpu]
"""

from __future__ import annotations

import json
import sys
import time

import torch
import torch.nn.functional as F

from ..config import ModelConfig, TrainConfig, replace
from ..models import font_renderer
from ..train.step import adamw_, loss_fn, mse_loss, state_from_params, train_step
from . import _common

B = 1024
ITERS = 20
PEAK_BF16 = 989e12  # H100 SXM tensor cores, bf16 x bf16 -> f32, dense
PEAK_HBM = 3.35e12  # H100 SXM HBM3 bytes/s
EPS = 1e-12  # grad feedback factor: tiny but not zero


def roofline_counts(mcfg: ModelConfig, tcfg: TrainConfig, batch: int = B) -> dict:
    """The roofline inputs of tools/roofline_bwd.py:253-261 as a function
    of the configs: the projection GEMM's operations, the clamp + MSE
    chain's bytes (sheet f32 read, target u8 read, gradient f32 written),
    the parameter count (from the configs' shapes alone, no weights drawn)
    and AdamW's bytes (p and g read, p written in f32, nu read and written,
    mu read and written in its dtype, plus 4 bytes a parameter)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    P = mcfg.sheet_height * mcfg.sheet_width
    K_, N_ = mcfg.max_length * mcfg.hidden_dim, P
    with FakeTensorMode():
        n_par = font_renderer.param_count(font_renderer.init(torch.Generator(), mcfg, "cpu"))
    mu_b = 2 if tcfg.adam_mu_bf16 else 4
    return {
        "flop_gemm": 2.0 * batch * K_ * N_,
        "chain_bytes": batch * P * (4 + 1 + 4),
        "n_par": n_par,
        "adamw_bytes": n_par * (4 * 2 + 4 * 2 + mu_b * 2 + 4),
    }


def _window_ms(run, iters: int, device) -> float:
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def seg_time(label, body, carry, device, iters=ITERS, windows=4) -> float:
    """ms per iteration of ``body`` (carry -> carry), best of ``windows``
    windows of ``iters`` chained iterations after one warm one."""
    box = [body(carry)]

    def run():
        box[0] = body(box[0])

    _common.sync(device)
    ms = min(_window_ms(run, iters, device) for _ in range(windows)) / iters
    print(f"{label:26s} {ms:7.3f} ms", flush=True)
    return ms


def _perturb(codes, sig):
    return (codes + (sig.detach() * 7.0).to(torch.int32)) % 26 + 65


def _feed(leaves, grads) -> None:
    """Fold the gradients into the carry so the iterations chain."""
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.add_(g, alpha=EPS)


def main(argv: list[str] | None = None, mcfg: ModelConfig | None = None, batch: int = B, iters: int = ITERS,
         windows: int = 4) -> dict:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    fast = "--fast" in rest
    if mcfg is None:
        mcfg = ModelConfig(bf16_frontend=True, bits_dropout=True) if fast else ModelConfig()
    mcfg, tcfg = _common.with_kernels(kernels, mcfg, TrainConfig())
    g = torch.Generator(device=dev).manual_seed(0)
    params = font_renderer.init(g, mcfg, dev)
    codes0 = torch.randint(65, 91, (batch, mcfg.max_length), generator=g, device=dev, dtype=torch.int32)
    targets = torch.randint(0, 256, (batch, mcfg.sheet_height, mcfg.sheet_width), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8).float() / 255.0
    lr = 1e-3
    dgen = torch.Generator(device=dev).manual_seed(1)
    P = mcfg.sheet_height * mcfg.sheet_width
    K_, N_ = mcfg.max_length * mcfg.hidden_dim, P
    seg = lambda label, body, carry: seg_time(label, body, carry, dev, iters, windows)  # noqa: E731
    results = {}

    # --- full step (fwd + bwd + AdamW), state chained ---------------------
    def full(c):
        st, codes = c
        st, loss = train_step(st, codes, targets, lr, dgen, mcfg, tcfg)
        return st, _perturb(codes, loss)

    results["full_step"] = seg("full_step", full, (state_from_params(params, tcfg), codes0))

    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}

    # --- forward only -------------------------------------------------------
    def fwd(codes):
        with torch.no_grad():
            return _perturb(codes, loss_fn(leaves, codes, targets, mcfg, dgen))

    results["fwd"] = seg("fwd (loss only)", fwd, codes0)

    def grads_of(keys):
        def body(codes):
            loss = loss_fn(leaves, codes, targets, mcfg, dgen)
            ps = [leaves[k] for k in keys]
            _feed(ps, torch.autograd.grad(loss, ps))
            return _perturb(codes, loss)

        return body

    front = [k for k in leaves if k not in ("out_w", "out_b")]
    results["fwd_bwd"] = seg("fwd_bwd (all grads)", grads_of(list(leaves)), codes0)
    results["fwd_bwd_dw_side"] = seg("fwd+chain+dW", grads_of(["out_w"]), codes0)
    results["fwd_bwd_dx_side"] = seg("fwd+chain+dX+frontbwd", grads_of(front), codes0)

    # --- elementwise chain alone ------------------------------------------
    tgt = targets.reshape(batch, P)

    def chain_only(sheet):
        s = sheet.requires_grad_()
        (gs,) = torch.autograd.grad(mse_loss(s.clamp(0.0, 1.0), tgt), s)
        return (sheet - gs).detach()

    results["chain_only"] = seg("clamp+MSE chain", chain_only, torch.randn(batch, P, generator=g, device=dev))

    # --- raw projection GEMMs at the plain step's dtypes -------------------
    g0 = torch.randn(batch, N_, generator=g, device=dev) * 1e-3
    wf = params["out_w"].to(torch.bfloat16).float()
    fbf = torch.randn(batch, K_, generator=g, device=dev).to(torch.bfloat16).float()
    results["raw_dx_gemm"] = seg("raw dX GEMM", lambda gg: gg + EPS * F.pad(gg @ wf.T, (0, N_ - K_)), g0)

    def raw_dw(gg):
        dw = fbf.T @ gg
        return gg + EPS * dw[:1, :]

    results["raw_dw_gemm"] = seg("raw dW GEMM", raw_dw, g0)
    del wf, fbf

    # --- frontend alone ------------------------------------------------------
    fl = [leaves[k] for k in front]
    fp = {k: leaves[k] for k in front}

    def front_fwd(codes):
        with torch.no_grad():
            return _perturb(codes, font_renderer.frontend(fp, codes, mcfg, train=True, generator=dgen).sum())

    results["frontend_fwd"] = seg("frontend fwd", front_fwd, codes0)

    def front_fwd_bwd(codes):
        s = font_renderer.frontend(fp, codes, mcfg, train=True, generator=dgen).sum()
        _feed(fl, torch.autograd.grad(s, fl))
        return _perturb(codes, s)

    results["frontend_fwd_bwd"] = seg("frontend fwd+bwd", front_fwd_bwd, codes0)

    # --- AdamW alone (gradients fixed, state chained) ------------------------
    st = state_from_params(params, replace(tcfg, fused_dw_adamw=False))
    grads0 = {k: torch.full_like(v, 1e-4) for k, v in st.params.items()}
    keys = list(grads0)

    def adamw_only(count):
        adamw_([st.params[k] for k in keys], [grads0[k] for k in keys], [st.mu[k] for k in keys],
               [st.nu[k] for k in keys], lr, tcfg, count)
        return count + 1

    results["adamw_only"] = seg("AdamW only", adamw_only, 1)

    # --- derived + rooflines -------------------------------------------------
    counts = roofline_counts(mcfg, tcfg, batch)
    ideal = {"gemm_ms": 1e3 * counts["flop_gemm"] / PEAK_BF16, "chain_ms": 1e3 * counts["chain_bytes"] / PEAK_HBM,
             "adamw_ms": 1e3 * counts["adamw_bytes"] / PEAK_HBM}
    derived = {
        "bwd_total": results["fwd_bwd"] - results["fwd"],
        "dw_side": results["fwd_bwd_dw_side"] - results["fwd"],
        "dx_side": results["fwd_bwd_dx_side"] - results["fwd"],
        "frontend_bwd": results["frontend_fwd_bwd"] - results["frontend_fwd"],
        "step_minus_fwd_bwd_adamw": results["full_step"] - results["fwd_bwd"] - results["adamw_only"],
    }
    print("\n--- derived (ms) ---")
    print(f"bwd_total (fwd_bwd - fwd)        {derived['bwd_total']:7.3f}")
    print(f"dW side   (chain+dW)             {derived['dw_side']:7.3f}")
    print(f"dX side   (chain+dX+front_bwd)   {derived['dx_side']:7.3f}")
    print(f"frontend bwd (direct)            {derived['frontend_bwd']:7.3f}")
    print(f"step - (fwd_bwd + adamw)         {derived['step_minus_fwd_bwd_adamw']:7.3f}")
    print("\n--- rooflines (H100: 989 TFLOP/s bf16, 3.35 TB/s) ---")
    print(f"projection GEMM ideal (bf16 TC)  {ideal['gemm_ms']:7.3f} ms "
          f"(measured dX {results['raw_dx_gemm']:.3f}, dW {results['raw_dw_gemm']:.3f})")
    print(f"clamp+MSE chain ideal (HBM)      {ideal['chain_ms']:7.3f} ms (measured {results['chain_only']:.3f})")
    print(f"AdamW ideal (HBM, {counts['n_par'] / 1e6:.1f}M params)  {ideal['adamw_ms']:7.3f} ms "
          f"(measured {results['adamw_only']:.3f})", flush=True)
    out = {"segments_ms": results, "derived_ms": derived, "ideal": ideal, "counts": counts, "kernels": kernels}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
