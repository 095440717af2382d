"""The ``train`` driver: the program's training step on the corpus, through
``train.step.train_epoch`` (the batch gather, then ``train_step``).

Set-up builds the corpus on the device, the weights from the seed, and one
training state, then drives that state through its first steps, one call
of one step each, and through ``check_calls`` calls of the window's shape
(the first warms them up), and reads each for the check (see
``reference/check.py``). The same state trains in the window: calls of
``steps_per_call`` steps, each a new batch of the epoch's shuffle, until
``seconds`` have passed; the window ends in a device sync. A cell that
reports ``train_device_ms_per_step`` traces the device through the whole
untraced window: the union of its kernel, memcpy and memset intervals over
the window's steps. With a trace, a short stretch of ``trace_steps`` steps
then runs under the profiler. Then the program's state is freed and the
reference takes the checked steps.
"""

from __future__ import annotations

import time

import torch

from . import devtrace, program, traffic, weights
from .reference import check


def _moment(state, name: str) -> dict:
    """{leaf: AdamW's moment ``name`` ("mu" or "nu")}, out_w's too where the
    fused step keeps it apart."""
    out = dict(getattr(state, name))
    if hasattr(state, f"{name}_w"):
        out["out_w"] = getattr(state, f"{name}_w")
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell) -> dict:
    from ai_font_renderer_tpu_torch.train import step as step_mod

    cfg, mix, device = cell.cfg, cell.mix, cell.device
    mcfg, tcfg, spec = program.configs(cfg, cell.program_changes)
    n = mix.get("num_samples", cfg["num_samples"])
    per_call, b2 = mix["steps_per_call"], tcfg.adam_b2
    parts = {"start": time.perf_counter() - cell.t0}
    ds = traffic.build_dataset(program.font_path(cfg), n, mix, spec, device)
    parts["corpus"] = time.perf_counter() - cell.t0
    stream = traffic.BatchStream(traffic.train_split(n, tcfg.validation_split, cell.seed), tcfg.batch_size,
                                 cell.seed, device)
    weight_seed = traffic.torch_seed(cell.seed, 0)
    state = step_mod.state_from_params(weights.init(cfg["model"], weight_seed, device), tcfg)
    params0 = check.host_copy(state.params)
    gen = torch.Generator(device=device).manual_seed(traffic.torch_seed(cell.seed, 4))
    gen_state = gen.get_state()
    lr = tcfg.learning_rate
    parts["weights"] = time.perf_counter() - cell.t0
    first_rows = []

    def epoch(idx):
        nonlocal state
        state, loss = step_mod.train_epoch(state, ds, idx, lr, gen, mcfg, tcfg)
        return loss

    losses, grad_norms = [], None
    for i in range(mix["check_steps"]):
        idx = stream.take(1)
        first_rows.append(idx[0])
        losses.append(float(epoch(idx)))
        if i == 0:
            grad_norms = check.grad_norms(check.nu_sums(_moment(state, "nu")), None, b2, 1)
    reading = {"losses": losses, "grad_norms": grad_norms,
               "change_norms": check.change_norms(state.params, params0), "calls": []}
    del params0
    parts["check_steps"] = time.perf_counter() - cell.t0
    starts = []  # each checked call's rows and the program's state and generator before it
    for _ in range(mix["check_calls"]):
        idx = stream.take(per_call)
        nu = _moment(state, "nu")
        start = {"rows": list(idx), "params": check.host_copy(state.params),
                 "mu": check.host_copy(_moment(state, "mu")), "nu": check.host_copy(nu), "count": state.count,
                 "gen_state": gen.get_state()}
        nu_before = check.nu_sums(nu)
        reading["calls"].append({
            "call_loss": float(epoch(idx)),
            "call_grad_norms": check.grad_norms(check.nu_sums(_moment(state, "nu")), nu_before, b2, idx.shape[0]),
            "call_change_norms": check.change_norms(state.params, start["params"])})
        starts.append(start)
    if idx.shape[0] != min(per_call, stream.steps):
        raise RuntimeError(f"the last checked call has {idx.shape[0]} steps, not the window's {per_call}")
    _sync(device)
    setup_s = time.perf_counter() - cell.t0

    host_s, calls, window_s = 0.0, [], 0.0

    def window():
        nonlocal host_s, window_s
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < cell.seconds:
            idx = stream.take(per_call)
            h0 = time.perf_counter()
            calls.append((epoch(idx), idx.shape[0]))
            host_s += time.perf_counter() - h0
        _sync(device)
        window_s = time.perf_counter() - t_start

    # A cell that reports the device's time a step traces its whole window,
    # the device's activity alone, so that every step of it counts.
    busy_s = None
    if "train_device_ms_per_step" in cell.e2e and not cell.trace and device.type == "cuda":
        busy_s = devtrace.busy_s(window)
        if busy_s is None:
            raise RuntimeError("the device trace of the window holds no device record")
    else:
        window()
    n_steps = sum(k for _, k in calls)
    # A call whose mean loss is not finite counts all its steps as failed.
    finite = torch.isfinite(torch.stack([loss for loss, _ in calls])).tolist()
    failed = sum(k for (_, k), ok in zip(calls, finite) if not ok)

    trace = None
    if cell.trace:
        def stretch():
            left = mix["trace_steps"]
            while left:
                idx = stream.take(left)
                epoch(idx)
                left -= idx.shape[0]
        events = devtrace.traced(stretch)
        trace = devtrace.summarize(events) if events else None

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, calls
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    data, m, t, fused = (ds.codes, ds.targets_u8), cfg["model"], cfg["train"], tcfg.fused_dw_adamw

    def reference(lower=None):
        out = check.first_reference(weights.init(m, weight_seed, device), first_rows, data, gen_state, m, t, fused,
                                    lower)
        out["calls"] = [check.call_reference(s, s["rows"], data, m, t, fused, lower) for s in starts]
        return out

    refr = reference()
    if cell.reference_as_program:
        reading = reference(cell.reference_as_program)
    reference_s = time.perf_counter() - t_ref
    sheets_per_s = n_steps * tcfg.batch_size / window_s
    e2e = {"train_sheets_per_s": sheets_per_s, "setup_s": setup_s}
    if busy_s is not None:
        e2e["train_device_ms_per_step"] = 1e3 * busy_s / n_steps
    return {
        "e2e": e2e,
        "layer": {"kind": "train", "model": cfg["model"], "train": cfg["train"], "steps": n_steps,
                  "host_s": host_s, "sheets_per_s": sheets_per_s, "trace": trace,
                  "traced_steps": mix["trace_steps"]},
        "attempted": n_steps, "failed": failed, "memory_peak_bytes": peak,
        "numbers": check.train_numbers(reading, refr),
        "readings": {"program": reading, "reference": refr},
        "setup_parts": parts, "reference_s": reference_s,
    }
