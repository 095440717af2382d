"""``train-placement``: the learned-placement training pipeline in PyTorch.

The port of ai_font_renderer_tpu/train/placement_cli.py, stage by stage:
supervised training of the placement net against the layout engine's own
targets (``models/placement.py:placement_targets``) under AdamW, then the
SIREN glyph bank (trained here, or ``--siren-from``), then the pixel
fine-tune (sheet MSE through the differentiable composite into the
placement net) or, with ``--finetune-joint``, the joint one that tunes the
bank too, with step checkpoints and ``--ft-resume``, then the end-to-end
evaluation rows. It writes the same files and ``metrics.jsonl`` keys as the
JAX subcommand; the flags and their defaults are the JAX ones, plus:

* ``--device``: the card (default) or ``cpu``;
* ``--kernels none|attention|attention_v2``: the ``ModelConfig`` runtime
  fields of the placement net (``fused_attention``, ``fused_attention_v2``),
  so its attention block trains through the attention kernels (K5/K6, or
  K7/K8 with the stored mask; ops/fused_attention.py picks the register-
  tiled or the general build from the shape). It changes the path, not the
  function; ``none`` (the default) is the JAX package's ``ModelConfig()``.

``--mesh DATA`` trains data-parallel, as the JAX subcommand: the CLI starts
DATA ranks (parallel/mesh.py), the parameters replicate and each batch
splits over them; the supervised step's loss is the whole batch's (each
rank computes the net's features on its rows, and the rows are gathered
before the loss, so its normalisers are the one-device step's), the
fine-tune's the mean of the ranks' equal shards. Rank 0 alone writes the
run's files. The random streams: numpy's ``default_rng(42)`` for the split, the
boundary boost and the epoch order, as in the JAX package; the placement
init from a ``torch.Generator`` seeded 0 and dropout from one seeded 7 (the
JAX package's PRNGKey(0) and PRNGKey(7); threefry's numbers are not
reproduced, their distributions are).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import FIRACODE_PATH, MONTSERRAT_PATH, PRINTABLE_ASCII, ModelConfig, SheetSpec, replace
from ..fontgen.layout import AdvanceTable, encode_codes
from .optim import Adam, cosine_decay_schedule, tree_leaves, tree_map, warmup_cosine_decay_schedule

KERNELS = {
    "none": {},
    "attention": {"fused_attention": True},
    "attention_v2": {"fused_attention_v2": True},
}
FT_BATCH = 64  # sheets a fine-tune step


def build_table(font_path: str, spec: SheetSpec, charset: str, kerned: bool) -> AdvanceTable:
    """Advance/kerning metrics the supervision targets are built from."""
    from ..fontgen.ttf import TrueTypeFont

    font = TrueTypeFont.load(font_path)
    adv = np.array([font.advance(font.glyph_id(ord(c))) * spec.font_size / font.units_per_em for c in charset])
    kern = None
    if kerned:
        from ..fontgen.kerning import KerningTable

        kern = KerningTable(font_path, charset, spec.font_size)
    return AdvanceTable(charset, adv, kern)


def add_args(ap: argparse.ArgumentParser) -> None:
    """Register the train-placement flags on ``ap``: the JAX subcommand's,
    with its defaults, plus ``--device`` and ``--kernels``."""
    ap.add_argument("--font", default="montserrat", choices=["montserrat", "firacode"])
    ap.add_argument("--samples", type=int, default=50000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--embed-dim", type=int, default=None, metavar="E",
                    help="placement-frontend embedding width (default 32); heads stay 8 wide unless --heads")
    ap.add_argument("--hidden-dim", type=int, default=None, metavar="H",
                    help="placement-frontend MLP/feature width (default 64)")
    ap.add_argument("--heads", type=int, default=None, metavar="N",
                    help="attention heads (default embed-dim/8 when --embed-dim is given, else 4)")
    ap.add_argument("--blocks", type=int, default=None, metavar="B",
                    help="number of (MHA -> residual -> post-LN) blocks (default 1)")
    ap.add_argument("--line-head", type=int, default=0, metavar="L",
                    help="the line-classification head with L line classes: y decoded from a line "
                    "distribution instead of regressed")
    ap.add_argument("--structured", action="store_true",
                    help="the structured head (requires --line-head L): x derived from the predicted break "
                    "structure over the checkpoint-carried advance/kern tables plus a learned residual")
    ap.add_argument("--detach-structure", action="store_true",
                    help="stop the x error's gradients at the structure probabilities inside structured_x")
    ap.add_argument("--schedule", default="const", choices=["const", "cosine"],
                    help="const, or 5%% linear warmup then cosine decay to 0 over all epochs")
    ap.add_argument("--boundary-boost", type=int, default=1, metavar="F",
                    help="replicate F-1 extra times in the train split the strings with a near-boundary wrap "
                    "decision (the val split is untouched)")
    ap.add_argument("--boundary-margin", type=float, default=12.0,
                    help="margin in px for --boundary-boost's and --break-ce-boost's tests")
    ap.add_argument("--boundary-mode", default="extent", choices=["extent", "break"],
                    help="hardness test for --boundary-boost: a line's rightmost glyph extent within the "
                    "margin of the usable width ('extent'), or a wrap decision within the margin of "
                    "flipping ('break')")
    ap.add_argument("--break-ce-boost", type=float, default=0.0, metavar="B",
                    help="weight a slot's line CE by 1+B where its own wrap decision was within "
                    "--boundary-margin px of flipping; requires a line head")
    ap.add_argument("--uncertainty-weights", action="store_true",
                    help="learned loss-term balance: one log-variance per term, sum(exp(-s)*L + s)")
    ap.add_argument("--init-from", default=None, metavar="NPZ",
                    help="initialize from a saved placement checkpoint (head and dims must match; dims come "
                    "from its config); with --epochs 0 a pure pixel fine-tune of it")
    ap.add_argument("--finetune-schedule", default="const", choices=["const", "cosine"],
                    help="fine-tune LR: constant, or cosine decay to 0 over --finetune-steps")
    ap.add_argument("--finetune-lr", type=float, default=1e-4, metavar="LR",
                    help="fine-tune LR (const) or cosine peak")
    ap.add_argument("--finetune-joint", action="store_true",
                    help="pixel fine-tune the SIREN bank jointly with the placement net; saves "
                    "siren_finetuned.npz too")
    ap.add_argument("--finetune-samples", type=int, default=256,
                    help="train strings the pixel fine-tune optimizes over")
    ap.add_argument("--siren-from", default=None, metavar="NPZ",
                    help="load the e2e SIREN bank from a save_siren file instead of training it "
                    "(--e2e-steps is then ignored)")
    ap.add_argument("--ft-checkpoint-every", type=int, default=2000, metavar="N",
                    help="checkpoint the fine-tune (tunable + Adam state + step) to <out>/ft_ckpt every N "
                    "steps (0 = off)")
    ap.add_argument("--ft-resume", action="store_true",
                    help="resume the fine-tune from <out>/ft_ckpt's latest step; the batch schedule is a "
                    "function of the step, so the resumed run replays the uninterrupted one")
    ap.add_argument("--mesh", type=int, default=None, metavar="DATA",
                    help="data-parallel ways: DATA ranks, one a card (with --device cpu, CPU ranks); the "
                    "placement params replicate and each batch splits over them")
    ap.add_argument("--out", default=None)
    ap.add_argument("--e2e-steps", type=int, default=3000)
    ap.add_argument("--no-e2e", action="store_true")
    ap.add_argument("--finetune-steps", type=int, default=200,
                    help="end-to-end pixel fine-tune steps (0 = skip; needs the e2e SIREN bank)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernels", choices=sorted(KERNELS), default="none",
                    help="none (default): plain PyTorch attention; attention: K5/K6; attention_v2: K7/K8")


def _placement_config(args, ap: argparse.ArgumentParser) -> ModelConfig:
    """Resolve the placement frontend dims from flags / --init-from."""
    from ..utils.checkpoint import load_params_with_config

    pcfg = ModelConfig()
    if args.init_from:
        # Dims travel in the checkpoint; flags may confirm, not conflict.
        _, loaded_cfg = load_params_with_config(args.init_from, device="cpu")
        if loaded_cfg is not None:
            pcfg = loaded_cfg
        for flag, field in (
            ("embed_dim", "embedding_dim"),
            ("hidden_dim", "hidden_dim"),
            ("heads", "num_heads"),
            ("blocks", "num_blocks"),
        ):
            v = getattr(args, flag)
            if v is not None and v != getattr(pcfg, field):
                ap.error(
                    f"--{flag.replace('_', '-')} {v} conflicts with the --init-from checkpoint's "
                    f"{field}={getattr(pcfg, field)}"
                )
        return pcfg
    kw = {}
    if args.embed_dim is not None:
        kw["embedding_dim"] = args.embed_dim
        # Keep 8-dim heads unless told otherwise: the flagship's ratio.
        kw["num_heads"] = args.heads or max(1, args.embed_dim // 8)
    if args.heads is not None:
        kw["num_heads"] = args.heads
    if args.hidden_dim is not None:
        kw["hidden_dim"] = args.hidden_dim
    if args.blocks is not None:
        kw["num_blocks"] = args.blocks
    return replace(pcfg, **kw) if kw else pcfg


def trainable(tree):
    """Own copies of a tree's tensors as leaves that require a gradient: the
    steps update them in place."""
    return tree_map(lambda v: v.detach().clone().requires_grad_(), tree)


def _dp_shardings(mesh):
    """(replicated, batch-sharded) placements on a data-parallel mesh: a
    rank keeps a replicated tensor whole and takes its rows of a batch."""

    def replicated(t):
        return t

    def batch_sharded(t):
        return t[mesh.data_rows(t.shape[0])]

    return replicated, batch_sharded


def make_supervised_step(pcfg: ModelConfig, opt, detach_structure: bool = False, mesh=None):
    """The supervised placement step: ``step(params, opt_state, codes,
    mids, vis, line_tgt, contrib_tgt, ce_w, generator) -> (params,
    opt_state, loss)``, params and state updated in place. line_tgt,
    contrib_tgt and ce_w are None where the head or flags do not use them;
    dropout draws from ``generator``.

    With ``mesh`` (parallel.Mesh, data-parallel) every rank passes the
    whole batch and the shared generator: it computes the net's features on
    its rows (with its rows of the one-device dropout masks), the features
    are gathered (font_renderer.BatchRows), and the heads and the loss run
    on the whole batch, so the loss and its normalisers are the one-device
    step's. The frontend's gradients are then summed over the ranks; the
    heads' are whole on every rank."""
    from ..models import font_renderer, placement

    front = set(font_renderer.frontend_keys(pcfg))

    def step(params, opt_state, c, m, v, lt, ct, cw, generator):
        if mesh is not None and mesh.data > 1:
            rows = mesh.data_rows(c.shape[0])
            gather = functools.partial(mesh.gather_rows, start=rows.start, total=c.shape[0])
            generator = font_renderer.BatchRows(generator, rows.start, rows.stop, c.shape[0], gather)
        loss = placement.loss_fn(
            params, c, m, v, pcfg, generator=generator, train=True, line_tgt=lt, contrib_tgt=ct,
            detach_structure=detach_structure, ce_w=cw,
        )
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
        if mesh is not None and mesh.data > 1:
            shared = [k in front for k in params]
            summed = iter(mesh.data_sum_all([g for g, f in zip(grads, shared) if f]))
            grads = [next(summed) if f else g for g, f in zip(grads, shared)]
        opt.update_(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return step


def make_pixel_loss(pcfg: ModelConfig, scfg, lay, bank=None):
    """The fine-tune's sheet MSE: ``pixel_loss(tunable, codes, ids, valid,
    gt)``. ``tunable`` is the placement params, with the SIREN ``bank``
    frozen, or with ``bank=None`` the (placement, siren) pair of the joint
    fine-tune. The net's midpoints (eval mode) become window origins, the
    bank paints the windows (``compose``), and the error flows back into
    the bank's params and, through the windows' cell coordinates, into the
    origins."""
    from ..models import placement
    from ..render.implicit_sheet import compose, origins_from_midpoints

    def pixel_loss(tunable, c, ids, valid, gt):
        p, sp = tunable if bank is None else (tunable, bank)
        xy, _ = placement.apply(p, c, pcfg, train=False)
        sheets = compose(sp, ids, origins_from_midpoints(xy, lay), valid, scfg, lay)
        return torch.mean((sheets - gt) ** 2)

    return pixel_loss


def make_finetune_step(pixel_loss, ft_opt, mesh=None):
    """The pixel/joint fine-tune step: ``step(tunable, state, codes, ids,
    valid, gt) -> (tunable, state, loss)``, updated in place. With ``mesh``
    (data-parallel) the tunable tree replicates, each rank takes its rows
    of the whole batch it is passed, and the loss (a mean over equal
    shards) and the gradients are averaged over the ranks."""
    shard = None if mesh is None or mesh.data == 1 else _dp_shardings(mesh)[1]

    def step(t, st, c, ids, valid, gt):
        if shard is not None:
            c, ids, valid, gt = (shard(a) for a in (c, ids, valid, gt))
        loss = pixel_loss(t, c, ids, valid, gt)
        grads = torch.autograd.grad(loss, tree_leaves(t), allow_unused=True)
        if shard is not None:
            loss, *grads = mesh.data_sum_all([loss.detach(), *grads], mean=True)
        ft_opt.update_(t, grads, st)
        return t, st, loss.detach()

    return step


def _min_decision_margin(text: str, table: AdvanceTable, max_w: float, S: int) -> float:
    """The smallest |measure(candidate) - max_w| over the engine's
    accept/reject decisions on ``text`` (``--boundary-mode break``)."""
    m = np.inf
    cur = ""
    for w in text[:S].split(" "):
        test = f"{cur} {w}" if cur else w
        meas = table.measure(test)
        if meas > max_w and cur:
            m = min(m, meas - max_w)  # rejected: overflow
            cur = w
        else:
            if cur and meas <= max_w:
                m = min(m, max_w - meas)  # accepted: slack
            cur = test
    return m


def _ascii_advances(table: AdvanceTable, charset: str) -> np.ndarray:
    adv = np.full(128, table.advances_px[0], np.float32)
    for i, c in enumerate(charset):
        adv[ord(c)] = table.advances_px[i]
    return adv


def run(args, ap: argparse.ArgumentParser, argv: list[str] | None = None) -> int:
    """Execute the full train-placement pipeline for parsed ``args``. With
    ``--mesh DATA`` above 1, start DATA ranks that run ``argv`` (the
    subcommand's arguments) and wait for them, unless this process is one."""
    from ..device import resolve_device
    from ..parallel import mesh as pmesh

    if args.structured and args.line_head < 2:
        ap.error("--structured requires --line-head L (L >= 2)")
    if args.break_ce_boost > 0 and args.line_head < 2:
        ap.error("--break-ce-boost weights a line CE; needs --line-head")
    mesh = None
    if args.mesh and args.mesh > 1:
        # The batch guards trip before any data work, as in the JAX package.
        if args.batch % args.mesh:
            ap.error(f"--batch {args.batch} not divisible by --mesh {args.mesh}")
        if args.finetune_steps > 0 and FT_BATCH % args.mesh:
            ap.error(f"--mesh {args.mesh} must divide the fine-tune batch ({FT_BATCH})")
        if not pmesh.is_rank():
            return _launch_ranks(args, argv)
        pmesh.init_rank()
        mesh = pmesh.make_mesh(data=args.mesh, model=1)
        print(f"mesh: {args.mesh}-way data parallel over {mesh.size} devices", flush=True)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    out_dir = args.out or f"extended_runs/placement_{args.font}"
    writes = mesh is None or mesh.is_main
    try:
        if writes:
            os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "metrics.jsonl") if writes else os.devnull, "a", buffering=1) as metrics:
            return _run(args, ap, dev, out_dir, metrics, mesh)
    finally:
        if mesh is not None:
            pmesh.finish_rank()


def _launch_ranks(args, argv) -> int:
    """Start ``args.mesh`` ranks of ``train-placement argv``: one a visible
    card (NCCL), or with ``--device cpu`` CPU ranks (gloo). With fewer
    cards, exit 1 with make_mesh's message."""
    from ..parallel import mesh as pmesh

    if argv is None:
        raise ValueError("--mesh above 1 starts ranks of the command line: pass its argv")
    device = "cpu" if args.device == "cpu" else "cuda"
    try:
        # On the CPU the ranks are the devices; on the card, the cards.
        pmesh.mesh_shape(args.mesh, 1, range(args.mesh) if device == "cpu" else pmesh.available_devices())
    except ValueError as e:
        print(f"Error: {e}")
        return 1
    return pmesh.launch(["-m", "ai_font_renderer_tpu_torch", "train-placement", *argv], args.mesh, device)


def _run(args, ap, dev: torch.device, out_dir: str, metrics, mesh=None) -> int:
    from ..cli import TEST_STRINGS
    from ..fontgen.textgen import generate_corpus
    from ..models import placement
    from ..utils.checkpoint import load_params_with_config, save_params

    font_path = MONTSERRAT_PATH if args.font == "montserrat" else FIRACODE_PATH
    spec = SheetSpec()
    pcfg = replace(_placement_config(args, ap), **KERNELS[args.kernels])
    charset = PRINTABLE_ASCII  # index 0 is space, the engine convention
    kerned = args.font == "montserrat"  # proportional pipeline kerns
    table = build_table(font_path, spec, charset, kerned)
    stage_s = {}

    t0 = time.time()
    strings = generate_corpus(args.samples)
    codes_np = encode_codes(strings, spec.max_chars)
    want_margins = args.break_ce_boost > 0
    margin_np = None
    tgts = placement.placement_targets(strings, table, spec, full=args.structured, margins=want_margins)
    mids_np, vis_np = tgts[:2]
    if args.structured:
        line_np, contrib_np = tgts[2:4]
    if want_margins:
        margin_np = tgts[-1]
    stage_s["targets"] = time.time() - t0
    print(f"targets built in {stage_s['targets']:.1f} s", flush=True)

    n_val = args.samples // 5
    rng = np.random.default_rng(42)
    perm = rng.permutation(args.samples)
    tr, va = perm[n_val:], perm[:n_val]
    if args.boundary_boost > 1:
        # Replicate HARD train indices so the CE sees the ambiguous
        # boundary cases boost-times as often ('extent': a line's rightmost
        # glyph extent within the margin of the usable width; 'break': a
        # wrap decision within the margin of flipping).
        if args.boundary_mode == "break":
            max_w = spec.width - 2 * spec.padding
            margins = np.array([_min_decision_margin(s, table, max_w, spec.max_chars) for s in strings])
            hard = margins < args.boundary_margin
        else:
            half_adv = 0.5 * _ascii_advances(table, charset)[np.clip(codes_np, 0, 127)]
            extent = np.where(vis_np, mids_np[..., 0] + half_adv, 0.0).max(axis=1)
            hard = extent > (spec.width - spec.padding - args.boundary_margin)
        boosted = tr[hard[tr]]
        tr = np.concatenate([tr] + [boosted] * (args.boundary_boost - 1))
        print(
            f"boundary boost: {len(boosted)}/{args.samples - n_val} hard train strings x{args.boundary_boost} "
            f"(epoch now {len(tr)} samples)",
            flush=True,
        )
    codes = torch.from_numpy(codes_np).to(dev)
    mids = torch.from_numpy(mids_np).to(dev)
    vis = torch.from_numpy(vis_np).to(dev)
    ce_w = None
    if args.break_ce_boost > 0:
        hard_slot = margin_np < args.boundary_margin
        ce_w = torch.from_numpy(1.0 + args.break_ce_boost * hard_slot.astype(np.float32)).to(dev)
        print(
            f"break-CE boost: {hard_slot.mean():.3f} of slots weighted x{1 + args.break_ce_boost:g} "
            f"(margin < {args.boundary_margin})",
            flush=True,
        )
    head = {"lines": args.line_head, "uncertainty": args.uncertainty_weights}
    if args.structured:
        line_t = torch.from_numpy(line_np).to(dev)
        contrib_t = torch.from_numpy(contrib_np).to(dev)
        kern128 = np.zeros((128, 128), np.float32)
        if kerned:
            for a in charset:
                for b in charset:
                    k = table.kern(a, b)
                    if k:
                        kern128[ord(a), ord(b)] = k
        head.update(advances=_ascii_advances(table, charset), kerning=kern128)
    params = placement.init(torch.Generator().manual_seed(0), pcfg, device=dev, **head)
    if args.init_from:
        loaded, _ = load_params_with_config(args.init_from, base=None, device=dev)
        if placement.head_lines(loaded) != placement.head_lines(params) or (
            placement.head_structured(loaded) != placement.head_structured(params)
        ):
            ap.error(
                f"--init-from checkpoint head (lines={placement.head_lines(loaded)}, "
                f"structured={placement.head_structured(loaded)}) does not match the requested flags"
            )
        params = loaded
    params = trainable(params)
    total_steps = max(args.epochs * (len(tr) // args.batch), 1)
    if args.schedule == "cosine":
        lr = warmup_cosine_decay_schedule(0.0, args.lr, max(total_steps // 20, 1), total_steps)
    else:
        lr = args.lr
    opt = Adam(lr, weight_decay=1e-4)
    opt_state = opt.init(params)
    step = make_supervised_step(pcfg, opt, args.detach_structure, mesh)
    writes = mesh is None or mesh.is_main

    @torch.no_grad()
    def evaluate(params, c, m, v):
        xy, logit = placement.apply(params, c, pcfg, train=False)
        vf = v.float()
        n = torch.clamp(vf.sum(), min=1.0)
        se = torch.sum((xy - m) ** 2, -1)
        rmse = torch.sqrt(torch.sum(se * vf) / n)
        worst = torch.max(torch.where(v, torch.sqrt(se), 0.0))
        acc = torch.mean(((torch.sigmoid(logit) > 0.5) == v).float())
        lacc = torch.zeros(())
        if args.line_head:
            ll = placement.line_logits(params, c, pcfg, train=False)
            tgt = torch.clamp(torch.round(m[..., 1] / spec.line_height).to(torch.int32) - 1, 0, args.line_head - 1)
            lacc = torch.sum((ll.argmax(-1) == tgt) * vf) / n
        return rmse, worst, acc, lacc

    bsz = args.batch
    steps_per_epoch = len(tr) // bsz
    if args.epochs > 0 and steps_per_epoch == 0:
        # A train split smaller than one batch would train zero steps an
        # epoch and save the random init.
        raise SystemExit(
            f"--epochs {args.epochs} needs at least --batch ({bsz}) train samples per step (have {len(tr)} "
            "train strings); raise --samples or lower --batch"
        )
    gen = torch.Generator(device=dev).manual_seed(7)
    stage_s["supervised_train"] = 0.0
    for epoch in range(args.epochs):
        t0 = time.time()
        order = torch.from_numpy(rng.permutation(tr)).to(dev)
        losses = []
        for s in range(steps_per_epoch):
            idx = order[s * bsz : (s + 1) * bsz]
            lt = line_t[idx] if args.structured else None
            ct = contrib_t[idx] if args.structured else None
            cw = ce_w[idx] if ce_w is not None else None
            params, opt_state, loss = step(params, opt_state, codes[idx], mids[idx], vis[idx], lt, ct, cw, gen)
            losses.append(loss)
        # The epoch's losses summed in float64 one by one, as the JAX loop's
        # float(loss) each step, read once.
        loss_sum = 0.0
        for v in torch.stack(losses).tolist() if losses else []:
            loss_sum += v
        stage_s["supervised_train"] += time.time() - t0
        # Every rank evaluates the whole split alike (the JAX package shards
        # it, and rounds it to a multiple of the mesh).
        n_eval = 4096 if mesh is None else 4096 // args.mesh * args.mesh
        vi = torch.from_numpy(va[:n_eval]).to(dev)
        rmse, worst, acc, lacc = evaluate(params, codes[vi], mids[vi], vis[vi])
        rec = {
            "epoch": epoch,
            "train_loss": loss_sum / max(steps_per_epoch, 1),
            "val_rmse_px": float(rmse),
            "val_worst_px": float(worst),
            "val_vis_acc": float(acc),
            "seconds": time.time() - t0,
        }
        if args.line_head:
            rec["val_line_acc"] = float(lacc)
        if args.uncertainty_weights:
            rec["loss_logvar"] = [round(float(v), 4) for v in params["loss_logvar"].detach().cpu().numpy()]
        print(json.dumps(rec), flush=True)
        metrics.write(json.dumps(rec) + "\n")
    if writes:
        save_params(params, os.path.join(out_dir, "placement.npz"), mcfg=pcfg)

    ft_steps = 0
    if not args.no_e2e:
        ft_steps = _end_to_end(args, params, pcfg, spec, charset, font_path, strings, tr, dev, out_dir, metrics,
                               TEST_STRINGS, stage_s, mesh)
    # Seconds of each stage, for a reader of the run's output; the training
    # loops end in a read of their losses, so their seconds are the device's too.
    print(json.dumps({"stage_seconds": stage_s, "supervised_steps": args.epochs * steps_per_epoch,
                      "finetune_steps": ft_steps}), flush=True)
    return 0


def _end_to_end(args, params, pcfg, spec, charset, font_path, strings, tr, dev, out_dir, metrics,
                test_strings, stage_s, mesh=None) -> int:
    """The SIREN bank, the pixel (or joint) fine-tune and the end-to-end
    evaluation rows: the neural render against the bitmap ground truth,
    beside the engine-layout render with the same bank (the oracle) ->
    the fine-tune steps this run took. On a mesh every rank trains the same
    bank from the same seed, the fine-tune is data-parallel, and rank 0
    alone writes."""
    writes = mesh is None or mesh.is_main
    from ..fontgen.dataset import bake_font_atlas, synthesize_ground_truth, unit_ground_truth
    from ..fontgen.ttf import TrueTypeFont
    from ..models import siren
    from ..render.implicit_sheet import build_layout, known_slots, render_implicit_sheets, render_learned_sheets
    from ..utils.checkpoint import CheckpointManager, load_siren, save_params, save_siren
    from .implicit import train_siren

    t0 = time.time()
    if args.siren_from:
        sp, scfg, siren_charset = load_siren(args.siren_from, device=dev)
        if siren_charset != charset:
            raise SystemExit(
                f"--siren-from bank charset ({len(siren_charset)} chars) does not match the run charset "
                f"({len(charset)} chars)"
            )
        losses = [float("nan")]  # no training loss for a loaded bank
    else:
        scfg = siren.SirenConfig(n_chars=len(charset), cell=64)
        sp, losses, _ = train_siren(font_path, scfg, charset=charset, steps=args.e2e_steps, lr=3e-4, device=dev)
    stage_s["siren"] = time.time() - t0
    if writes:
        save_siren(sp, scfg, charset, os.path.join(out_dir, "siren.npz"), font=font_path)
    atlas = bake_font_atlas(font_path, proportional=args.font == "montserrat")

    sp_eval = sp  # the tuned bank under --finetune-joint
    ft_steps = 0
    if args.finetune_steps > 0:
        t0 = time.time()
        # A whole number of FT_BATCH slices, so every step has one shape.
        ft_n = min(args.finetune_samples, len(tr)) // FT_BATCH * FT_BATCH
        if ft_n == 0:
            raise SystemExit(
                f"--finetune-steps needs at least 64 train samples per batch (have {len(tr)} train strings, "
                f"--finetune-samples {args.finetune_samples}); raise --samples/--finetune-samples"
            )
        ft_strings = [strings[i] for i in tr[:ft_n]]
        gt_ft = torch.from_numpy(
            np.asarray(synthesize_ground_truth(atlas, ft_strings, on_device=True, device=dev), np.float32)
        ).to(dev)
        lay = build_layout(TrueTypeFont.load(font_path), spec, scfg.cell, max_glyphs=pcfg.max_length)
        ft_codes = torch.from_numpy(encode_codes(ft_strings, pcfg.max_length)).to(dev)
        ids_np, val_np = known_slots(ft_strings, charset, pcfg.max_length)
        ft_ids, ft_valid = torch.from_numpy(ids_np).to(dev), torch.from_numpy(val_np).to(dev)
        if args.finetune_schedule == "cosine":
            ft_lr = cosine_decay_schedule(args.finetune_lr, args.finetune_steps)
        else:
            ft_lr = args.finetune_lr
        ft_opt = Adam(ft_lr)
        if args.finetune_joint:
            tunable = (params, trainable(sp))
            pixel_loss = make_pixel_loss(pcfg, scfg, lay)
        else:
            tunable = params
            pixel_loss = make_pixel_loss(pcfg, scfg, lay, bank=sp)
        ft_state = ft_opt.init(tunable)
        ft_step = make_finetune_step(pixel_loss, ft_opt, mesh)

        first_px = last = None
        start_step = 0
        ft_mgr = None
        if args.ft_checkpoint_every > 0 or args.ft_resume:
            ft_mgr = CheckpointManager(os.path.join(out_dir, "ft_ckpt"), keep=2)
        if args.ft_resume and ft_mgr is not None and ft_mgr.latest_step():
            # The schedule and the batch slices are functions of the step
            # index, so restoring (tunable, Adam state) at step k replays the
            # uninterrupted run.
            if ft_mgr.host_state().get("joint", False) != args.finetune_joint:
                raise SystemExit(
                    "ft_ckpt was written with a different --finetune-joint setting; refusing to resume "
                    "across head structures"
                )
            start_step, (tunable, ft_state), host = ft_mgr.restore_tree(template=(tunable, ft_state))
            first_px = host.get("first_px")
            print(f"fine-tune resumed at step {start_step}", flush=True)
        first = None
        stage_s["finetune_setup"] = time.time() - t0
        t0 = time.time()
        for s in range(start_step, args.finetune_steps):
            lo = (s * FT_BATCH) % ft_n
            sl = slice(lo, lo + FT_BATCH)
            tunable, ft_state, last = ft_step(tunable, ft_state, ft_codes[sl], ft_ids[sl], ft_valid[sl], gt_ft[sl])
            if first_px is None and first is None:
                first = last
            if (s + 1) % 500 == 0:
                # Progress heartbeat, so a long fine-tune can be polled.
                metrics.write(json.dumps({"finetune_step": s + 1, "pixel_mse": float(last)}) + "\n")
            if (
                ft_mgr is not None
                and writes
                and args.ft_checkpoint_every > 0
                and (s + 1) % args.ft_checkpoint_every == 0
                and (s + 1) < args.finetune_steps
            ):
                if first is not None:
                    first_px, first = float(first), None
                ft_mgr.save_tree(s + 1, (tunable, ft_state), {"joint": args.finetune_joint, "first_px": first_px})
        if first is not None:
            first_px = float(first)
        last_px = None if last is None else float(last)
        stage_s["finetune"] = time.time() - t0
        ft_steps = args.finetune_steps - start_step
        params, sp_tuned = tunable if args.finetune_joint else (tunable, None)
        rec = {"finetune_pixel_mse_first": first_px, "finetune_pixel_mse_last": last_px}
        print(json.dumps(rec), flush=True)
        metrics.write(json.dumps(rec) + "\n")
        if writes:
            save_params(params, os.path.join(out_dir, "placement_finetuned.npz"), mcfg=pcfg)
        if sp_tuned is not None:
            if writes:
                save_siren(sp_tuned, scfg, charset, os.path.join(out_dir, "siren_finetuned.npz"), font=font_path)
            # The e2e row measures what joint training bought: the tuned
            # bank renders the learned sheets; the oracle row keeps the
            # ORIGINAL bank, which the engine layout was trained against.
            sp_eval = sp_tuned

    t0 = time.time()
    learned = render_learned_sheets(sp_eval, params, test_strings, font_path, scfg, pcfg, spec, charset=charset)
    oracle = render_implicit_sheets(sp, test_strings, font_path, scfg, spec, charset=charset)
    gt = unit_ground_truth(atlas, test_strings)
    rec = {
        "end_to_end_neural_render_mse": float(np.mean((learned.cpu().numpy() - gt) ** 2)),
        "engine_layout_oracle_mse": float(np.mean((oracle.cpu().numpy() - gt) ** 2)),
        "siren_final_loss": None if np.isnan(losses[-1]) else float(losses[-1]),
        "font": args.font,
    }
    if sp_eval is not sp:
        # The tuned bank's own engine-layout oracle, beside the original
        # bank's cross-run floor above.
        oracle_tuned = render_implicit_sheets(sp_eval, test_strings, font_path, scfg, spec, charset=charset)
        rec["engine_layout_oracle_tuned_mse"] = float(np.mean((oracle_tuned.cpu().numpy() - gt) ** 2))
    stage_s["eval_rows"] = time.time() - t0
    print(json.dumps(rec), flush=True)
    metrics.write(json.dumps(rec) + "\n")
    return ft_steps


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch train-placement")
    add_args(ap)
    argv = sys.argv[1:] if argv is None else argv
    return run(ap.parse_args(argv), ap, argv)
