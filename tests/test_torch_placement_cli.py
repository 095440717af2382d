"""``python -m ai_font_renderer_tpu_torch train-placement`` on the CPU at tiny
shapes: the five smokes of tests/test_train_placement_cli.py on the port
(supervised phase and capacity checkpoint, the joint fine-tune chain,
--init-from's dim recovery and guard, the two full-batch guards), then
--ft-resume against the uninterrupted run, the --mesh refusal, the
attention kernels' flag and the supervised flags, and the files and
metrics keys against the JAX subcommand's.

--ft-resume replays the uninterrupted fine-tune bit for bit: the embedding
gathers' gradients go through F.embedding, whose CPU backward sums in a
fixed order (tests/test_torch_embedding_grad.py).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.config import PRINTABLE_ASCII
from ai_font_renderer_tpu_torch.models import siren
from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config, save_siren

BASE = ["--device", "cpu", "--font", "firacode", "--samples", "240", "--batch", "64"]


def _run(argv):
    return cli.main(["train-placement"] + argv)


def _rows(path):
    return [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]


def _tiny_bank(path):
    """An untrained tiny SIREN bank over the full charset: the chain needs
    only its shapes and charset. A fine-tune step evaluates it at 64 sheets
    x 100 slots x 19^2 window points whatever its cell, so it is narrow."""
    scfg = siren.SirenConfig(n_chars=len(PRINTABLE_ASCII), cell=16, embed_dim=4, hidden_dim=8, n_layers=1)
    save_siren(siren.init(torch.Generator().manual_seed(0), scfg, device="cpu"), scfg, PRINTABLE_ASCII, str(path))
    return scfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CLI runs many small ops, and under a
    parallel test run every worker's thread pool contends for the same
    cores (each op's parallel region then waits on descheduled threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def supervised(tmp_path_factory, one_thread):
    """One epoch of the line head (L 3) on 240 FiraCode strings, and a tiny
    bank."""
    root = tmp_path_factory.mktemp("tp")
    out = root / "sup"
    assert _run(BASE + ["--epochs", "1", "--line-head", "3", "--no-e2e", "--out", str(out)]) == 0
    bank = root / "bank.npz"
    _tiny_bank(bank)
    return out / "placement.npz", bank


def test_supervised_phase_and_capacity_checkpoint(tmp_path):
    """Supervised training runs from the CLI; capacity flags change the
    frontend dims and the dims travel in the checkpoint."""
    out = tmp_path / "run"
    rc = _run(BASE + ["--epochs", "1", "--line-head", "5", "--embed-dim", "64", "--hidden-dim", "96", "--no-e2e",
                      "--out", str(out)])
    assert rc == 0
    lines = _rows(out)
    assert lines[0]["epoch"] == 0 and "val_line_acc" in lines[0]
    assert set(lines[0]) == {"epoch", "train_loss", "val_rmse_px", "val_worst_px", "val_vis_acc", "seconds",
                             "val_line_acc"}
    params, pcfg = load_params_with_config(str(out / "placement.npz"), device="cpu")
    assert pcfg.embedding_dim == 64 and pcfg.hidden_dim == 96
    assert pcfg.num_heads == 8  # embed-dim/8 default ratio preserved
    assert params["embedding"].shape[1] == 64
    assert params["place_w"].shape == (96, 2 + 5)  # line head L=5


def test_finetune_joint_chain_from_cli(supervised, tmp_path):
    """--epochs 0 --init-from + --siren-from --finetune-joint: the pure
    fine-tune continuation runs and saves both tuned artifacts plus the e2e
    eval rows, with the JAX subcommand's keys."""
    net, bank = supervised
    out = tmp_path / "joint"
    rc = _run(BASE + ["--epochs", "0", "--line-head", "3", "--init-from", str(net), "--siren-from", str(bank),
                      "--finetune-joint", "--finetune-steps", "3", "--finetune-samples", "64",
                      "--finetune-schedule", "cosine", "--finetune-lr", "5e-5", "--ft-checkpoint-every", "0",
                      "--out", str(out)])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "placement.npz", "placement_finetuned.npz", "siren.npz",
                                       "siren_finetuned.npz"]
    rows = _rows(out)
    e2e = [r for r in rows if "end_to_end_neural_render_mse" in r]
    assert e2e and set(e2e[-1]) == {"end_to_end_neural_render_mse", "engine_layout_oracle_mse", "siren_final_loss",
                                    "font", "engine_layout_oracle_tuned_mse"}
    assert np.isfinite(e2e[-1]["end_to_end_neural_render_mse"])
    assert np.isfinite(e2e[-1]["engine_layout_oracle_mse"])
    assert np.isfinite(e2e[-1]["engine_layout_oracle_tuned_mse"])
    assert e2e[-1]["siren_final_loss"] is None and e2e[-1]["font"] == "firacode"
    ft = [r for r in rows if "finetune_pixel_mse_last" in r]
    assert ft and np.isfinite(ft[-1]["finetune_pixel_mse_last"]) and np.isfinite(ft[-1]["finetune_pixel_mse_first"])


def test_init_from_recovers_and_guards_capacity(tmp_path):
    """--init-from recovers the checkpoint's dims without flags and refuses
    conflicting capacity flags."""
    out = tmp_path / "cap"
    rc = _run(BASE + ["--epochs", "0", "--line-head", "3", "--embed-dim", "64", "--hidden-dim", "96", "--no-e2e",
                      "--out", str(out)])
    assert rc == 0
    ckpt = str(out / "placement.npz")
    out2 = tmp_path / "cont"
    assert _run(BASE + ["--epochs", "0", "--line-head", "3", "--init-from", ckpt, "--no-e2e", "--out", str(out2)]) == 0
    _, pcfg = load_params_with_config(str(out2 / "placement.npz"), device="cpu")
    assert pcfg.embedding_dim == 64 and pcfg.hidden_dim == 96
    with pytest.raises(SystemExit):
        _run(["--device", "cpu", "--font", "firacode", "--samples", "240", "--epochs", "0", "--line-head", "3",
              "--init-from", ckpt, "--embed-dim", "32", "--no-e2e", "--out", str(tmp_path / "bad")])
    # A head that does not match the checkpoint's is refused too.
    with pytest.raises(SystemExit):
        _run(BASE + ["--epochs", "0", "--line-head", "4", "--init-from", ckpt, "--no-e2e",
                     "--out", str(tmp_path / "bad2")])


def test_finetune_needs_a_full_batch(supervised, tmp_path):
    net, bank = supervised
    with pytest.raises(SystemExit, match="64 train samples"):
        _run(["--device", "cpu", "--font", "firacode", "--samples", "70", "--batch", "64", "--epochs", "0",
              "--line-head", "3", "--init-from", str(net), "--siren-from", str(bank), "--finetune-joint",
              "--finetune-steps", "1", "--finetune-samples", "64", "--ft-checkpoint-every", "0",
              "--out", str(tmp_path / "ft")])


def test_supervised_needs_a_full_batch(tmp_path):
    with pytest.raises(SystemExit, match="train samples per step"):
        _run(["--device", "cpu", "--font", "firacode", "--samples", "70", "--batch", "1024", "--epochs", "1",
              "--line-head", "3", "--no-e2e", "--out", str(tmp_path / "zero")])


@pytest.mark.parametrize("joint", [False, True], ids=["placement", "joint"])
def test_ft_resume_replays_the_uninterrupted_run(supervised, tmp_path, joint):
    """A 4-step fine-tune checkpointed at step 2, then resumed from that
    checkpoint in another run directory: the tuned files and the first and
    last pixel MSE equal the uninterrupted run's bit for bit."""
    net, bank = supervised
    args = BASE + ["--epochs", "0", "--line-head", "3", "--init-from", str(net), "--siren-from", str(bank),
                   "--finetune-steps", "4", "--finetune-samples", "64", "--finetune-schedule", "cosine",
                   "--ft-checkpoint-every", "2"] + (["--finetune-joint"] if joint else [])
    whole, resumed = tmp_path / "whole", tmp_path / "resumed"
    assert _run(args + ["--out", str(whole)]) == 0
    assert sorted(os.listdir(whole / "ft_ckpt")) == ["step_00000002"]
    shutil.copytree(whole / "ft_ckpt", resumed / "ft_ckpt")
    assert _run(args + ["--ft-resume", "--out", str(resumed)]) == 0
    names = ["placement_finetuned.npz"] + (["siren_finetuned.npz"] if joint else [])
    for name in names:
        a, b = np.load(whole / name), np.load(resumed / name)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    ft = [[r for r in _rows(d) if "finetune_pixel_mse_last" in r][-1] for d in (whole, resumed)]
    assert ft[0] == ft[1]
    # Resuming across --finetune-joint settings is refused.
    other = [a for a in args if a != "--finetune-joint"] + ([] if joint else ["--finetune-joint"])
    with pytest.raises(SystemExit, match="finetune-joint"):
        _run(other + ["--ft-resume", "--out", str(resumed)])


def test_mesh_is_refused_citing_item_15(tmp_path, capsys):
    assert _run(BASE + ["--mesh", "2", "--no-e2e", "--out", str(tmp_path / "m")]) == 1
    assert "item 15" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "m")


def test_cuda_without_a_card_exits_1(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert _run(["--font", "firacode", "--no-e2e", "--out", str(tmp_path / "c")]) == 1
    assert "--device cpu" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--kernels", "attention", "--line-head", "3", "--schedule", "cosine", "--embed-dim", "16", "--heads", "2"],
    ["--kernels", "attention_v2", "--line-head", "3", "--boundary-boost", "3", "--boundary-mode", "break",
     "--embed-dim", "16", "--heads", "2"],
    ["--line-head", "3", "--structured", "--detach-structure", "--uncertainty-weights", "--break-ce-boost", "2",
     "--boundary-boost", "2"],
    ["--blocks", "2", "--embed-dim", "16", "--heads", "2"],
], ids=["attention-cosine", "attention_v2-boost-break", "structured-flags", "two-blocks"])
def test_supervised_flags_run(flags, tmp_path, capsys):
    """The attention kernels' flags (their plain versions on CPU tensors,
    the Philox mask drawn in int64 tensor code), the structured head's and
    the sampling flags train one epoch; the loss is finite and loss_logvar
    is logged with --uncertainty-weights."""
    out = tmp_path / "f"
    argv = ["--device", "cpu", "--font", "firacode", "--samples", "200", "--batch", "32", "--epochs", "1", "--no-e2e"]
    assert _run(argv + ["--out", str(out)] + flags) == 0
    row = _rows(out)[0]
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_rmse_px"])
    assert ("loss_logvar" in row) == ("--uncertainty-weights" in flags)
    if "--boundary-boost" in flags:
        assert "boundary boost:" in capsys.readouterr().out
    params, pcfg = load_params_with_config(str(out / "placement.npz"), device="cpu")
    assert ("place_adv" in params) == ("--structured" in flags)
    assert pcfg.fused_attention is False and pcfg.fused_attention_v2 is False  # runtime fields are not saved
