"""Run-artifact manifests, byte-compatible with the reference.

Reproduces `config.txt` (model.py:211-229) and `training_results.txt`
(model.py:373-382) key-for-key so downstream tooling that parses the
reference's artifacts keeps working.

The port's own copy of ai_font_renderer_tpu/train/manifests.py, code unchanged.
"""

from __future__ import annotations

import datetime
import os

from ..config import ModelConfig, TrainConfig


def write_config_manifest(
    output_dir: str,
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    batch_size: int,
    data_size: int,
) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.txt"), "w") as f:
        f.write("# Training configuration\n")
        f.write(f"num_epochs = {tcfg.num_epochs}\n")
        f.write(f"learning_rate = {tcfg.learning_rate}\n")
        f.write(f"batch_size = {batch_size}\n")
        f.write(f"early_stopping_patience = {tcfg.early_stopping_patience}\n")
        f.write(f"validation_split = {tcfg.validation_split}\n")
        f.write(f"weight_decay = {tcfg.weight_decay}\n")
        f.write(f"embedding_dim = {mcfg.embedding_dim}\n")
        f.write(f"dropout_rate = {mcfg.dropout_rate}\n")
        f.write(f"num_attention_heads = {mcfg.num_heads}\n")
        f.write(f"max_length = {mcfg.max_length}\n")
        f.write(f"max_chars_per_sheet = {mcfg.max_length}\n")
        f.write(f"num_samples = {tcfg.num_samples}\n")
        f.write(f"data_size = {data_size}\n")
        f.write(f"random_seed = {tcfg.seed}\n")
        f.write(f"sheet_height = {mcfg.sheet_height}\n")
        f.write(f"sheet_width = {mcfg.sheet_width}\n")


def write_results_manifest(
    output_dir: str,
    final_epoch: int,
    best_val_loss: float,
    final_lr: float,
    early_stopped: bool,
) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "training_results.txt"), "w") as f:
        f.write("# Training Results\n")
        f.write(f"final_epoch = {final_epoch}\n")
        f.write(f"best_validation_loss = {best_val_loss:.6f}\n")
        f.write(f"final_learning_rate = {final_lr:.6f}\n")
        f.write(f"early_stopped = {early_stopped}\n")
        f.write(f"training_duration_epochs = {final_epoch}\n")
        f.write(
            "training_completed = "
            f"{datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S')}\n"
        )
