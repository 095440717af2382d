"""Operations and bytes of the font renderer, from a configuration's shapes.

``forward_flops`` counts the multiply-adds of one sheet's forward pass, two
operations each: the attention's four projections and its two products,
fc1, and the output projection (the flagship's 248.3 MFLOP a sheet; the
elementwise work is left out). A training step's model work is three
forwards (forward, and twice that for the backward; no recomputation).

``train_functions`` splits that work into the functions a step has to do,
each with the operations at the precision the configuration states and the
bytes it cannot avoid: the weights it reads in the operand type, the
optimizer state it reads and writes once, the batch it reads.
Intermediates that a fused kernel could keep on chip are not counted, so
each function's least time, the larger of operations over peak and bytes over bandwidth,
bounds the time of any implementation of it from below.
"""

from __future__ import annotations

from . import peaks


def _dims(m: dict) -> tuple[int, int, int, int, int, int]:
    s, e, h = m["max_length"], m["embedding_dim"], m["hidden_dim"]
    return s, e, h, m["num_heads"], s * h, m["sheet_height"] * m["sheet_width"]


def forward_flops(m: dict) -> dict:
    """{part: operations} of one sheet's forward pass."""
    s, e, h, _, k, n = _dims(m)
    blocks = m.get("num_blocks", 1)
    return {
        "attention": blocks * (4 * 2 * s * e * e + 2 * 2 * s * s * e),
        "fc1": 2 * s * e * h,
        "projection": 2 * k * n,
    }


def model_flops_per_sheet(m: dict) -> float:
    return float(sum(forward_flops(m).values()))


def _precisions(m: dict) -> tuple[str, int, str, int]:
    front = "bf16" if m.get("bf16_frontend") else "f32"
    proj = "bf16" if m.get("bf16_matmul", True) else "f32"
    return front, 2 if front == "bf16" else 4, proj, 2 if proj == "bf16" else 4


def train_functions(m: dict, t: dict) -> list[dict]:
    """The functions of one training step at batch ``t["batch_size"]``:
    [{"name", "flops", "precision", "bytes"}]."""
    b = t["batch_size"]
    s, e, h, _, k, n = _dims(m)
    front, _, proj, pes = _precisions(m)
    f = forward_flops(m)
    mu = 2 if t.get("adam_mu_bf16", True) else 4
    state = 4 + mu + 4  # w, mu, nu: each read and written once
    n_front = sum(c for c in (m["vocab_size"] * e, s * e, e * h, h)) + m.get("num_blocks", 1) * (4 * e * e + 6 * e)
    return [
        {"name": "frontend fwd+bwd", "flops": 3 * b * (f["attention"] + f["fc1"]), "precision": front,
         "bytes": 4 * b * s},
        {"name": "projection fwd + loss", "flops": b * f["projection"], "precision": proj,
         "bytes": pes * (b * k + k * n) + b * n},
        {"name": "projection dX", "flops": b * f["projection"], "precision": proj, "bytes": pes * k * n},
        {"name": "out_w dW + AdamW", "flops": b * f["projection"], "precision": proj,
         "bytes": 2 * state * (k * n + n)},
        {"name": "AdamW of the frontend", "flops": 0, "precision": front, "bytes": 2 * state * n_front},
    ]


def least_seconds(functions: list[dict]) -> float:
    """The least time of the functions on one H100: each function's larger
    of operations over its precision's peak and bytes over HBM bandwidth,
    summed (the functions run one after another)."""
    return sum(max(fn["flops"] / peaks.FLOPS[fn["precision"]], fn["bytes"] / peaks.HBM_BYTES_PER_S)
               for fn in functions)
