"""The readings that the limits of a cell's check are set from: the check's
numbers over many seeds for the program as the configuration states it, and
for the control, in one process (set-up runs once a seed; the window is
short, at the cell's own load).

    python3 perfbench/readings.py --workload flagship.train_corpus --seeds 1-12 \\
        --control-seeds 13-15 --seconds 2 --out readings.jsonl

``--fault`` plants one of perfbench/faults.py's faults in every run
(``--late``: in calls of the window's shape only). The
control is named in the cell's limits file: ``{"program":
{field: value}}``, the program with its own lower-precision path switched
on, or ``{"reference": "fp8"}``, the reference one precision lower in the
program's place.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import faults, harness  # noqa: E402


def _seeds(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi) + 1)) if hi else [int(s) for s in text.split(",")]


def main(argv: list[str]) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=("unchanged", "half_batch"),
                   help="plant this fault in the program for every run (perfbench/faults.py)")
    p.add_argument("--late", action="store_true", help="the fault spares calls of one step")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    limits_file = harness.HERE / "limits" / f"{args.workload}.json"
    control = json.loads(limits_file.read_text()).get("control", {})
    runs = [(s, None) for s in _seeds(args.seeds)] if args.seeds else []
    runs += [(s, control) for s in _seeds(args.control_seeds)] if args.control_seeds else []
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed, ctl in runs:
        cell = harness.load_cell(args.workload, seed, args.seconds, False, device, time.perf_counter())
        if ctl:
            cell.program_changes = ctl.get("program")
            cell.reference_as_program = ctl.get("reference")
        with faults.planted(args.fault, args.late) if args.fault else contextlib.nullcontext():
            result = harness.run_cell(cell)
        rec = {"workload": args.workload, "seed": seed, "control": ctl or None, "fault": args.fault,
               "late": args.late, "numbers": result["numbers"], "e2e": result["e2e"],
               "reference_s": result["reference_s"], "readings": result.get("readings")}
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({"seed": seed, "control": bool(ctl), "fault": args.fault, "late": args.late,
                          "numbers": result["numbers"], "e2e": result["e2e"],
                          "reference_s": result["reference_s"]}), flush=True)
        del result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
