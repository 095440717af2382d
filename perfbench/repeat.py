"""Run cells one after another, each run its own process, and keep what each
printed: for measuring spreads and proving cells on the card.

    python3 perfbench/repeat.py --out runs.jsonl \\
        flagship.train_corpus:101:10:0 flagship.train_corpus:102:10:1 ...

Each argument is ``workload:seed:seconds:trace``. One JSON line a run goes
to ``--out`` (the result line, the return code, the wall seconds, the end
of standard error) and a short summary to standard output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("runs", nargs="+")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    worst = 0
    for run in args.runs:
        workload, seed, seconds, trace = run.split(":")
        cmd = [sys.executable, str(RUN), "--workload", workload, "--seed", seed, "--seconds", seconds,
               "--trace", trace]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1300)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"run": run, "rc": proc.returncode, "wall_s": wall, "result": result,
               "stderr_tail": proc.stderr[-3000:]}
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        summary = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        checked = {k: v["value"] for k, v in (result or {}).get("checked", {}).items()}
        print(json.dumps({"run": run, "rc": proc.returncode, "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"), "metrics": summary, "checked": checked,
                          "peak": (result or {}).get("device", {}).get("memory_peak_bytes")}), flush=True)
        if proc.returncode:
            print(proc.stderr[-2000:], flush=True)
        worst = max(worst, proc.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
