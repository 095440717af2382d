"""One run of one cell: ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:
its configuration (``configs/<config>.json``, whose ``decoder`` names its
reference and counts: ``reference/<decoder>.py``, ``counts/<decoder>.py``),
its traffic mix (``traffic/<mix>.json``, whose ``kind`` names its driver,
``<kind>_cell.py``), the limits of its check (``limits/<workload>.json``)
and each per-layer metric's reader (``metrics/<metric>.py``). So a new
configuration, mix, driver, metric or cell is new files and new entries,
and no edit. The last line of standard output is one JSON object; the
numbers of the check, each beside its limit, close it and are also the
last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

from . import traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ai_font_renderer_tpu")


@dataclasses.dataclass
class Cell:
    """One run's inputs; the drivers read nothing else."""

    name: str
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    root: Path = ROOT  # the checkout whose perfbench/ holds the cell's files
    program_changes: dict | None = None  # a control: the program's own lower-precision path
    reference_as_program: str | None = None  # a control: the reference at this precision stands in
    e2e: tuple = ()  # the names of the end-to-end metrics that the cell reports


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float, root: Path = ROOT,
              overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files;
    ``overrides`` {"model"|"train"|"mix"|"top": {key: value}} shrinks it for
    a test."""
    spec = load_spec(root)
    w = _entry(spec["workloads"], name, "workload")
    cfg = json.loads((root / _entry(spec["configs"], w["config"], "configuration")["file"]).read_text())
    mix = traffic.load(w["traffic"], root / "perfbench")
    limits = json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text())
    o = overrides or {}
    cfg = {**cfg, **o.get("top", {}), "model": {**cfg["model"], **o.get("model", {})},
           "train": {**cfg["train"], **o.get("train", {})}}
    mix = {**mix, **o.get("mix", {})}
    e2e = tuple(m["name"] for m in spec["end_to_end"] if _applies(m, name, spec))
    return Cell(name, cfg, mix, limits["limits"], seed, seconds, trace, device, t0, root, e2e=e2e)


def _load(path: Path, name: str):
    """The module in file ``path``, loaded under ``name``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _reader(name: str, root: Path):
    return _load(root / "perfbench" / "metrics" / f"{name}.py", f"perfbench_metric_{name.replace('.', '_')}").read


def _applies(metric: dict, workload: str, spec: dict) -> bool:
    """Whether ``metric`` is reported in ``workload``: listed there, or, with
    no list, wherever its cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moved = _entry(spec["end_to_end"], metric["moves"], "metric") if "moves" in metric else metric
    return "workloads" not in moved or workload in moved["workloads"]


def metrics(result: dict, workload: str, trace: bool, spec: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}}: the cell's end-to-end metrics (trace off)
    or its per-layer metrics (trace on), each reader that finds nothing to
    read leaving its metric out."""
    out = {}
    if not trace:
        for m in spec["end_to_end"]:
            if _applies(m, workload, spec) and m["name"] in result["e2e"]:
                out[m["name"]] = {"value": result["e2e"][m["name"]], "unit": m["unit"]}
        return out
    for m in spec["per_layer"]:
        if _applies(m, workload, spec):
            value = _reader(m["name"], root)(result["layer"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell) -> dict:
    """One run of the cell by the driver its mix's ``kind`` names,
    ``perfbench/<kind>_cell.py`` (a module of the package ``perfbench``)."""
    kind = cell.mix["kind"]
    return _load(cell.root / "perfbench" / f"{kind}_cell.py", f"perfbench.{kind}_cell").run(cell)


def result_line(cell: Cell, result: dict, spec: dict, device_info: dict, root: Path = ROOT) -> tuple[dict, list]:
    """(the JSON result, the lines of the check for standard error)."""
    from .reference import check

    numbers = result["numbers"]
    correct = check.passes(numbers, cell.limits) and result["failed"] == 0
    compared = {k: {"value": numbers.get(k), "limit": cell.limits[k]} for k in cell.limits}
    line = {
        "correct": bool(correct),
        "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": metrics(result, cell.name, cell.trace, spec, root),
        "device": device_info,
    }
    trace = result["layer"].get("trace")
    if cell.trace and trace:
        line["device"] = {**device_info, "busy_s": trace["busy_s"], "window_s": trace["span_s"]}
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    line["checked"] = compared
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in compared.items()]
    return line, lines


def main(argv: list[str], t0: float, root: Path = ROOT, device=None, overrides: dict | None = None) -> int:
    """A run as the command line asks. ``device`` (a test's CPU) skips the
    look for a card; ``overrides`` shrinks the cell as ``load_cell`` says."""
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    spec = load_spec(root)
    w = _entry(spec["workloads"], args.workload, "workload")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            print(f"perfbench: {args.workload} needs {w['chips']} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        # One process with one CPU thread for PyTorch's own host work: the
        # host-paced parts of a run then spread less with the host's load.
        torch.set_num_threads(1)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, t0, root, overrides)
    result = run_cell(cell)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    info = {"platform": "gpu", "kind": kind, "count": w["chips"],
            "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line, lines = result_line(cell, result, spec, info, root)
    # Last, once the readers and the reference have loaded too.
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark runs without JAX", file=sys.stderr)
        return 3
    print(f"setup parts (s since start, each at its end): {json.dumps(result['setup_parts'])}", file=sys.stderr)
    print(f"reference s: {result['reference_s']}", file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
