"""The remat A/B with trace attribution, in one process.

The port of tools/round4_task5.py: (1) ``ab_profiles`` of
fast_handrolled against the two ``remat_frontend`` policies
(fast_hr_rematdots, fast_hr_rematfull); (2) ``trace_step.run_profile`` of
fast_handrolled and fast_hr_rematdots: a profiled epoch with each device's
busy and idle time, one JSON line each (traces under
``<log_root>/torch_trace_*``).

    python -m ai_font_renderer_tpu_torch.tools.round4_task5 [--kernels K] [--device cpu]
"""

from __future__ import annotations

import json
import sys

from ..device import resolve_device
from . import _common, ab_profiles, trace_step

AB = ("fast_handrolled", "fast_hr_rematdots", "fast_hr_rematfull")
TRACED = ("fast_handrolled", "fast_hr_rematdots")


def main(argv: list[str] | None = None, widths: dict | None = None, batch: int | None = None, rounds: int = 5,
         steps: int = trace_step.STEPS, long_steps: int = trace_step.LONG_STEPS,
         log_root: str = "extended_runs") -> dict:
    """Cuts: ``rounds`` (ab_profiles), ``steps`` (the steps of an epoch in
    both), ``long_steps`` (trace_step), ``widths``/``batch`` for CPU
    tests."""
    argv = sys.argv[1:] if argv is None else argv
    _, dev, kernels = _common.split_flags(argv)
    port_flags = ["--kernels", kernels] + (["--device", dev] if dev else [])
    ab = ab_profiles.main(list(AB) + port_flags, widths=widths, batch=batch, steps=steps, rounds=rounds)
    traces = []
    for nm in TRACED:
        row = trace_step.run_profile(nm, kernels, resolve_device(dev), widths, batch, steps, long_steps,
                                     log_root)
        print(json.dumps(row), flush=True)
        traces.append(row)
    return {"ab_profiles_ms_per_step": ab, "traces": traces}


if __name__ == "__main__":
    main()
