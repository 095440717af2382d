"""On the card: a short run of each cell through run.py prints one result
line with the contract's keys. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_spec()["workloads"]])
def test_run_prints_a_result_line(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed", str(2**31 + 99),
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, timeout=1200,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checked"
    spec = harness.load_spec()
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"] if harness._applies(m, name, spec)}
