"""Each cell run once, briefly, on the card, as a benchmark run does. Skips
where no CUDA card is visible; on a machine with one:
``python -m pytest portbench/tests -m card``."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 99),
                           "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
