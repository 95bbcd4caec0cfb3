"""On the card, at each cell's own size (``python -m pytest benchmark/tests -m
cuda`` on a machine with one): the control, the reference in fp8 put in the
program's place, fails the cell's check on three seeds; the program passes
it; a whole run prints the result line the contract asks for."""

import json
import subprocess
import sys

import pytest

from benchmark import calibrate, core
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def failed(cell, seed, variant, device):
    """The names of the check's numbers that exceed their limits."""
    limits = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    got, _ = calibrate.readings(cell, seed, variant, device)
    return [k for k, v in got.items() if v > limits["limits"][k]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell, card):
    for seed in (4000000001, 4000000002, 4000000003):
        assert failed(cell, seed, "control", card)
    assert not failed(cell, 4000000004, "program", card)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_its_result(cell, trace, card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "4000000005", "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and result["correct"]
    assert set(result["metrics"]) == {m["name"] for m in core.cell_metrics(BENCH, cell,
                                                                          bool(trace))}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 100, name
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
