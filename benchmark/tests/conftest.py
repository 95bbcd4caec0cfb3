"""Tests of the benchmark's harness, on the CPU at small widths; those that
need the card are marked ``cuda`` and skip without one."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# widths at which a CPU run of every cell takes a second or two, and the
# decode still depends on its input
SMALL = dict(vocab_size=500, embed_size=16, hidden_size=64, vid_feat_size=128,
             num_frames=5, max_len=6, sos_id=496, eos_id=497, pad_id=498)


def with_pending(bench: dict) -> dict:
    """``bench`` with the entries of ``pending.json`` merged in: the cells
    whose files the folder holds but which BENCHMARK.json does not list yet
    (the host paces them, and their runs spread beyond any bound), with
    their configuration and metrics, as the PR that lists them would add
    them. A pending metric of a name the benchmark has adds its cells to
    that metric's."""
    bench = copy.deepcopy(bench)
    pending = json.loads((Path(__file__).parent / "pending.json").read_text())
    for key in ("configs", "workloads"):
        bench[key] += pending[key]
    for key in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in bench[key]}
        for m in pending[key]:
            if m["name"] in have:
                have[m["name"]]["workloads"] += m["workloads"]
            else:
                bench[key].append(m)
    return bench


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_copy(dest: Path, batch: int = 16, check: int = 32) -> dict:
    """A copy of the benchmark's folder under ``dest`` with every
    configuration at the small widths and every mix at ``batch`` videos ->
    BENCHMARK.json's dict with the pending cells (``with_pending``)."""
    shutil.copytree(ROOT / "benchmark", dest, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (dest / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(SMALL)
        f.write_text(json.dumps(c))
    for f in (dest / "traffic").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(batch=batch, profiled_requests=2)
        if "caption_words" in c:
            c["caption_words"] = {"1": 1, "2": 2, "3": 2, "4": 1}
        f.write_text(json.dumps(c))
    for f in (dest / "workloads").glob("*.json"):
        c = json.loads(f.read_text())
        if "check_captions" in c:
            c["check_captions"] = check
        f.write_text(json.dumps(c))
    return with_pending(json.loads((ROOT / "BENCHMARK.json").read_text()))


@pytest.fixture
def small(tmp_path):
    """(the copy's folder, BENCHMARK.json's dict with the pending cells)."""
    base = tmp_path / "benchmark"
    return base, small_copy(base)
