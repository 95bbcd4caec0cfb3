"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere, and nothing of the program in the plain references. Module names
are compared by their whole top-level name, so ``vcr_tpu_torch`` (the
program) is not taken for ``vcr_tpu`` (the JAX package)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "vcr_tpu"}


def imported_tops(path: Path):
    """Top-level names of every module ``path`` imports, at any depth of
    its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): sorted(imported_tops(p) & FORBIDDEN)
             for p in sources(BENCH)}
    assert not {k: v for k, v in found.items() if v}


def test_the_references_import_nothing_of_the_program():
    found = {str(p.relative_to(ROOT)): sorted(imported_tops(p) & {"vcr_tpu_torch", *FORBIDDEN})
             for p in sources(BENCH / "reference")}
    assert not {k: v for k, v in found.items() if v}


def test_the_run_compares_whole_top_level_names(monkeypatch):
    import types

    from benchmark import core

    monkeypatch.setitem(sys.modules, "vcr_tpu_torch_probe", types.ModuleType("x"))
    assert "vcr_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vcr_tpu.probe", types.ModuleType("x"))
    assert "vcr_tpu" in core.forbidden_modules()


def test_a_run_loads_no_forbidden_module(small):
    """A whole run on the CPU, then the run's own look at sys.modules, in a
    fresh interpreter."""
    base, _ = small
    code = (
        "import sys, torch, json; sys.path.insert(0, %r)\n"
        "from benchmark import core\n"
        "bench = json.load(open(%r))\n"
        "ctx = core.build_context('s2vt.beam5.b512', 5, 0.2, False, torch.device('cpu'),"
        " bench=bench, base=__import__('pathlib').Path(%r))\n"
        "core.run(ctx, 0.0, lambda s: None)\n"
        "import vcr_tpu_torch\n"
        "print(core.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "BENCHMARK.json"), str(base))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    """No card here: exit 2 and no result. A checkout of BENCHMARK.json and
    the benchmark's folder alone: no program, exit 2 and no result."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", "s2vt.beam5.b512",
           "--seed", "3000000019", "--seconds", "1", "--trace", "0"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""
    (tmp_path / "benchmark").mkdir()
    for p in sources(BENCH) + sorted(BENCH.rglob("*.json")):
        dest = tmp_path / p.relative_to(ROOT)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""
