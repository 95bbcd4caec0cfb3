"""Registers, spills and stack of every CUDA kernel of the port, as ptxas
reports them.

    python scripts/ptxas_report.py [extra.cu ...]

Compiles each ``vcr_tpu_torch/ops/csrc/*.cu`` (and any extra source given,
e.g. an older copy of one, to compare) with the flags of ``ops/_build.py``
plus ``-Xptxas -v``, all at once, into a temporary directory, and prints one
JSON line per kernel entry: registers, stack and spills, and a hash of its
machine code (``cuobjdump -sass``), so that two builds of one kernel can be
shown to be the same code. Needs the CUDA toolkit (the GPU machine).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vcr_tpu_torch.ops import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '([^']+)' for '([^']+)'")
USED = re.compile(r"Used (\d+) registers")
FUNCTION = re.compile(r"\s*Function : (\S+)")
SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return shutil.which(name) or str(Path(CUDA_HOME or "/usr/local/cuda") / "bin" / name)


def _sass_hashes(lib: Path) -> dict:
    """sha256 of each kernel's SASS, by mangled name: equal hashes mean
    the same machine code."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    bodies, name = {}, None
    for line in text.splitlines():
        if (m := FUNCTION.match(line)):
            name = m.group(1)
            bodies[name] = []
        elif name:
            bodies[name].append(line.strip())
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16]
            for k, v in bodies.items()}


def report(source: Path, out_dir: str) -> list:
    lib = Path(out_dir) / f"{source.stem}-{abs(hash(str(source)))}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    rows, entry = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if (m := ENTRY.search(line)):
            entry = {"source": str(source), "mangled": m.group(1), "arch": m.group(2)}
        elif entry and (m := USED.search(line)):
            entry["registers"] = int(m.group(1))
        elif entry and (m := SPILL.search(line)):
            entry.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        if entry and "registers" in entry and "spill_stores" in entry:
            rows.append(entry)
            entry = None
    names = [r["mangled"] for r in rows]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    hashes = _sass_hashes(lib)
    for row, name in zip(rows, names):
        row["kernel"] = name
        row["sass_sha256"] = hashes.get(row.pop("mangled"))
    return rows


def main(argv) -> int:
    sources = sorted(_build.CSRC.glob("*.cu")) + [Path(a) for a in argv]
    with tempfile.TemporaryDirectory() as out_dir, \
            concurrent.futures.ThreadPoolExecutor() as pool:
        for rows in pool.map(lambda s: report(s, out_dir), sources):
            for row in rows:
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
