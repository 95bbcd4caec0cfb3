"""Registers, spills and stack of every CUDA kernel of the port, as ptxas
reports them.

    python scripts/ptxas_report.py [--sass-dir DIR] [extra.cu ...]

Compiles each ``vcr_tpu_torch/ops/csrc/*.cu`` (and any extra source given,
e.g. an older copy of one, to compare) with the flags of ``ops/_build.py``
plus ``-Xptxas -v`` (and ``csrc/`` on the include path, for a copy kept
elsewhere), all at once, into a temporary directory, and prints one
JSON line per kernel entry: registers, stack and spills, and a hash of its
machine code (``cuobjdump -sass``), so that two builds of one kernel can be
shown to be the same code. The hash covers the instructions and their
encodings, not the listing's column widths, so it is not comparable with
hashes of the text as printed. ``--sass-dir`` also writes each kernel's
machine code to a file there, for reading. Needs the CUDA toolkit (the GPU
machine).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

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


def _sass(lib: Path) -> dict:
    """Each kernel's SASS lines, by mangled name, with runs of blanks
    collapsed: cuobjdump pads its columns to the longest instruction of the
    whole file, so other kernels in a source would otherwise change the
    text, and the hash, of one whose machine code is the same."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    bodies, name = {}, None
    for line in text.splitlines():
        if (m := FUNCTION.match(line)):
            name = m.group(1)
            bodies[name] = []
        elif name:
            bodies[name].append(" ".join(line.split()))
    return bodies


def report(source: Path, out_dir: str, sass_dir: Optional[Path] = None) -> list:
    lib = Path(out_dir) / f"{source.stem}-{abs(hash(str(source)))}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-Xptxas", "-v",
         "-o", str(lib), str(source)],
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
    bodies = _sass(lib)
    for row, name in zip(rows, names):
        mangled = row.pop("mangled")
        row["kernel"] = name
        body = bodies.get(mangled, [])
        row["sass_sha256"] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
        if sass_dir is not None:
            path = sass_dir / f"{lib.stem}.{mangled}.sass"
            path.write_text(f"// {name}\n" + "\n".join(body) + "\n")
            row["sass_file"] = str(path)
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("extra", nargs="*", type=Path,
                    help="more sources to compile, e.g. an older copy of one")
    ap.add_argument("--sass-dir", type=Path, default=None,
                    help="also write each kernel's SASS to a file in this directory")
    args = ap.parse_args(argv)
    if args.sass_dir is not None:
        args.sass_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(_build.CSRC.glob("*.cu")) + args.extra
    with tempfile.TemporaryDirectory() as out_dir, \
            concurrent.futures.ThreadPoolExecutor() as pool:
        for rows in pool.map(lambda s: report(s, out_dir, args.sass_dir), sources):
            for row in rows:
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
