"""Hyperparameter grid sweeps.

Counterpart of ``vcr_tpu/sweep.py``. A grid is a dict whose list-valued
entries are its axes, like the reference's placeholder dict
(scripts/schedule_jobs.py:8-43). Each grid point becomes one training run:
emitted as a ``python -m vcr_tpu_torch.cli`` command for any scheduler, or
run in this process, one after another.

    python -m vcr_tpu_torch.sweep [grid.json] [--emit] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import os
import shlex
from typing import Dict, Iterator, List, Optional

from vcr_tpu_torch.config import Config

DEFAULT_GRID: Dict = {
    # the reference's example grid (scripts/schedule_jobs.py:16-42)
    "mode": "train",
    "corpus": "msvd",
    "arch": "s2vt",
    "num_frames": 30,
    "bsize": 32,
    "lr": [1e-4, 3e-4],
    "wd": 5e-4,
    "dropout_p": 0.3,
    "hidden_size": 512,
    "epochs": 1000,
    "max_norm": 1.0,
    "seed": 123,
}


def expand_grid(grid: Dict) -> Iterator[Dict]:
    """Every point of the grid: the fixed entries with one value of each
    axis, the axes varied in the order of their keys."""
    axes = {k: v for k, v in grid.items() if isinstance(v, list)}
    fixed = {k: v for k, v in grid.items() if not isinstance(v, list)}
    if not axes:
        yield dict(fixed)
        return
    keys = list(axes)
    for combo in itertools.product(*(axes[k] for k in keys)):
        point = dict(fixed)
        point.update(zip(keys, combo))
        yield point


def job_name(point: Dict, axis_keys=None) -> str:
    """Directory name of one grid point: its varying axes (all of them)
    and a short hash of the whole point."""
    digest = hashlib.sha1(
        json.dumps(point, sort_keys=True, default=str).encode()).hexdigest()[:8]
    if axis_keys:
        head = "_".join(f"{k}-{point[k]}" for k in sorted(axis_keys))
    else:
        head = "_".join(f"{k}-{point[k]}" for k in sorted(point)
                        if k not in ("mode", "data_dir", "save_path", "log_dir"))
    return (head[:100] + "_" + digest) if head else digest


def _points(grid: Dict, base_save: str):
    """(name, point with its save_path and log_dir) for every grid point."""
    axes = [k for k, v in grid.items() if isinstance(v, list)]
    for point in expand_grid(grid):
        name = job_name(point, axes)
        point = dict(point)
        point.setdefault("save_path", os.path.join(base_save, name, "models"))
        point.setdefault("log_dir", os.path.join(base_save, name, "logs"))
        yield name, point


def emit_commands(grid: Dict, base_save: str = "./sweeps",
                  device: Optional[str] = None) -> List[str]:
    """One shell command per grid point; ``device`` adds ``--device``."""
    cmds = []
    for _, point in _points(grid, base_save):
        args = " ".join(f"--{k} {shlex.quote(str(v))}" for k, v in point.items())
        if device is not None:
            args += f" --device {shlex.quote(device)}"
        cmds.append(f"python -m vcr_tpu_torch.cli {args}")
    return cmds


def run_sweep(grid: Dict, base_save: str = "./sweeps", device=None) -> None:
    """Train every grid point in this process, one after another, on
    ``device`` (None: the card), and write each point's last validation
    metrics to ``<base_save>/<name>/result.json``."""
    from vcr_tpu_torch.train.loop import train

    known = {f.name for f in dataclasses.fields(Config)}
    unknown = sorted(set(grid) - known)
    if unknown:
        # Config.from_dict drops unknown keys, which would turn a misspelt
        # axis into identical runs whose names claim that it varied
        raise ValueError(f"unknown Config field(s) in sweep grid: {unknown}")
    for name, point in _points(grid, base_save):
        cfg = Config.from_dict(point).validate()
        print(f"=== sweep point: {name} ===")
        metrics = train(cfg, device=device)
        os.makedirs(os.path.join(base_save, name), exist_ok=True)
        with open(os.path.join(base_save, name, "result.json"), "w") as f:
            json.dump(metrics, f, indent=2)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Grid sweep of vcr_tpu_torch training runs")
    p.add_argument("grid", nargs="?", help="a JSON grid (default: DEFAULT_GRID)")
    p.add_argument("--emit", action="store_true",
                   help="print one command per point instead of running them")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the runs train (default: the card)")
    args = p.parse_args(argv)
    grid = DEFAULT_GRID
    if args.grid:
        with open(args.grid) as f:
            grid = json.load(f)
    if args.emit:
        print("\n".join(emit_commands(grid, device=args.device)))
    else:
        run_sweep(grid, device=args.device)


if __name__ == "__main__":
    main()
