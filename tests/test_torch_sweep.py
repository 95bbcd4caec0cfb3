"""The port's sweep launcher (``vcr_tpu_torch.sweep``) against the JAX
package's: the same grid points, the same job names, commands that differ
only in the module they run; and a two-point grid trained in process on the
CPU."""

import json
import os
import sys

import pytest

from vcr_tpu import sweep as jsweep
from vcr_tpu_torch import sweep as tsweep

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import build_corpus  # noqa: E402

GRIDS = [jsweep.DEFAULT_GRID,
         {"corpus": "msvd", "lr": [1e-4, 3e-4], "seed": [1, 2], "arch": "s2vt"},
         {"mode": "train", "hidden_size": 8}]


@pytest.mark.parametrize("grid", GRIDS)
def test_points_names_and_commands_equal_jax(grid):
    assert tsweep.DEFAULT_GRID == jsweep.DEFAULT_GRID
    points = list(tsweep.expand_grid(grid))
    assert points == list(jsweep.expand_grid(grid))
    axes = [k for k, v in grid.items() if isinstance(v, list)]
    for point in points:
        assert tsweep.job_name(point, axes) == jsweep.job_name(point, axes)
        assert tsweep.job_name(point) == jsweep.job_name(point)
    got, want = tsweep.emit_commands(grid, "/s"), jsweep.emit_commands(grid, "/s")
    assert [c.replace("vcr_tpu_torch.cli", "vcr_tpu.cli", 1) for c in got] == want
    on_cpu = tsweep.emit_commands(grid, "/s", device="cpu")
    assert on_cpu == [c + " --device cpu" for c in got]


def test_run_sweep_trains_each_point(tmp_path, capsys):
    tmp = str(tmp_path)
    build_corpus(os.path.join(tmp, "data"))
    grid = {"mode": "train", "corpus": "msvd_vgg", "data_dir": os.path.join(tmp, "data"),
            "glove_emb_file": "glove_tiny.txt", "arch": "s2vt", "num_frames": 4,
            "vid_feat_size": 12, "max_len": 6, "hidden_size": 8, "bsize": 4,
            "epochs": 1, "log_iter": 2, "log_dir": "", "nworkers": 0,
            "compute_dtype": "float32", "lr": [1e-2, 1e-3]}
    base = os.path.join(tmp, "sweeps")
    tsweep.run_sweep(grid, base, device="cpu")
    names = sorted(tsweep.job_name(p, ["lr"]) for p in tsweep.expand_grid(grid))
    assert sorted(os.listdir(base)) == names
    for name in names:
        with open(os.path.join(base, name, "result.json")) as f:
            assert "METEOR" in json.load(f)
        assert os.path.exists(os.path.join(base, name, "models", "model_best"))
    assert capsys.readouterr().out.count("=== sweep point:") == 2
    with pytest.raises(ValueError, match="weight_decay"):
        tsweep.run_sweep({**grid, "weight_decay": [0.1]}, base, device="cpu")
