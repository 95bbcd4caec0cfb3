"""Files are found by name: a configuration, a traffic mix, a cell and a
metric dropped into a copy of the folder run with no edit of any file that
was there."""

import json

import torch

from benchmark import core
from conftest import with_pending


def test_new_files_are_found_by_name(small):
    base, bench = small
    cfg = json.loads((base / "configs" / "s2vt-msvd-vgg16.json").read_text())
    cfg["hidden_size"] = 40
    (base / "configs" / "s2vt-wider.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "beam5.b512.json").read_text())
    mix["beam_size"] = 3
    (base / "traffic" / "beam3.small.json").write_text(json.dumps(mix))
    cell = json.loads((base / "workloads" / "s2vt.beam5.b512.json").read_text())
    (base / "workloads" / "s2vt-wider.beam3.json").write_text(json.dumps(cell))
    (base / "metrics" / "half_captions_per_s.py").write_text(
        "def read(ctx):\n"
        "    w = ctx.window\n"
        "    return w['requests'] * ctx.units_per_request / w['window_s'] / 2\n")
    (base / "metrics" / "silent.py").write_text("def read(ctx):\n    return None\n")
    bench["configs"].append({"name": "s2vt-wider", "source": "x", "reduced": [],
                             "file": "benchmark/configs/s2vt-wider.json", "why": "x"})
    bench["workloads"].append({"name": "s2vt-wider.beam3", "config": "s2vt-wider",
                               "traffic": "beam3.small", "chips": 1, "why": "x"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "captions_per_s":
            metric["workloads"].append("s2vt-wider.beam3")
    bench["end_to_end"].append({"name": "half_captions_per_s", "unit": "captions/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["s2vt-wider.beam3"]})
    bench["end_to_end"].append({"name": "silent", "unit": "s", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["s2vt-wider.beam3"]})
    ctx = core.build_context("s2vt-wider.beam3", 11, 0.3, False, torch.device("cpu"),
                             bench=bench, base=base)
    assert ctx.model["hidden_size"] == 40 and ctx.mix["beam_size"] == 3
    result = core.run(ctx, 0.0, lambda s: None)
    assert result["correct"]
    got = result["metrics"]
    assert {"half_captions_per_s", "captions_per_s", "setup_s"} <= set(got)
    assert "silent" not in got             # a reader that finds nothing is left out
    assert got["half_captions_per_s"]["value"] * 2 == got["captions_per_s"]["value"]
    assert list(result)[-1] == "checks"


def test_which_metrics_a_cell_reports():
    bench = with_pending(json.loads((core.ROOT / "BENCHMARK.json").read_text()))
    names = lambda cell, trace: {m["name"] for m in core.cell_metrics(bench, cell, trace)}
    for cell in ("s2vt.beam5.b512", "s2vt.greedy.b2048"):
        assert names(cell, False) == {"captions_per_s", "caption_p95_ms", "setup_s"}
    assert names("s2vt.train.b1024", False) == {"train_videos_per_s", "setup_s"}
    assert "lstm_seq_roofline_pct.serve" in names("rationale.greedy.b1024", True)
    assert "lstm_seq_roofline_pct.serve" not in names("s2vt.greedy.b2048", True)
    assert names("s2vt.train.b1024", True) == {"host_ms.train", "launches.train",
                                               "device_idle_pct.train", "mfu.train"}
    for cell in (w["name"] for w in bench["workloads"]):
        per_layer = core.cell_metrics(bench, cell, True)
        reported = names(cell, False)
        assert per_layer and all(m["moves"] in reported for m in per_layer)


def test_a_suffixed_metric_shares_its_quantity_s_reader(small):
    base, _ = small
    shared = core.metric_reader("host_ms.serve", base)
    assert shared.__file__ == str(base / "metrics" / "host_ms.py")
    (base / "metrics" / "host_ms.serve.py").write_text("def read(ctx):\n    return 1.0\n")
    own = core.metric_reader("host_ms.serve", base)
    assert own.__file__ == str(base / "metrics" / "host_ms.serve.py")
    assert core.metric_reader("host_ms.train", base).__file__ == shared.__file__


def test_every_named_file_exists():
    """Of the cells BENCHMARK.json lists and of the pending ones."""
    bench = with_pending(json.loads((core.ROOT / "BENCHMARK.json").read_text()))
    for w in bench["workloads"]:
        ctx = core.build_context(w["name"], 1, 1.0, False, torch.device("cpu"), bench=bench)
        assert ctx.driver_module.Driver
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)
    for c in bench["configs"]:
        assert (core.ROOT / c["file"]).is_file()
