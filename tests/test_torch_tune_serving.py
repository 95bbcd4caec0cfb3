"""The port's pool autotuner (``python -m vcr_tpu_torch.tune_serving``) on the
CPU, as ``tests/test_tune_serving.py`` holds the JAX script: a tiny grid end
to end, every request served once, sane metrics, one best per rate; and the
workload of a seed (features and arrivals) equal to the JAX script's."""

import importlib.util
import json
import os

import numpy as np

from vcr_tpu_torch import tune_serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tuner_grid_end_to_end(capsys):
    assert tune_serving.main(["--synthetic", "--device", "cpu", "--slots", "2,4",
                              "--admit_chunk", "2", "--step_chunk", "2",
                              "--rate", "0,50", "--n_requests", "12"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    rows = [ln for ln in lines if "slots" in ln]
    assert len(rows) == 4      # 2 geometries x 2 rates
    for r in rows:
        assert r["served"] == 12
        assert r["throughput_caps_s"] > 0
        assert 0 < r["occupancy"] <= 1
        assert r["latency_p50_ms"] <= r["latency_p95_ms"]
        assert r["rate"] in (0.0, 50.0)
        assert r["admit_chunks"] >= 12 // 2
        # the CPU runs the plain versions: no kernel launches
        assert r["launches"] == {"gru_seq": 0, "gru_seq_tc": 0, "gru_seq_bt": 0,
                                 "gru_seq_dma": 0, "lstm_seq": 0, "lstm_seq_tc": 0,
                                 "beam_pick": 0}
    best = [ln for ln in lines if "best" in ln]
    assert len(best) == 2
    for b in best:
        assert b["best"] in rows and b["best"]["rate"] == b["rate"]


def test_workload_equals_the_jax_script(monkeypatch, capsys):
    """Run the JAX script's main with its pool stubbed, and record the
    features and arrival times it hands each run."""
    spec_ = importlib.util.spec_from_file_location(
        "jax_tune_serving", os.path.join(REPO, "scripts", "tune_serving.py"))
    jmod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(jmod)
    seen = {}

    class Pool:
        stats = {"ticks": 0}

        def caption_stream(self, requests):
            return iter(())

    def record(cc, feats, arrivals):
        seen.setdefault("feats", feats)
        seen.setdefault("arrivals", []).append(arrivals)
        return {"served": 0}

    monkeypatch.setattr(jmod, "build_pool", lambda *a: Pool())
    monkeypatch.setattr(jmod, "run_config", record)
    assert jmod.main(["--synthetic", "--platform", "cpu", "--slots", "2",
                      "--admit_chunk", "1", "--step_chunk", "2", "--rate", "0,50,7.5",
                      "--n_requests", "9", "--seed", "5"]) == 0
    capsys.readouterr()
    _, spec, _ = tune_serving.synthetic_model(5, "cpu")
    feats, arrivals = tune_serving.make_workload(spec, 9, [0.0, 50.0, 7.5], 5)
    np.testing.assert_array_equal(feats, seen["feats"])
    for rate, want in zip((0.0, 50.0, 7.5), seen["arrivals"]):
        np.testing.assert_array_equal(arrivals[rate], want)
