"""The port's on-card checks (``python -m vcr_tpu_torch.checks``) on the CPU:
the dry run passes every row, a planted mismatch in the port fails its row
and the run, and without a card the script exits 2."""

import torch

from vcr_tpu_torch import checks
from vcr_tpu_torch.ops import cuda_gru


def test_dry_run_passes_every_row(capsys):
    assert checks.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [ln for ln in lines if ln.startswith(("PASS", "FAIL"))]
    assert len(rows) == len(checks.Checks(torch.device("cpu"), checks.DRY).rows()) == 23
    assert all(ln.startswith("PASS") for ln in rows) and lines[-1] == "ALL PASS"


def test_a_planted_mismatch_fails(monkeypatch, capsys):
    """B1's wrapper off by 1e-2: the GRU rows fail, and so does the run."""
    fused = cuda_gru.gru_sequence_fused

    def off(*args, **kw):
        outs, last = fused(*args, **kw)
        return outs + 1e-2, last + 1e-2

    monkeypatch.setattr(cuda_gru, "gru_sequence_fused", off)
    rows = checks.Checks.rows
    monkeypatch.setattr(checks.Checks, "rows", lambda self: rows(self)[:2])
    assert checks.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("FAIL  gru fwd") and out[-1] == "FAILURES"


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert checks.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
