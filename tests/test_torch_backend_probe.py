"""The port's card probe (``vcr_tpu_torch.utils.backend_probe``), as
``tests/test_backend_probe.py`` holds the JAX package's: retry then fail,
retry then succeed, skip, the failure JSON. The probe's subprocess is
stubbed here; on a machine with no card the real one fails and says so."""

import json
import subprocess

import pytest

from vcr_tpu_torch.utils import backend_probe


def test_retry_then_fail(monkeypatch):
    calls = []

    def fake_probe(timeout_s, env=None):
        calls.append(timeout_s)
        return False, "probe timed out after 1s (card hang)"

    monkeypatch.setattr(backend_probe, "probe_once", fake_probe)
    ok, diag = backend_probe.ensure_backend(attempts=3, wait_s=0, timeout_s=1,
                                            verbose=False)
    assert not ok and len(calls) == 3 and "card hang" in diag


def test_retry_then_succeed(monkeypatch):
    outcomes = iter([(False, "down"), (True, "PROBE_OK device=x count=1")])
    monkeypatch.setattr(backend_probe, "probe_once", lambda timeout_s, env=None:
                        next(outcomes))
    ok, diag = backend_probe.ensure_backend(attempts=3, wait_s=0, timeout_s=1,
                                            verbose=False)
    assert ok and "PROBE_OK" in diag


def test_skip_probes_nothing(monkeypatch):
    monkeypatch.setattr(backend_probe, "probe_once", pytest.fail)
    ok, diag = backend_probe.ensure_backend(skip=True)
    assert ok and "skipped" in diag


@pytest.mark.parametrize("outcome, ok, needle", [
    ("timeout", False, "timed out after 2s"),
    (subprocess.CompletedProcess([], 1, "", "RuntimeError: no CUDA\n"), False,
     "rc=1: RuntimeError: no CUDA"),
    (subprocess.CompletedProcess([], 0, "PROBE_OK device=card count=1 dt=0.1s\n", ""),
     True, "PROBE_OK device=card")])
def test_probe_once_reads_its_subprocess(monkeypatch, outcome, ok, needle):
    def fake_run(cmd, **kw):
        assert kw["timeout"] == 2 and "cuda" in cmd[-1]
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, 2)
        return outcome

    monkeypatch.setattr(subprocess, "run", fake_run)
    got_ok, diag = backend_probe.probe_once(timeout_s=2)
    assert got_ok == ok and needle in diag


def test_emit_failure_json(capsys):
    backend_probe.emit_failure_json("m", "u", "card lost")
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["metric"] == "m" and rec["value"] is None
    assert rec["unit"] == "u" and rec["vs_baseline"] is None
    assert "unavailable" in rec["error"] and "card lost" in rec["diagnostic"]
