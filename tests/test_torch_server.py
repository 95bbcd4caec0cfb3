"""The port's HTTP daemon, multi-model daemon and client against the JAX
package's, over one tiny S2VT on the CPU (real sockets on port 0): every
route answers with the same status, tokens and captions; the error codes
400/401/403/404/409/413/503/504; /profile writes a torch.profiler trace;
each client against both daemons."""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from vcr_tpu import client as jclient
from vcr_tpu import multiserver as jmulti
from vcr_tpu import server as jserver
from vcr_tpu import serving_continuous as jsc
from vcr_tpu.models import base as jbase
from vcr_tpu.vocab import Vocab as JVocab
from vcr_tpu_torch import bridge
from vcr_tpu_torch import client as tclient
from vcr_tpu_torch import multiserver as tmulti
from vcr_tpu_torch import server as tserver
from vcr_tpu_torch import serving_continuous as tsc
from vcr_tpu_torch.models import base as tbase
from vcr_tpu_torch.vocab import Vocab as TVocab

from test_torch_serving_continuous import _sample_noise_jax

WORDS = ["a", "man", "is", "playing", "guitar", "dog", "runs", "the", "woman",
         "cooking", "food", "cat", "jumps", "on", "table"]
FRAMES, FEAT = 4, 12
POOL = dict(slots=2, admit_chunk=1, step_chunk=2)
TIMEOUT = 30      # seconds a test's socket waits


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """One S2VT in both packages, float32, and both vocabs of one GloVe file."""
    path = tmp_path_factory.mktemp("glove") / "glove_tiny.txt"
    r = np.random.default_rng(0)
    path.write_text("".join(w + " " + " ".join(f"{v:.6f}" for v in r.standard_normal(16))
                            + "\n" for w in WORDS))
    jvocab, tvocab = JVocab(str(path)), TVocab(str(path))
    kw = dict(arch="s2vt", vocab_size=jvocab.vocab_size, embed_size=jvocab.embed_size,
              hidden_size=8, vid_feat_size=FEAT, max_len=7, num_frames=FRAMES,
              dropout_p=0.0, sos_id=jvocab.sos_id, compute_dtype="float32")
    jspec, tspec = jbase.ModelSpec(**kw), tbase.ModelSpec(**kw)
    jparams = jax.tree_util.tree_map(np.asarray, jbase.build_model("s2vt")[0](
        jax.random.PRNGKey(3), jspec, jvocab.vectors))
    feats = r.standard_normal((6, FRAMES, FEAT)).astype(np.float32)
    return {"jax": (jspec, jparams, jvocab), "torch": (tspec, bridge.from_jax_params(
        jparams, "cpu"), tvocab), "feats": feats}


def _pool(model, pkg, **kw):
    spec, params, vocab = model[pkg]
    kw = {**POOL, **kw}
    if pkg == "jax":
        return jsc.ContinuousCaptioner(params, spec, eos_id=vocab.eos_id,
                                       rng=jax.random.PRNGKey(0), **kw)
    if kw.get("request_sampling"):
        kw["sample_noise"] = _sample_noise_jax(spec, 0, kw["admit_chunk"])
    return tsc.ContinuousCaptioner(params, spec, eos_id=vocab.eos_id, rng=0, device="cpu",
                                   **kw)


def _daemon(model, pkg, pool_kw=None, **server_kw):
    module = jserver if pkg == "jax" else tserver
    return module.CaptionServer(_pool(model, pkg, **(pool_kw or {})),
                                vocab=model[pkg][2], **server_kw)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


def _call(port, path, data=None, headers=None):
    """-> (status, parsed body, headers); error statuses included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            code, body, hdrs = r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        code, body, hdrs = e.code, e.read().decode(), e.headers
    return code, (body if path == "/metrics" else json.loads(body)), hdrs


@pytest.fixture(scope="module")
def both(model):
    """The two daemons over request-sampling pools (opt-less requests are
    greedy), the port's under JAX's sampling noise."""
    with _daemon(model, "jax", {"request_sampling": True}) as js, \
            _daemon(model, "torch", {"request_sampling": True}) as ts:
        yield js, ts


def test_routes_answer_as_jax(model, both):
    """/caption (greedy and sampled, one at a time so both pools admit in
    one order), /caption_batch, /healthz, /metrics: the same answers."""
    feats = model["feats"]
    paths = ["/caption", "/caption?temperature=3.0&top_p=0.9", "/caption?top_k=1",
             "/caption?temperature=0"]
    for i, path in enumerate(paths * 2):
        want, got = (_call(s.port, path, _npy(feats[i % 6]))[:2] for s in both)
        assert got == want and want[0] == 200 and isinstance(want[1]["caption"], str)
    want, got = (_call(s.port, "/caption_batch", _npy(feats))[:2] for s in both)
    assert got == want and len(want[1]["results"]) == 6
    want, got = (_call(s.port, "/healthz")[:2] for s in both)
    assert got[0] == want[0] == 200 and sorted(got[1]) == sorted(want[1])
    for k in ("served", "admit_chunks", "cancelled", "rejected", "status", "error"):
        assert got[1][k] == want[1][k], k
    want, got = (_call(s.port, "/metrics")[1] for s in both)
    names = [sorted(line.split()[2] for line in text.splitlines()
                    if line.startswith("# TYPE")) for text in (want, got)]
    assert names[0] == names[1] and "vcr_up" in names[1]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_error_codes(model, pkg, tmp_path):
    """400 (bad body, wrong shape, bad query, opts to a greedy pool), 401,
    403, 404, 409, 413, 503 + Retry-After: the same in both packages. The
    port's /profile writes a Chrome trace."""
    feats = model["feats"]
    module = jserver if pkg == "jax" else tserver
    with _daemon(model, pkg, auth_token="tok", max_body_mb=0.001,
                 profile_dir=str(tmp_path)) as s:
        auth = {"Authorization": "Bearer tok"}
        codes = {
            "no token": _call(s.port, "/caption", _npy(feats[0]))[0],
            "wrong token": _call(s.port, "/caption", _npy(feats[0]),
                                 {"Authorization": "Bearer x"})[0],
            "bad npy": _call(s.port, "/caption", b"not npy", auth)[0],
            "bad shape": _call(s.port, "/caption", _npy(feats[0, :, :6]), auth)[0],
            "bad query": _call(s.port, "/caption?top_k=-1", _npy(feats[0]), auth)[0],
            "opts to greedy": _call(s.port, "/caption?temperature=2", _npy(feats[0]),
                                    auth)[0],
            "too large": _call(s.port, "/caption_batch", _npy(np.zeros((64, FRAMES, FEAT),
                                                                         np.float32)),
                               auth)[0],
            "unknown path": _call(s.port, "/nope", b"", auth)[0],
            "bad seconds": _call(s.port, "/profile?seconds=0", b"", auth)[0],
        }
        # one capture at a time: a second is refused while the first runs
        first = {}
        t = threading.Thread(target=lambda: first.update(
            zip(("code", "body"), _call(s.port, "/profile?seconds=1", b"", auth)[:2])))
        t.start()
        for _ in range(100):
            if s._profiling:
                break
            threading.Event().wait(0.01)
        codes["second capture"] = _call(s.port, "/profile?seconds=1", b"", auth)[0]
        assert _call(s.port, "/caption", _npy(feats[0]), auth)[0] == 200  # in the capture
        t.join(TIMEOUT)
        assert not t.is_alive() and first["code"] == 200
        assert first["body"]["trace_dir"].startswith(str(tmp_path))
        if pkg == "torch":   # the scheduler thread's operations are in the trace
            with open(os.path.join(first["body"]["trace_dir"], "trace.json")) as f:
                assert any(e.get("cat") == "cpu_op" for e in json.load(f)["traceEvents"])
        s.submit = lambda *a, **k: (_ for _ in ()).throw(module.ServerOverloaded("full"))
        code, body, hdrs = _call(s.port, "/caption", _npy(feats[0]), auth)
        codes["overloaded"] = code
        assert hdrs["Retry-After"] == "1" and "full" in body["error"]
        assert _call(s.port, "/healthz")[0] == 200 and s.error is None
    assert codes == {"no token": 401, "wrong token": 401, "bad npy": 400, "bad shape": 400,
                     "bad query": 400, "opts to greedy": 400, "too large": 413,
                     "unknown path": 404, "bad seconds": 400, "second capture": 409,
                     "overloaded": 503}
    with _daemon(model, pkg) as s:
        assert _call(s.port, "/profile", b"")[0] == 403


def test_scheduler_failure_releases_clients_with_504(model):
    """A scheduler thread that raises: the waiting client gets 504 at once,
    and /healthz 503 with the error recorded."""
    pool = _pool(model, "torch")

    def broken():
        raise RuntimeError("tick failed")

    pool.tick = broken
    with tserver.CaptionServer(pool, request_timeout_s=TIMEOUT) as s:
        code, body, _ = _call(s.port, "/caption", _npy(model["feats"][0]))
        assert code == 504 and body["error"] == "caption timed out"
        code, health, _ = _call(s.port, "/healthz")
        assert code == 503 and "tick failed" in health["error"]


def test_timed_out_request_is_cancelled_and_its_slot_reclaimed(model):
    feats = model["feats"][0]
    pool = _pool(model, "torch", step_chunk=1)
    with tserver.CaptionServer(pool) as s:
        assert s.submit(feats) is not None
        s.request_timeout_s = 0.0
        assert s.submit(feats) is None              # the client gives up at once
        s.request_timeout_s = TIMEOUT
        assert s.submit(feats) is not None
        for _ in range(600):
            with s._lock:
                if not s._cancelled and pool.in_flight == 0:
                    break
            threading.Event().wait(0.05)
        assert not s._cancelled and pool.in_flight == 0
        assert pool.stats["served"] + pool.stats["cancelled"] >= 3


def test_multiserver_routes_answer_as_jax(model):
    """/models, /caption/<name>, /caption_batch/<name>, /healthz and an
    unknown model, through both multi-model daemons."""
    feats = model["feats"]
    out = {}
    for pkg, module in (("jax", jmulti), ("torch", tmulti)):
        backends = {"greedy": (_pool(model, pkg), model[pkg][2]),
                    "beam": (_pool(model, pkg, beam_size=2), model[pkg][2])}
        with module.MultiCaptionServer(backends) as ms:
            calls = [("/models", None), ("/caption/greedy", _npy(feats[0])),
                     ("/caption/beam", _npy(feats[1])),
                     ("/caption_batch/greedy", _npy(feats[:3])),
                     ("/caption/nope", _npy(feats[0])), ("/caption", _npy(feats[0]))]
            out[pkg] = [_call(ms.port, path, data)[:2] for path, data in calls]
            code, health, _ = _call(ms.port, "/healthz")
            out[pkg].append((code, health["status"], sorted(health["models"]),
                             [health["models"][m]["served"] for m in ("greedy", "beam")]))
            out[pkg].append(sorted(line.split()[2] for line in _call(
                ms.port, "/metrics")[1].splitlines() if line.startswith("# TYPE")))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == (200, {"models": {
        "greedy": {"arch": "s2vt", "slots": 2, "beam_size": 1},
        "beam": {"arch": "s2vt", "slots": 2, "beam_size": 2}}})
    assert [c for c, _ in out["torch"][1:6]] == [200, 200, 200, 404, 404]
    with pytest.raises(ValueError, match="model name"):
        tmulti.MultiCaptionServer({"bad name": _pool(model, "torch")})


@pytest.mark.parametrize("client", [tclient, jclient], ids=["port_client", "jax_client"])
def test_clients_against_both_daemons(model, both, client):
    """caption, caption_batch, caption_many, health and metrics: the same
    answers from either daemon, through either package's client."""
    feats = model["feats"]
    res = []
    for s in both:
        c = client.CaptionClient(f"http://127.0.0.1:{s.port}", timeout_s=TIMEOUT,
                                 retries=0)
        res.append((c.caption(feats[0]), c.caption_batch(feats[:4]),
                    c.caption_many(list(feats[:3]), max_workers=3),
                    c.health()["status"], "vcr_up" in c.metrics()))
    assert res[1] == res[0]
    assert res[0][3] == "ok" and res[0][4]
    bad = client.CaptionClient(f"http://127.0.0.1:{both[1].port}", timeout_s=TIMEOUT,
                               retries=0)
    with pytest.raises(client.CaptionServerError) as e:
        bad.caption(feats[0, :, :6])
    assert e.value.code == 400
