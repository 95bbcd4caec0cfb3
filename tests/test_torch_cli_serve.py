"""``--mode serve`` of the port on a tiny checkpoint on the CPU: the command
line's dispatch and flags (port 0, the pool's size from --serve_*), the
caption a client gets against --mode decode's greedy caption of the same
checkpoint, --serve_models, ``python -m vcr_tpu_torch.cli --mode serve`` as a
process that stops on SIGTERM, int8 decode weights, and the refusals: a
frozen continuous artifact the JAX package made (this package serves its
own since A16), a quantized KV cache on a family that has no attention
cache, --mesh_dp without a process group, and --mesh_mp, which the JAX
package's daemon ignores."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from vcr_tpu_torch import cli
from vcr_tpu_torch import tools as ttools
from vcr_tpu_torch.client import CaptionClient
from vcr_tpu_torch.config import get_config
from vcr_tpu_torch.decode import decode_tokens

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import build_corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60


def _argv(tmp, **kw):
    d = dict(mode="train", data_dir=os.path.join(tmp, "data"), corpus="msvd_vgg",
             nworkers=1, bsize=4, glove_emb_file="glove_tiny.txt", num_frames=4,
             vid_feat_size=12, arch="s2vt", max_len=6, dropout_p=0.0, hidden_size=8,
             epochs=1, lr=1e-2, save_path=os.path.join(tmp, "models"), log_dir="",
             seed=123, compute_dtype="float32")
    d.update(kw)
    return [x for k, v in d.items() for x in (f"--{k}", str(v))] + ["--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("serve"))
    build_corpus(os.path.join(tmp, "data"))
    cli.main(_argv(tmp))
    return tmp


def _serve(monkeypatch, argv):
    """cli.main on ``argv`` with serve_captions returning the started server."""
    serve = ttools.serve_captions
    monkeypatch.setattr(ttools, "serve_captions",
                        lambda *a, **k: serve(*a, **dict(k, block=False)))
    return cli.main(argv)


def test_serve_mode_answers_with_decode_captions(trained, monkeypatch):
    feats = np.random.default_rng(0).standard_normal((3, 4, 12)).astype(np.float32)
    cfg, _ = get_config(_argv(trained, mode="decode"))
    _, params, spec, vocab = ttools.load_inference_state(cfg, device="cpu")
    want = ttools.decode_features(params, spec, vocab.eos_id, feats, 3, device="cpu")

    server = _serve(monkeypatch, _argv(trained, mode="serve", serve_port=0, serve_slots=2,
                                       serve_admit_chunk=1))
    try:
        assert server.port != 8000 and server.captioner.slots == 2
        assert server.captioner.admit_chunk == 1 and server.captioner.device.type == "cpu"
        client = CaptionClient(f"http://127.0.0.1:{server.port}", timeout_s=TIMEOUT,
                               retries=0)
        for f, row in zip(feats, want):
            tokens, caption = client.caption(f)
            cut = list(row[: list(row).index(vocab.eos_id) + 1]) if vocab.eos_id in row \
                else list(row)
            assert tokens == cut and caption == vocab.get_sent_from_index(tokens)
        health = client.health()
        assert health["status"] == "ok" and health["served"] == 3
    finally:
        server.close()

    save = os.path.join(trained, "models")
    server = _serve(monkeypatch, _argv(trained, mode="serve", serve_port=0, serve_slots=2,
                                       serve_admit_chunk=1,
                                       serve_models=f"one={save},two={save}"))
    try:
        outs = [CaptionClient(f"http://127.0.0.1:{server.port}", model=m,
                              timeout_s=TIMEOUT, retries=0).caption(feats[0])
                for m in ("one", "two")]
        assert outs[0] == outs[1]
        assert sorted(CaptionClient(f"http://127.0.0.1:{server.port}").models()) == [
            "one", "two"]
    finally:
        server.close()


def test_serve_mode_as_a_process(trained):
    """The real entry point: it prints its address, answers, and stops on
    SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "vcr_tpu_torch.cli"] + _argv(
            trained, mode="serve", serve_port=0, serve_slots=2, serve_admit_chunk=1),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("serving"):
                break
        url = line.split(" on ")[1].split()[0]
        tokens, caption = CaptionClient(url, timeout_s=TIMEOUT, retries=0).caption(
            np.zeros((4, 12), np.float32))
        assert 1 <= len(tokens) <= 6 and isinstance(caption, str)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(TIMEOUT) == 0
    finally:
        proc.kill()
        proc.wait(TIMEOUT)
        proc.stdout.close()


def test_serve_refusals(trained, tmp_path):
    art = tmp_path / "continuous_artifact"
    art.mkdir()
    # a JAX-made frozen pool: its meta names no torch runtime (A16 serves
    # this package's own, tests/test_torch_export_continuous.py)
    (art / "meta.json").write_text(json.dumps({"kind": "continuous"}))
    cfg, _ = get_config(_argv(trained, mode="serve", serve_port=0))
    with pytest.raises(ValueError, match="JAX package"):
        ttools.serve_captions(cfg, str(art), block=False, device="cpu")
    # the sharded pool is ported (tests/test_torch_mesh_cli.py); one process
    # cannot hold a mesh of two
    with pytest.raises(RuntimeError, match="init_process_group"):
        ttools.serve_captions(cfg.replace(mesh_dp=2), block=False, device="cpu")
    # the quantized modes are ported (A13): S2VT has no attention cache to
    # quantize (ValueError), and its int8 decode weights serve: the client
    # gets the int8-weight beam 1's caption
    for flags in ({"serve_kv_cache": "int8"}, {"serve_kv_cache": "int4"}):
        cfg_q, _ = get_config(_argv(trained, mode="serve", serve_port=0, **flags))
        with pytest.raises(ValueError, match="has none"):
            ttools.serve_captions(cfg_q, block=False, device="cpu")
    cfg_q, _ = get_config(_argv(trained, mode="serve", serve_port=0, serve_slots=2,
                                serve_admit_chunk=1, serve_decode_weights="int8"))
    feats = np.random.default_rng(1).standard_normal((4, 12)).astype(np.float32)
    _, params, spec, vocab = ttools.load_inference_state(cfg_q, device="cpu")
    row = decode_tokens(params, spec, torch.from_numpy(feats[None]), vocab.eos_id, 1,
                        decode_weights="int8")[0][0, 0].tolist()
    server = ttools.serve_captions(cfg_q, block=False, device="cpu")
    try:
        assert server.captioner.decode_weights == "int8"
        tokens, _ = CaptionClient(f"http://127.0.0.1:{server.port}", timeout_s=TIMEOUT,
                                  retries=0).caption(feats)
        assert tokens == (row[: row.index(vocab.eos_id) + 1] if vocab.eos_id in row
                          else row)
    finally:
        server.close()
    with pytest.raises(NotImplementedError, match="ignores"):
        get_config(_argv(trained, mode="serve", mesh_mp=2))
    save = os.path.join(trained, "models")
    with pytest.raises(ValueError, match="duplicate model name"):
        ttools.serve_captions(cfg.replace(serve_models=f"a={save},a={save}"),
                              block=False, device="cpu")
