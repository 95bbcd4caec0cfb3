"""Multi-process training of the port over torch.distributed (gloo, two
processes on the CPU), as ``tests/test_multiprocess.py`` holds the JAX
package's.

* dp=2 and mp=2 each against a one-process run with the same global batch,
  float32 at p=0: the loss of every step within 1e-5, the parameters after
  2 epochs within 1e-5 of max(1, max|p|) per leaf, the validation metrics
  the same on both ranks and equal to the one-process run's, and rank 0's
  checkpoints whole.
* A SIGTERM to one rank stops both at one step, with a checkpoint.
* The pieces alone, in two processes: the split and its gather, the clip
  where the split leaves set the factor, the vocab-parallel NLL and its
  gradient, the argmax on ties across ranks, the row-split embedding, the
  dp gathers and the preemption vote.

Equality argument: the shuffled order is one seeded permutation; dp index p
takes order[p::2], so the union of the two shards' batch k is the
one-process batch k (twice the rows) as a set, and the masked loss and its
gradient (averaged over dp weighted by valid rows) do not depend on the
order of rows. One caption per video makes the caption choice fixed.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vcr_tpu_torch.config import Config
from vcr_tpu_torch.parallel import mesh as pmesh
from vcr_tpu_torch.train import checkpoint as tckpt
from vcr_tpu_torch.train import loop as tloop
from vcr_tpu_torch.utils.logging import TrainLogger

sys.path.insert(0, os.path.dirname(__file__))
from util_corpus import build_corpus  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5     # float32 losses, sums over the split rows in another order
PARAM_TOL = 1e-5    # per leaf, relative to max(1, max|p|), after 2 epochs (4 steps)

PRELUDE = """
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2,
                        rank=rank)
"""

TRAIN_WORKER = PRELUDE + """
from vcr_tpu_torch.config import Config
from vcr_tpu_torch.train import loop
from vcr_tpu_torch.utils.logging import TrainLogger
losses, update = [], TrainLogger.update
def record(self, m):
    losses.append(float(m["loss"]))
    update(self, m)
TrainLogger.update = record
metrics = loop.train(Config(**json.loads(sys.argv[4])), device="cpu")
with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
    json.dump({{"losses": losses, "metrics": metrics}}, f)
dist.destroy_process_group()
"""


def _run_pair(tmp, script, *args, timeout=300):
    path = os.path.join(tmp, "worker.py")
    with open(path, "w") as f:
        f.write(script.format(repo=REPO))
    port = str(pmesh_free_port())
    procs = [subprocess.Popen([sys.executable, path, str(r), port, tmp, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def pmesh_free_port():
    from vcr_tpu_torch.parallel.launch import free_port

    return free_port()


def _config(tmp, save, **kw):
    d = dict(mode="train", data_dir=os.path.join(tmp, "data"), corpus="msvd_vgg",
             nworkers=0, bsize=4, glove_emb_file="glove_tiny.txt", num_frames=4,
             vid_feat_size=12, arch="s2vt", max_len=6, dropout_p=0.0, hidden_size=8,
             epochs=2, lr=1e-2, wd=0.0, log_iter=1, save_path=os.path.join(tmp, save),
             log_dir="", seed=123, compute_dtype="float32", vocab_pad_to=8)
    d.update(kw)
    return d


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("dp, mp, beam", [(2, 1, 1), (1, 2, 3)])
def test_two_processes_train_as_one(tmp_path, monkeypatch, dp, mp, beam):
    """dp=2 reads two shards of 4 rows against one process's 8; mp=2 splits
    the vocab projection and the embedding over the two processes, which
    read the same 4 rows, and validates by beam search on the gathered
    weights."""
    tmp = str(tmp_path)
    build_corpus(os.path.join(tmp, "data"), num_videos=12, captions_per_video=1)
    losses, update = [], TrainLogger.update

    def record(self, m):
        losses.append(float(m["loss"]))
        update(self, m)

    monkeypatch.setattr(TrainLogger, "update", record)
    ref = tloop.train(Config(**_config(tmp, "one", bsize=4 * dp, beam_size=beam)),
                      device="cpu")
    cfg = _config(tmp, "two", mesh_dp=dp, mesh_mp=mp, beam_size=beam)
    outs = _run_pair(tmp, TRAIN_WORKER, json.dumps(cfg))
    assert all("====> Mesh: dp=%d x mp=%d" % (dp, mp) in out for out in outs)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    # every rank logs the global batch's losses and scores the global
    # validation set (the timings are each process's own)
    timing = [k for k in ranks[0]["metrics"] if k.startswith("perf/") or k.endswith("_s")]
    for r in ranks:
        for k in timing:
            r["metrics"].pop(k)
    assert ranks[0] == ranks[1]
    got = ranks[0]
    assert len(got["losses"]) == len(losses) == 2 * -(-12 // (4 * dp))  # 2 epochs
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=LOSS_TOL)
    for k in ("loss", "acc"):
        assert got["metrics"][k] == pytest.approx(ref[k], abs=LOSS_TOL), k
    for k in ("METEOR", "BLEU4", "CIDEr", "ROUGE_L"):
        assert got["metrics"][k] == pytest.approx(ref[k], abs=1e-9), k

    # rank 0 alone writes, and its checkpoints hold the whole leaves
    for name in ("model_latest", "model_best"):
        params, opt, meta = tckpt.load_checkpoint(os.path.join(tmp, "two", name))
        want, want_opt, want_meta = tckpt.load_checkpoint(os.path.join(tmp, "one", name))
        assert meta["n_iter"] == want_meta["n_iter"]
        got_leaves, want_leaves = dict(_leaves(params)), dict(_leaves(want))
        assert got_leaves.keys() == want_leaves.keys()
        for path, leaf in got_leaves.items():
            w = want_leaves[path]
            assert leaf.shape == w.shape, path
            gap = (leaf - w).abs().max().item() / max(1.0, w.abs().max().item())
            assert gap <= PARAM_TOL, (path, gap)
        for i, state in want_opt["state"].items():
            assert state["exp_avg"].shape == opt["state"][i]["exp_avg"].shape
    assert not os.path.exists(os.path.join(tmp, "two.tmp"))


def test_preemption_on_one_rank_stops_both(tmp_path):
    """SIGTERM to rank 0 alone: the flag reaches rank 1 through the vote at
    the next step boundary, both exit 0 at the same step, and rank 0 writes
    a checkpoint that loads whole."""
    tmp = str(tmp_path)
    build_corpus(os.path.join(tmp, "data"), num_videos=12, captions_per_video=1)
    cfg = _config(tmp, "pre", epochs=500, mesh_dp=1, mesh_mp=2)
    argv = [x for k, v in cfg.items() for x in (f"--{k}", str(v))] + ["--device", "cpu"]
    port = str(pmesh_free_port())
    procs = [subprocess.Popen([sys.executable, "-u", "-m", "vcr_tpu_torch.parallel.launch",
                               "--nproc", "2", "--port", port, "--rank", str(r), "--",
                               *argv], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        meta = os.path.join(tmp, "pre", "model_latest", "meta.json")
        deadline = time.time() + 120
        while (time.time() < deadline and not os.path.exists(meta)
               and all(p.poll() is None for p in procs)):
            time.sleep(0.2)
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
        assert "Preemption signal" in out, f"rank {r}:\n{out[-2000:]}"
    params, _, meta = tckpt.load_checkpoint(os.path.join(tmp, "pre", "model_latest"))
    assert meta["n_iter"] > 0
    assert params["linear"]["w"].shape[-1] == params["embedding"]["table"].shape[0] == 24


PIECES_WORKER = PRELUDE + """
import numpy as np
from vcr_tpu_torch.parallel import mesh as pm
from vcr_tpu_torch.train import optim
res = {{}}
mesh = pm.make_mesh(1, 2, "cpu")
g = torch.Generator().manual_seed(0)
full = {{"linear": {{"w": torch.randn(5, 8, generator=g), "b": torch.randn(8, generator=g)}},
        "embedding": {{"table": torch.randn(8, 3, generator=g)}},
        "rnn": {{"w_hh": torch.randn(4, 6, generator=g)}}}}
specs = pm.param_specs(full, 8, 2)
local = pm.shard_params(full, mesh, specs)
back = pm.unshard_params(local, mesh, specs)
res["specs"] = specs
res["roundtrip"] = all(torch.equal(back[a][b], full[a][b]) for a in full for b in full[a])
res["local_shapes"] = [list(local["linear"]["w"].shape), list(local["embedding"]["table"].shape)]

# the clip: the split leaves' squares dominate the norm
scale = {{"linear": 100.0, "embedding": 100.0, "rnn": 0.01}}
paths = [(a, b) for a in full for b in full[a]]
grads_full = [full[a][b] * scale[a] for a, b in paths]
split = [pm.spec_at(specs, p) is not None for p in paths]
grads = [pm.shard_leaf(x.clone(), pm.spec_at(specs, p), mesh) for x, p in zip(grads_full, paths)]
local_only = float(torch.sqrt(sum(x.pow(2).sum() for x in grads)))
norm = float(optim.clip_split_(grads, split, mesh.mp_group, 1.0))
ps = [torch.zeros_like(x, requires_grad=True) for x in grads_full]
for p, x in zip(ps, grads_full):
    p.grad = x.clone()
ref_norm = float(torch.nn.utils.clip_grad_norm_(ps, 1.0))
res["clip"] = {{"norm": norm, "ref_norm": ref_norm, "local_only": local_only,
               "gap": max(float((gx - pm.shard_leaf(p.grad, pm.spec_at(specs, q), mesh))
                                .abs().max()) for gx, p, q in zip(grads, ps, paths))}}

# the vocab-parallel NLL, its gradient and the argmax, ties across ranks
logits = torch.randn(3, 4, 8, generator=g)
logits[0, 0, 1] = logits[0, 0, 5] = 50.0       # a tie across the two halves
logits[0, 1, 6] = logits[0, 1, 7] = 50.0       # a tie inside rank 1's half
target = torch.randint(0, 8, (3, 4), generator=g)
weights = torch.rand(3, 4, generator=g)
shard = pm.VocabShard(mesh.mp_group, 2, mesh.mp_index, 8, frozenset(), frozenset())
loc = logits.chunk(2, -1)[mesh.mp_index].clone().requires_grad_(True)
nll = pm.vocab_parallel_nll(loc, target, shard)
(nll * weights).sum().backward()
whole = logits.clone().requires_grad_(True)
ref = -torch.log_softmax(whole, -1).gather(-1, target[..., None])[..., 0]
(ref * weights).sum().backward()
res["nll_gap"] = float((nll - ref).abs().max())
res["nll_grad_gap"] = float((loc.grad - whole.grad.chunk(2, -1)[mesh.mp_index]).abs().max())
res["argmax_equal"] = bool(torch.equal(pm.sharded_argmax(loc.detach(), shard),
                                       logits.argmax(-1)))
masked = pm.mask_pad_columns(loc.detach(), 6, shard)
res["masked_cols"] = int((masked == -1e9).sum())

# the row-split embedding and its gradient
table = full["embedding"]["table"].clone().requires_grad_(True)
rows = local["embedding"]["table"].clone().requires_grad_(True)
ids = torch.tensor([[0, 7, 3], [4, 4, 1]])
emb = pm.embed_rows(rows, ids, shard)
(emb * 2.0).sum().backward()
(table[ids] * 2.0).sum().backward()
res["embed_equal"] = bool(torch.equal(emb, table[ids].detach()))
res["embed_grad_equal"] = bool(torch.equal(rows.grad,
                                          table.grad.chunk(2, 0)[mesh.mp_index]))

# the dp gathers and the vote, on a second layout of the same group
dp2 = pm.make_mesh(2, 1, "cpu")
res["rows"] = pm.gather_global_rows(np.full((2, 3), rank, np.int32), dp2).tolist()
res["vote"] = [pm.global_any(rank == 1, dp2), pm.global_any(False, dp2)]
res["wmean"] = float(pm.weighted_mean([torch.tensor(float(rank))],
                                      torch.tensor(rank + 1.0), dp2)[0])
with open(os.path.join(out, "pieces%d.json" % rank), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def test_mesh_pieces_in_two_processes(tmp_path):
    tmp = str(tmp_path)
    _run_pair(tmp, PIECES_WORKER, timeout=120)
    for r in range(2):
        with open(os.path.join(tmp, f"pieces{r}.json")) as f:
            res = json.load(f)
        assert res["specs"] == {"linear": {"w": "col", "b": "col"},
                                "embedding": {"table": "row"}, "rnn": {"w_hh": None}}
        assert res["roundtrip"] and res["local_shapes"] == [[5, 4], [4, 3]]
        clip = res["clip"]
        # the split leaves set the factor: leaving out the other rank's
        # blocks would move the norm by far more than the float32 sums
        assert clip["norm"] == pytest.approx(clip["ref_norm"], rel=1e-6)
        assert abs(clip["local_only"] - clip["ref_norm"]) > 0.1 * clip["ref_norm"]
        assert clip["ref_norm"] > 1.0 and clip["gap"] <= 1e-7
        assert res["nll_gap"] <= 1e-5 and res["nll_grad_gap"] <= 1e-6
        assert res["argmax_equal"]
        # vocab 6 of 8 padded: columns 6 and 7, both on rank 1
        assert res["masked_cols"] == (0 if r == 0 else 2 * 3 * 4)
        assert res["embed_equal"] and res["embed_grad_equal"]
        assert res["rows"] == [[0, 0, 0], [0, 0, 0], [1, 1, 1], [1, 1, 1]]
        assert res["vote"] == [True, False]
        assert res["wmean"] == pytest.approx(2.0 / 3.0)


def test_layout_without_a_group():
    """shard_batch is host slicing; a mesh without a process group raises,
    and a run of several processes without a mesh is refused by the loop
    (before any data is read)."""
    mesh = pmesh.Mesh(dp=2, mp=1, rank=1, device=torch.device("cpu"))
    batch = {"valid": np.arange(4), "vid_key": ["a", "b", "c", "d"]}
    got = pmesh.shard_batch(batch, mesh)
    assert got["valid"].tolist() == [2, 3] and got["vid_key"] == ["c", "d"]
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_batch({"x": np.arange(3)}, mesh)
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.make_mesh(2, 1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tloop.train(Config(mesh_dp=2, data_dir="/nonexistent"), device="cpu")
    assert pmesh.backend_for("cpu", 2) == "gloo"
    assert pmesh.param_spec(("linear", "w"), torch.zeros(3, 10), 10, 4) is None
    with pytest.warns(UserWarning, match="not divisible"):
        pmesh.param_specs({"linear": {"w": torch.zeros(3, 10)}}, 10, 4)
