"""The port's mesh-sharded slot pool: two processes over gloo on the CPU,
against the JAX package's pools from one JAX parameter tree, as
``tests/test_serving_continuous.py`` holds the JAX package's mesh pools.

One pair of processes runs every case in turn (rank 0 drives the pool
through ``caption_all`` or ``caption_stream``, rank 1 follows it) and
writes each case's captions; each parametrised test reads its case.

* S2VT at dp=2: token-exact against the JAX package's unsharded pool and
  its ``make_mesh(2)`` pool.
* The Transformer at mp=2 and at dp=2: greedy, the int8 KV cache and the
  lineage beam of width 3, each token-exact against the JAX package's
  unsharded pool of that mode.
* Per-request sampling at mp=2: rows with greedy parameters equal the JAX
  greedy pool, and a hot row gives a valid caption.
* RationaleNet (its selection drawn per admission) and SpatialNet at dp=2:
  token-exact against the port's one-process pool under the same seed.
* In-flight cancellation at dp=2.
* A follower that dies ends the leader with an error within the group's
  timeout.

The three refusals need no process group.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vcr_tpu import serving_continuous as jsc
from vcr_tpu_torch import serving_continuous as tsc
from vcr_tpu_torch.parallel import mesh as pmesh
from vcr_tpu_torch.parallel.launch import free_port

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_serving_continuous import _models  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60

WORKER = """
import datetime, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2,
                        rank=rank, timeout=datetime.timedelta(seconds={timeout}))
from vcr_tpu_torch import serving_continuous as sc
from vcr_tpu_torch.parallel import mesh as pm
cases = torch.load(os.path.join(out, "cases.pt"), weights_only=False)
res = {{}}
for case in cases:
    mesh = pm.make_mesh(case["dp"], case["mp"], "cpu")
    cc = sc.ContinuousCaptioner(case["params"], case["spec"], mesh=mesh, device="cpu",
                                **case["pool"])
    feats, kind = case["feats"], case["kind"]
    if kind == "dead_follower":
        if rank == 1:
            os._exit(0)
        t0 = time.monotonic()
        try:
            cc.caption_all({{i: feats[i] for i in range(len(feats))}})
            res[case["name"]] = {{"error": None}}
        except Exception as e:
            res[case["name"]] = {{"error": type(e).__name__, "seconds": time.monotonic() - t0}}
        continue
    if rank == 1:
        cc.follow()
        continue
    if kind == "sampling":
        reqs = [(i, feats[i], {{"top_k": 1}}) for i in range(len(feats) - 1)]
        reqs.append(("hot", feats[-1], {{"temperature": 3.0, "top_p": 0.9}}))
        got = dict(cc.caption_stream(reqs))
    elif kind == "cancel":
        offers = []
        def poll_cancelled(outstanding):
            if 0 in outstanding:
                offers.append(True)
                if len(offers) == 2:
                    return {{0}}
            return set()
        got = dict(cc.caption_stream(((i, feats[i]) for i in range(len(feats))),
                                     poll_cancelled=poll_cancelled))
    else:
        got = cc.caption_all({{i: feats[i] for i in range(len(feats))}})
    cc.stop()
    res[case["name"]] = {{"tokens": {{str(k): v.tolist() for k, v in got.items()}},
                          "stats": cc.stats, "local_rows": int(cc.state["active"].shape[0])}}
if rank == 0:
    with open(os.path.join(out, "results.json"), "w") as f:
        json.dump(res, f)
os._exit(0)
"""

S2VT_POOL = dict(slots=4, admit_chunk=2)
BEAM_POOL = dict(slots=2, admit_chunk=1, beam_size=3)
# name -> (arch, dp, mp, port pool kwargs, requests, kind, reference)
CASES = {
    "s2vt_dp2": ("s2vt", 2, 1, S2VT_POOL, 10, "all", "jax"),
    "tf_mp2_greedy": ("transformer", 1, 2, S2VT_POOL, 8, "all", "jax"),
    "tf_dp2_greedy": ("transformer", 2, 1, S2VT_POOL, 8, "all", "jax"),
    "tf_mp2_int8": ("transformer", 1, 2, dict(S2VT_POOL, kv_cache="int8"), 8, "all",
                    "jax"),
    "tf_dp2_int8": ("transformer", 2, 1, dict(S2VT_POOL, kv_cache="int8"), 8, "all",
                    "jax"),
    "tf_mp2_beam3": ("transformer", 1, 2, BEAM_POOL, 6, "all", "jax"),
    "tf_dp2_beam3": ("transformer", 2, 1, BEAM_POOL, 6, "all", "jax"),
    "tf_mp2_sampling": ("transformer", 1, 2,
                        dict(slots=2, admit_chunk=1, request_sampling=True), 5, "sampling",
                        "jax"),
    "rationale_dp2": ("rationale", 2, 1, dict(S2VT_POOL, step_chunk=2), 9, "all", "port"),
    "spatial_dp2": ("spatial", 2, 1, dict(S2VT_POOL, step_chunk=2), 9, "all", "port"),
    "cancel_dp2": ("s2vt", 2, 1, dict(S2VT_POOL, step_chunk=1), 6, "cancel", "port"),
    "dead_follower": ("s2vt", 2, 1, S2VT_POOL, 4, "dead_follower", None),
}
SEED = 5


def _feats(arch, tspec, n):
    shape = (n, tspec.num_frames, tspec.vid_feat_size)
    if arch == "spatial":
        shape += (tspec.grid_size, tspec.grid_size)
    return np.random.default_rng(17).standard_normal(shape).astype(np.float32)


def _port_kw(tspec, pool):
    return dict(pool, eos_id=tspec.sos_id + 1, rng=SEED)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Run every case in one pair of processes -> (results, models, feats)."""
    tmp = str(tmp_path_factory.mktemp("mesh_pool"))
    models = {arch: _models(arch) for arch in {c[0] for c in CASES.values()}}
    cases, feats = [], {}
    for name, (arch, dp, mp, pool, n, kind, _) in CASES.items():
        tspec, tparams = models[arch][2], models[arch][3]
        feats[name] = _feats(arch, tspec, n)
        cases.append({"name": name, "spec": tspec, "params": tparams, "dp": dp, "mp": mp,
                      "pool": _port_kw(tspec, pool), "feats": feats[name], "kind": kind})
    torch.save(cases, os.path.join(tmp, "cases.pt"))
    path = os.path.join(tmp, "worker.py")
    with open(path, "w") as f:
        f.write(WORKER.format(repo=REPO, timeout=GROUP_TIMEOUT_S))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, path, str(r), port, tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    with open(os.path.join(tmp, "results.json")) as f:
        return json.load(f), models, feats


def _jax_pool(models, arch, pool, feats, mesh=None, requests=None):
    """The JAX package's pool of the same geometry and mode on the same
    requests -> {str key: tokens}."""
    jspec, jparams = models[arch][0], models[arch][1]
    pool = {k: v for k, v in pool.items() if k != "request_sampling"}
    cc = jsc.ContinuousCaptioner(jparams, jspec, eos_id=jspec.sos_id + 1, mesh=mesh,
                                 rng=jax.random.PRNGKey(SEED), **pool)
    reqs = requests or [(i, feats[i]) for i in range(len(feats))]
    return {str(k): np.asarray(v).tolist() for k, v in cc.caption_stream(reqs)}


def _port_pool(models, arch, pool, feats):
    tspec, tparams = models[arch][2], models[arch][3]
    cc = tsc.ContinuousCaptioner(tparams, tspec, device="cpu", **_port_kw(tspec, pool))
    return {str(k): v.tolist() for k, v in cc.caption_all(dict(enumerate(feats))).items()}


@pytest.mark.parametrize("name", [n for n in CASES if n != "dead_follower"])
def test_sharded_pool_is_token_exact(served, name):
    results, models, feats = served
    arch, dp, mp, pool, n, kind, reference = CASES[name]
    got = results[name]
    tokens, x = got["tokens"], feats[name]
    # each rank holds its block of the slots and a sink of its own
    rows = pool["slots"] // dp + 1
    assert got["local_rows"] == rows
    assert got["stats"]["served"] == n - (kind == "cancel")
    if kind == "sampling":
        want = _jax_pool(models, arch, dict(pool, slots=2, admit_chunk=1), x[:-1])
        assert {k: tokens[k] for k in want} == want
        eos = models[arch][2].sos_id + 1
        hot = tokens["hot"]
        assert 1 <= len(hot) <= models[arch][2].max_len
        assert eos not in hot[:-1]
        return
    if kind == "cancel":
        want = _port_pool(models, arch, pool, x)
        assert "0" not in tokens and sorted(tokens) == ["1", "2", "3", "4", "5"]
        assert tokens == {k: want[k] for k in tokens}
        assert got["stats"]["cancelled"] == 1
        return
    if reference == "jax":
        want = _jax_pool(models, arch, pool, x)
        if arch == "s2vt":
            from vcr_tpu.parallel.mesh import make_mesh

            assert _jax_pool(models, arch, pool, x, mesh=make_mesh(2)) == want
    else:
        want = _port_pool(models, arch, pool, x)
    assert tokens == want


def test_dead_follower_ends_the_leader(served):
    """Rank 1 exits after building the pool: rank 0's first collective with
    it fails, inside the group's timeout, and nothing hangs."""
    got = served[0]["dead_follower"]
    assert got["error"] is not None
    assert got["seconds"] < GROUP_TIMEOUT_S


def test_mesh_refusals():
    """The JAX package's three ValueErrors, before any collective: slots
    that dp does not divide, a padded vocab that mp does not divide, int8
    decode weights with mp > 1."""
    _, _, tspec, tparams, _ = _models("s2vt")
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible by dp"):
        tsc.ContinuousCaptioner(tparams, tspec, slots=5, admit_chunk=2, device="cpu",
                                mesh=pmesh.Mesh(2, 1, 0, cpu))
    with pytest.raises(ValueError, match="not divisible by mesh mp"):
        tsc.ContinuousCaptioner(tparams, tspec.with_(vocab_pad_to=1), slots=4,
                                admit_chunk=2, device="cpu", mesh=pmesh.Mesh(1, 4, 0, cpu))
    with pytest.raises(ValueError, match="int8"):
        tsc.ContinuousCaptioner(tparams, tspec, slots=4, admit_chunk=2, device="cpu",
                                decode_weights="int8", mesh=pmesh.Mesh(1, 2, 0, cpu))
