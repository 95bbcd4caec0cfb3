"""The port's continuous-batching pool against the JAX package's on the CPU,
from one JAX parameter tree, for all five families: greedy, beam and
sampling under the JAX package's own noise give the same harvested tokens
as JAX's ContinuousCaptioner on the same requests in the same order, and
as the port's batch decodes cut at their first eos. Also the Transformer's
slot stepper against the KV-cached stepper and JAX's slot stepper, the
row-wise sampling filters, per-request opts, cancellation, slot reuse and
stats, the scheduler on one fake device half in both packages, and the
refusals."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vcr_tpu import serving_continuous as jsc
from vcr_tpu.decode import apply_sampling_filters as japply_filters
from vcr_tpu.models import transformer as jtr
from vcr_tpu_torch import bridge, entry
from vcr_tpu_torch import decode as tdecode
from vcr_tpu_torch import serving as tserving
from vcr_tpu_torch import serving_continuous as tsc
from vcr_tpu_torch.models import rationale as trationale
from vcr_tpu_torch.models import transformer as ttr

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_decode import _jax_gumbel  # noqa: E402

DIMS = dict(vocab_size=21, embed_size=16, hidden=16, vid_feat=12, max_len=7,
            num_frames=4)
GRID = 3
ARCHS = ["s2vt", "s2vt-att", "spatial", "rationale", "transformer"]
POOL = dict(slots=3, admit_chunk=2, step_chunk=2)
N_REQ = 7
STEPPER_TOL = 1e-5   # float32 logits of the slot stepper against JAX's: sums in
                     # other orders through 2 layers and 4 steps


def _models(arch, seed=0):
    """(JAX spec, JAX params as numpy, port spec, port params, feats), one
    parameter tree, float32; SpatialNet and RationaleNet over S2VT."""
    kw = dict(arch=arch, compute_dtype="float32", vocab_pad_to=8, seed=seed)
    dims = dict(DIMS)
    if arch in ("spatial", "rationale"):
        kw["base_arch"] = "s2vt"
    if arch == "spatial":
        kw["grid_size"] = GRID
        dims["vid_feat"] = 6
    if arch == "transformer":
        kw.update(tf_layers=2, tf_heads=2)
    jspec, jparams = graft._make_spec_and_params(**dims, **kw)
    tspec, _ = entry.make_spec_and_params(**dims, device="cpu", **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    shape = (N_REQ, dims["num_frames"], dims["vid_feat"])
    if arch == "spatial":
        shape += (GRID, GRID)
    feats = np.random.default_rng(seed + 11).standard_normal(shape).astype(np.float32)
    return jspec, jparams, tspec, bridge.from_jax_params(jparams, "cpu"), feats


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return _models(request.param)


def _eos(spec):
    return spec.sos_id + 1


def _cut(rows, eos):
    """Each row up to and including its first eos."""
    out = []
    for row in np.asarray(rows):
        hits = np.nonzero(row == eos)[0]
        out.append(row[: hits[0] + 1] if len(hits) else row)
    return out


def _select_noise_jax(spec, seed=0, a=POOL["admit_chunk"]):
    """JAX's frame-selection noise of admission chunk c: its generator's
    Gumbel draw from fold_in(PRNGKey(seed), c)."""
    key = jax.random.PRNGKey(seed)
    return lambda c: _jax_gumbel(jax.random.fold_in(key, c), (a, spec.num_frames, 2))


def _sample_noise_jax(spec, seed, a=POOL["admit_chunk"]):
    """The Gumbel rows JAX's pool adds for request row j of chunk c:
    categorical(fold_in(split(fold_in(key, c), a)[j], step))."""
    key = jax.random.PRNGKey(seed)

    def noise(c, j):
        kd = jax.random.split(jax.random.fold_in(key, c), a)[j]
        return np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(kd, s),
                                                      (spec.padded_vocab_size,),
                                                      jnp.float32))
                         for s in range(spec.max_len)])
    return noise


def _serve_both(family, jax_kw=None, port_kw=None, requests=None):
    """The same requests through JAX's pool and the port's -> ({key: tokens})
    twice. RationaleNet's port pool takes JAX's frame-selection noise."""
    jspec, jparams, tspec, tparams, feats = family
    jax_kw, port_kw = dict(jax_kw or {}), dict(port_kw or {})
    if tspec.arch == "rationale":
        port_kw.setdefault("select_noise", _select_noise_jax(tspec))
    reqs = requests or [(i, feats[i]) for i in range(len(feats))]
    jpool = jsc.ContinuousCaptioner(jparams, jspec, eos_id=_eos(jspec),
                                    rng=jax.random.PRNGKey(0), **POOL, **jax_kw)
    tpool = tsc.ContinuousCaptioner(tparams, tspec, eos_id=_eos(tspec), rng=0,
                                    device="cpu", **POOL, **port_kw)
    return dict(jpool.caption_stream(reqs)), dict(tpool.caption_stream(reqs)), tpool


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=str(key))


def _batch_greedy(tspec, tparams, feats):
    """The port's batch greedy, cut at the first eos; RationaleNet under zero
    selection noise."""
    x = torch.from_numpy(feats)
    if tspec.arch == "rationale":
        rows = trationale.apply(tparams, tspec, x, emit="tokens",
                                gumbel_noise=torch.zeros((len(feats), tspec.num_frames, 2)))[0]
    else:
        rows = tserving.build_captioner(tparams, tspec, device="cpu")(x)
    return _cut(rows.numpy(), _eos(tspec))


def test_greedy_pool_matches_jax_pool_and_batch_greedy(family):
    jspec, jparams, tspec, tparams, feats = family
    want, got, pool = _serve_both(family)
    _assert_same(got, want)
    assert pool.stats["served"] == N_REQ and pool.in_flight == 0
    if tspec.arch == "rationale":
        zeros = lambda c: np.zeros((POOL["admit_chunk"], tspec.num_frames, 2), np.float32)
        got = tsc.ContinuousCaptioner(tparams, tspec, select_noise=zeros, device="cpu",
                                      **POOL).caption_all(dict(enumerate(feats)))
    _assert_same(got, dict(enumerate(_batch_greedy(tspec, tparams, feats))))


def test_beam_pool_matches_jax_pool_and_batch_beam(family):
    """Beam 3: each slot's best beam cut at its first eos equals JAX's pool
    and the port's batch beam's best row (the Transformer: the lineage slot
    stepper against the KV-cached batch beam)."""
    jspec, jparams, tspec, tparams, feats = family
    want, got, _ = _serve_both(family, {"beam_size": 3}, {"beam_size": 3})
    _assert_same(got, want)
    x, eos = torch.from_numpy(feats), _eos(tspec)
    if tspec.arch == "transformer":
        rows = tdecode.transformer_beam_decode_fast(tparams, tspec, x, 3, eos)[0][:, 0]
        want = dict(enumerate(_cut(rows.numpy(), eos)))
    elif tspec.arch == "rationale":
        zeros = torch.zeros((len(feats), tspec.num_frames, 2))
        rows = tdecode.rationale_beam_decode(tparams, tspec, x, 3, eos,
                                             gumbel_noise=zeros)[0][:, 0]
        want = dict(enumerate(_cut(rows.numpy(), eos)))
        got = tsc.ContinuousCaptioner(
            tparams, tspec, beam_size=3, device="cpu",
            select_noise=lambda c: np.zeros((POOL["admit_chunk"], tspec.num_frames, 2),
                                            np.float32), **POOL).caption_all(
            dict(enumerate(feats)))
    else:
        rows = tdecode.decode_tokens(tparams, tspec, x, eos, 3)[0][:, 0]
        want = dict(enumerate(_cut(rows.numpy(), eos)))
    _assert_same(got, want)


def test_sampling_pool_matches_jax_under_its_noise(family):
    """Temperature, top-k and top-p per slot, each request's Gumbel rows the
    ones JAX's pool draws: the same tokens."""
    jspec, jparams, tspec, tparams, feats = family
    kw = dict(sample_temperature=1.3, sample_top_k=5, sample_top_p=0.9)
    want, got, _ = _serve_both(family, kw, dict(kw, sample_noise=_sample_noise_jax(tspec, 0)))
    _assert_same(got, want)


def test_sampling_streams_per_request():
    """top_k=1 is argmax: the greedy pool's tokens. A request's stream is
    its (seed, admission index, row), whatever the pool's size and the other
    slots' videos (with slots >= requests every pool admits the same
    chunks); another seed re-rolls it."""
    _, _, tspec, tparams, feats = _models("s2vt")
    reqs = dict(enumerate(feats))

    def serve(slots=3, reqs=reqs, **kw):
        return tsc.ContinuousCaptioner(tparams, tspec, device="cpu", slots=slots,
                                       admit_chunk=2, step_chunk=2, **kw).caption_all(reqs)

    _assert_same(serve(sample_temperature=0.7, sample_top_k=1), serve())
    a, b, c = (serve(slots, sample_temperature=5.0, rng=seed)
               for slots, seed in ((N_REQ, 4), (2 * N_REQ, 4), (N_REQ, 9)))
    _assert_same(a, b)
    assert any(not np.array_equal(a[i], c[i]) for i in reqs)
    other = serve(N_REQ, {**reqs, 0: feats[0][::-1].copy()}, sample_temperature=5.0, rng=4)
    _assert_same({i: other[i] for i in range(1, N_REQ)},
                 {i: a[i] for i in range(1, N_REQ)})


@pytest.mark.parametrize("lineage", [False, True])
def test_slot_stepper_against_cached_stepper_and_jax(lineage):
    """Four steps: at uniform positions the slot stepper equals the port's
    make_cached_stepper element for element (logits and caches); at ragged
    positions its logits are JAX's make_slot_stepper's within 1e-5."""
    jspec, jparams, tspec, tparams, feats = _models("transformer")
    k = 2 if lineage else 1
    x = torch.from_numpy(feats[:3])
    eo = ttr.encode(tparams, tspec, x, ttr.create_masks_inp(x))
    rows = 3 * k
    words = torch.randint(0, tspec.vocab_size, (4, rows),
                          generator=torch.Generator().manual_seed(1)).to(torch.int32)

    step, init_self, cross = ttr.make_slot_stepper(tparams, tspec, beam_tile=k,
                                                   lineage=lineage)
    cached = ttr.make_cached_stepper(tparams, tspec, eo, beam_tile=k, lineage=lineage)
    st = {**init_self(rows), **cross(eo.repeat_interleave(k, 0))}
    cst = cached[1]
    for i in range(4):
        st, lg = step(st, words[i], torch.full((rows,), i, dtype=torch.int32))
        cst, clg = cached[0](cst, words[i], i)
        assert torch.equal(lg, clg)
        for li in range(tspec.tf_layers):
            assert all(torch.equal(a, b) for a, b in zip(st[f"c{li}"], cst[f"c{li}"]))
        if lineage:
            assert torch.equal(st["anc"], cst["anc"])

    jstep, jinit, jcross = jtr.make_slot_stepper(jparams, jspec, beam_tile=k,
                                                 lineage=lineage)
    jeo = jtr.encode(jparams, jspec, jnp.asarray(feats[:3]),
                     jtr.create_masks_inp(jnp.asarray(feats[:3])), jax.random.PRNGKey(0),
                     train=False)
    jst = {**jinit(rows), **jcross(jnp.repeat(jeo, k, axis=0))}
    st = {**init_self(rows), **cross(eo.repeat_interleave(k, 0))}
    i_vec = np.array([0, 2, 1, 3, 0, 1][:rows], np.int32)
    for i in range(4):
        jst, jlg = jstep(jst, jnp.asarray(words[i].numpy()), jnp.asarray(i_vec + i))
        st, lg = step(st, words[i], torch.from_numpy(np.minimum(i_vec + i, 6)))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0, atol=STEPPER_TOL)


def test_row_sampling_filters_match_jax():
    """Mixed rows (off, temperature only, top_k, top_p, all three, argmax)
    against JAX's row-wise filters."""
    logits = np.random.default_rng(0).standard_normal((7, 13)).astype(np.float32) * 3
    logits[:, -2:] = tdecode.NEG_INF
    temp = np.array([1.0, 0.7, 1.3, 1.0, 0.5, 1.0, 5.0], np.float32)
    topk = np.array([0, 0, 4, 0, 3, 1, 0], np.int32)
    topp = np.array([0.0, 0.0, 0.0, 0.6, 0.8, 0.0, 0.3], np.float32)
    want = np.asarray(jsc._row_sampling_filters(jnp.asarray(logits), jnp.asarray(temp),
                                                jnp.asarray(topk), jnp.asarray(topp)))
    got = tsc._row_sampling_filters(torch.from_numpy(logits), torch.from_numpy(temp),
                                    torch.from_numpy(topk), torch.from_numpy(topp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert ((got.numpy() == tdecode.NEG_INF) == (want == tdecode.NEG_INF)).all()
    for j in range(7):   # and each row equals the scalar filters
        scalar = japply_filters(jnp.asarray(logits[j:j + 1]), float(temp[j]), int(topk[j]),
                                float(topp[j]))
        np.testing.assert_allclose(got.numpy()[j:j + 1], np.asarray(scalar), rtol=1e-6,
                                   atol=1e-6)


def test_request_opts_cancellation_reuse_and_stats():
    """Per-request opts (greedy rows, explicit temperature 0, a hot nucleus)
    in one pool equal JAX's under its noise; an in-flight cancel releases
    its slot and the pool keeps serving the greedy tokens; stats add up."""
    fam = _models("s2vt")
    jspec, jparams, tspec, tparams, feats = fam

    def reqs():
        for i in range(N_REQ):
            if i % 3 == 1:
                yield i, feats[i], {"temperature": 4.0, "top_p": 0.95}
            elif i % 3 == 2:
                yield i, feats[i], {"temperature": 0.0}
            else:
                yield i, feats[i]

    want, got, pool = _serve_both(fam, {"request_sampling": True},
                                  {"request_sampling": True,
                                   "sample_noise": _sample_noise_jax(tspec, 0)},
                                  requests=list(reqs()))
    _assert_same(got, want)
    greedy = _batch_greedy(tspec, tparams, feats)
    for i in range(N_REQ):
        if i % 3 != 1:
            np.testing.assert_array_equal(got[i], greedy[i])
    assert pool.accepts_request_opts

    # an in-flight cancel: key 0 decodes >= 2 tokens, cancelled at its
    # second offer, after its admission
    assert len(greedy[0]) >= 2
    pool = tsc.ContinuousCaptioner(tparams, tspec, device="cpu", slots=2, admit_chunk=1,
                                   step_chunk=1)
    offers = []

    def poll_cancelled(outstanding):
        if 0 in outstanding:
            offers.append(True)
            return {0} if len(offers) == 2 else set()
        return set()

    got = dict(pool.caption_stream(((i, feats[i]) for i in range(5)),
                                   poll_cancelled=poll_cancelled))
    assert sorted(got) == [1, 2, 3, 4]
    for i in range(1, 5):
        np.testing.assert_array_equal(got[i], greedy[i])
    got = pool.caption_all({10 + i: feats[i] for i in range(5)})   # slots reused
    for i in range(5):
        np.testing.assert_array_equal(got[10 + i], greedy[i])
    s = pool.stats
    assert s["cancelled"] == 1 and s["served"] == 9 and pool.in_flight == 0
    assert s["useful_steps"] == sum(len(greedy[i]) for i in list(range(1, 5)) + list(range(5)))
    assert s["slot_steps"] == s["ticks"] * pool.slots * pool.step_chunk


class FakeOps:
    """The scheduler's device half in numpy, recording every call: slot s
    decodes ``lengths[key]`` tokens, each the key."""

    accepts_request_opts = True

    def __init__(self, slots=3, admit_chunk=2, step_chunk=2, max_len=5):
        self.slots, self.admit_chunk, self.step_chunk = slots, admit_chunk, step_chunk
        self.max_len, self.calls, self.in_flight = max_len, [], 0
        self.stats = {"ticks": 0, "admit_chunks": 0, "served": 0, "useful_steps": 0,
                      "slot_steps": 0}
        self._key = np.zeros((slots,), np.int64)
        self._steps = np.zeros((slots,), np.int32)
        self._active = np.zeros((slots,), bool)
        self._toks = np.zeros((slots, max_len), np.int32)

    def encode_admit(self, feats, ids, valid, opts):
        self.calls.append(("admit", ids.tolist(), valid.tolist(),
                           [sorted(o) if o else None for o in opts]))
        for j in np.flatnonzero(valid):
            s = int(ids[j])
            self._key[s], self._steps[s], self._active[s] = int(feats[j].flat[0]), 0, True

    def tick(self):
        self.calls.append(("tick",))
        for _ in range(self.step_chunk):
            for s in np.flatnonzero(self._active):
                self._toks[s, self._steps[s]] = self._key[s]
                self._steps[s] += 1
                self._active[s] = self._steps[s] < min(self._key[s] % 4 + 1, self.max_len)

    def poll_active(self):
        return self._active.copy()

    def read_tokens(self):
        self.calls.append(("read",))
        return self._toks.copy(), self._steps.copy()

    def release_slots(self, ids):
        self.calls.append(("release", ids.tolist()))
        self._active[ids] = False


def test_scheduler_on_one_fake_device_half_in_both_packages():
    """Poll markers, per-request opts, a queued and an in-flight cancel:
    the same calls and the same completion order in both packages."""
    def run(module):
        ops = FakeOps()

        def requests():
            for k in range(9):
                if k % 3 == 0:
                    yield None
                yield (k, np.full((2, 2), float(k), np.float32)) + (
                    ({"temperature": 1.0},) if k == 4 else ())

        def poll_cancelled(outstanding):
            return {5, 7} & outstanding

        out = [(k, t.tolist()) for k, t in module.run_slot_scheduler(
            ops, requests(), poll_cancelled=poll_cancelled)]
        return out, ops.calls, ops.stats

    want, got = run(jsc), run(tsc)
    assert got == want
    assert sorted(k for k, _ in got[0]) == [0, 1, 2, 3, 4, 6, 8]
    assert got[2]["cancelled"] >= 1


def test_refusals():
    _, _, tspec, tparams, _ = _models("s2vt")
    kw = dict(device="cpu", **POOL)
    # the mesh-sharded pool is ported (tests/test_torch_mesh_serving.py): a
    # pool of 3 slots does not shard over dp=2
    from vcr_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="not divisible by dp"):
        tsc.ContinuousCaptioner(tparams, tspec, mesh=Mesh(2, 1, 0, torch.device("cpu")),
                                **kw)
    # the quantized modes are ported (A13): S2VT has no attention cache to
    # quantize, and an unknown mode raises
    for mode, match in (({"kv_cache": "int8"}, "has none"), ({"kv_cache": "int4"}, "has none"),
                        ({"decode_weights": "int4"}, "decode_weights")):
        with pytest.raises(ValueError, match=match):
            tsc.ContinuousCaptioner(tparams, tspec, **mode, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsc.ContinuousCaptioner(tparams, tspec, request_sampling=True, beam_size=2, **kw)
    with pytest.raises(ValueError, match="admit_chunk"):
        tsc.ContinuousCaptioner(tparams, tspec, slots=2, admit_chunk=3, device="cpu")
    with pytest.raises(NotImplementedError, match="continuous serving covers"):
        tsc.ContinuousCaptioner(tparams, tspec.with_(arch="nope"), **kw)
    pool = tsc.ContinuousCaptioner(tparams, tspec, **kw)
    feats = np.zeros((tspec.num_frames, tspec.vid_feat_size), np.float32)
    with pytest.raises(ValueError, match="per-request options"):
        list(pool.caption_stream([(0, feats, {"temperature": 2.0})]))
    assert pool.check_feat_shape(feats.shape) is None
    assert "expected" in pool.check_feat_shape((3, 2))
