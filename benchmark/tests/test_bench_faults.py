"""A whole run of each cell on the CPU at small widths, the look for a card
skipped: sound, ``correct`` comes out true; with the timed path broken
underneath, false. The faults a cell can have: a step that returns its state
unchanged, half of the batch left out (training: the mean taken over the
rest), a token altered where it is produced. No cell spans chips, so none
leaves out an exchange between them. The serving check reads only the
served tokens, the call's one output; faults inside the call, in the
frames' encoding and in RationaleNet's frame selection, are caught through
them."""

import pytest
import torch

from benchmark import calibrate, core

GREEDY = ["s2vt.greedy.b2048", "rationale.greedy.b1024"]
SERVING = GREEDY + ["s2vt.beam5.b512"]


def run(small, cell, plant=None, seed=2024):
    base, bench = small
    ctx = core.build_context(cell, seed, 0.3, False, torch.device("cpu"), bench=bench,
                             base=base)
    if plant is not None:
        plant(ctx)
    return core.run(ctx, 0.0, lambda s: None)


def wrap_program(monkeypatch, wrap):
    """Plant ``wrap(driver, program)`` in place of each driver's program."""
    def plant(ctx):
        driver = ctx.driver_module.Driver
        build = driver.build_program
        monkeypatch.setattr(driver, "build_program", lambda self: wrap(self, build(self)))
    return plant


def altered_token(driver, program):
    """One token of every caption changed where it is produced."""
    def call(i):
        tokens = program(i).clone()
        rows = torch.arange(tokens.shape[0])
        pos = rows % tokens.shape[1]
        tokens[rows, pos] = (tokens[rows, pos] + 1) % driver.m["vocab_size"]
        return tokens
    return call


def half_batch(driver, program):
    """Only the first half of each batch captioned; the rest of the rows get
    the first half's captions."""
    def call(i):
        feats, noise = driver.feats[i], driver.noise[i]
        half = feats.shape[0] // 2
        driver.feats[i] = feats[:half]
        driver.noise[i] = None if noise is None else noise[:half]
        try:
            tokens = program(i)
        finally:
            driver.feats[i], driver.noise[i] = feats, noise
        return torch.cat([tokens, tokens])[: feats.shape[0]]
    return call


@pytest.mark.parametrize("cell", SERVING + ["s2vt.train.b1024"])
def test_sound_run_is_correct(small, cell):
    result = run(small, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell", SERVING)
@pytest.mark.parametrize("fault", [altered_token, half_batch])
def test_serving_faults_are_caught(small, cell, fault, monkeypatch):
    result = run(small, cell, plant=wrap_program(monkeypatch, fault))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", SERVING)
def test_a_decode_step_that_keeps_its_state_is_caught(small, cell, monkeypatch):
    from vcr_tpu_torch import decode
    from vcr_tpu_torch.models import s2vt

    def frozen(x_gates, h, *args, **kwargs):
        return h

    monkeypatch.setattr(s2vt, "gru_gates", frozen)
    monkeypatch.setattr(decode, "gru_gates", frozen)
    result = run(small, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", GREEDY)
def test_an_encoder_that_drops_its_state_midway_is_caught(small, cell, monkeypatch):
    """GRU1's state not carried across the middle frame, as a kernel that
    loses it at a chunk's edge would. (Beam 5 keeps any served token within
    the reference's five best; at the tests' small widths this fault stays
    inside them.)"""
    from vcr_tpu_torch.models import s2vt

    encode = s2vt.encode

    def dropped(params, spec, vid_feats):
        n = vid_feats.shape[1] // 2
        first, _ = encode(params, spec, vid_feats[:, :n])
        second, state = encode(params, spec, vid_feats[:, n:])
        return torch.cat([first, second]), state

    monkeypatch.setattr(s2vt, "encode", dropped)
    result = run(small, cell)
    assert not result["correct"], result["checks"]


def test_a_selection_under_other_noise_is_caught(small, monkeypatch):
    """RationaleNet's frames selected under another video's Gumbel noise."""
    from vcr_tpu_torch.models import rationale

    generator = rationale.generator

    def shifted(params, spec, vid_feats, gumbel_noise=None, **kwargs):
        return generator(params, spec, vid_feats, gumbel_noise=gumbel_noise.roll(1, 0),
                         **kwargs)

    monkeypatch.setattr(rationale, "generator", shifted)
    result = run(small, "rationale.greedy.b1024")
    assert not result["correct"], result["checks"]


def test_a_train_step_that_keeps_its_state_is_caught(small, monkeypatch):
    from vcr_tpu_torch.train import optim

    def unchanged(state, grads, split=None, group=None):
        state.optimizer.zero_grad(set_to_none=True)

    monkeypatch.setattr(optim.Optimizer, "step", staticmethod(unchanged))
    result = run(small, "s2vt.train.b1024")
    assert not result["correct"], result["checks"]
    assert result["checks"]["change_gap"]["value"] == 1.0


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_the_calibration_s_train_faults_are_caught(small, fault, monkeypatch):
    """The faults ``calibrate.py`` plants on the card: half of each batch, the
    parameters left as they were."""
    def plant(ctx):
        driver = ctx.driver_module.Driver
        setup = driver.setup

        def faulty(self):
            calibrate.FAULTS[fault](self)
            setup(self)
        monkeypatch.setattr(driver, "setup", faulty)

    result = run(small, "s2vt.train.b1024", plant=plant)
    assert not result["correct"], result["checks"]
