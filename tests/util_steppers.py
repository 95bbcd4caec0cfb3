"""Steppers of the beam search's own tests, in numpy-style ops that run on
``jax.numpy`` and ``torch`` alike: one recurrent and random, one whose
log-probabilities tie exactly, so that ties decide the search."""


def random_stepper(xp, w, e, u, vocab):
    """A small recurrent stepper in numpy-style ops: xp is jnp or torch."""
    def step(state, words, i):
        h = xp.tanh(state["h"] @ u + e[words])
        return {"h": h}, 3.0 * xp.tanh(h @ w)[:, :vocab]
    return step


def tie_stepper(xp, vocab, **arange_kw):
    """Each row's logits are 0 at one or two word ids that depend on its
    history and -30 elsewhere, so log-probabilities repeat exactly within a
    row and across beams, and ties decide the search. ``arange_kw`` places
    the word ids (torch's ``device=``)."""
    def step(state, words, i):
        hist = state["hist"]
        ids = xp.arange(vocab, **arange_kw)[None, :]
        a = (hist[:, None] + i) % vocab
        b = (hist[:, None] * 3 + 1) % vocab
        logits = xp.where((ids == a) | (ids == b), 0.0, -30.0)
        return {"hist": (hist * 7 + words) % 1009}, logits
    return step
