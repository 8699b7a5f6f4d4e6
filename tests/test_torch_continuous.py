"""Continuous self-play: the port's ContinuousSelfPlay against the JAX
package's, with a tiny move cap so that slots end and respawn inside the
step many times, and resignation on in some games.

The JAX actor draws each step's noise, symmetries and Gumbel draws from
its key chain; the port gets the same draws (test_torch_games.jax_draws).
Every harvested game dict must be equal: integer arrays and outcomes
exactly, values and policy targets within 1e-5.

The JAX actor dispatches a step with ``jnp.asarray(self._thresholds)``
and then, before that step has run, harvests the previous record, which
rewrites the thresholds of the slots that respawn.  On the CPU
``jnp.asarray`` aliases a 64-byte aligned numpy array instead of copying
it, so whether a respawned slot's first step sees its old threshold (the
documented semantics, and the port's) or its new one depends on the
allocation and on timing: under load the JAX side's counters and games
changed from run to run.  ``settled`` makes each JAX step finish before
the host touches the thresholds, which is the documented order."""
import itertools

import jax
import numpy as np
import torch

from sejonggo_tpu.actor.continuous import ContinuousSelfPlay as JContinuous
from sejonggo_tpu.config import SearchConfig as JSearch
from sejonggo_torch.actor import ContinuousSelfPlay
from sejonggo_torch.config import SearchConfig
from test_torch_games import FLOAT_ATOL, jax_draws, seeded_nets

FLOAT_KEYS = ("values", "policies")
COUNTERS = ("steps", "games_finished", "empty_games", "moves_recorded",
            "fresh_trees")


def thresholds():
    """A fresh source of per-game thresholds, the same sequence each time:
    resignation off, at a level some values reach, off, and instant."""
    it = itertools.cycle([np.nan, -0.02, np.nan, 0.03, np.nan, 2.0])
    return lambda: float(next(it))


def settled(actor):
    """Make the JAX actor's step complete before it returns, so that the
    host's harvest cannot rewrite the thresholds the step reads."""
    step = actor._step
    actor._step = lambda *args: jax.block_until_ready(step(*args))
    return actor


def test_continuous_games_match_jax():
    size, b, seed = 5, 3, 11
    kw = dict(simulations=16, batch_size=8, use_symmetry=True,
              dirichlet_alpha=0.3, max_nodes=40)
    js, ts = JSearch(**kw), SearchConfig(**kw)
    jpred, variables, tpred = seeded_nets(size, seed)
    rng = jax.random.PRNGKey(seed)
    common = dict(size=size, komi=5.5, game_batch=b, stop_exploration=2,
                  max_moves=6)
    jc = settled(JContinuous(jpred, variables, search=js, rng=rng,
                             threshold_fn=thresholds(), **common))
    tc = ContinuousSelfPlay(tpred, search=ts, device="cpu",
                            threshold_fn=thresholds(),
                            draws=jax_draws(rng, ts, b, size, True, False),
                            **common)
    for num_games in (5, 4):       # two calls: the ring carries over
        jgames = jc.run(num_games)
        tgames = tc.run(num_games)
        assert len(jgames) == len(tgames) >= num_games
        for jg, tg in zip(jgames, tgames):
            assert jg.keys() == tg.keys()
            for key, j in jg.items():
                if key in FLOAT_KEYS:
                    np.testing.assert_allclose(tg[key], j, atol=FLOAT_ATOL,
                                               rtol=0, err_msg=key)
                else:
                    assert np.array_equal(np.asarray(j), np.asarray(tg[key])), key
        for name in COUNTERS:
            assert getattr(jc, name) == getattr(tc, name), name
    assert tc.empty_games > 0                   # an instant resign, dropped
    assert any(g["resigned"] for g in tgames + jgames)
    assert tc.tree_fresh_rate == jc.tree_fresh_rate < 1.0


def test_continuous_port_independent_of_threads():
    """The port's games do not depend on torch's CPU thread count: the
    same run at 1 and at 4 threads gives bit-equal games and counters."""
    size, b, seed = 5, 3, 11
    kw = dict(simulations=16, batch_size=8, use_symmetry=True,
              dirichlet_alpha=0.3, max_nodes=40)
    _, _, tpred = seeded_nets(size, seed)
    runs = []
    threads = torch.get_num_threads()
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            tc = ContinuousSelfPlay(
                tpred, search=SearchConfig(**kw), device="cpu", size=size,
                komi=5.5, game_batch=b, stop_exploration=2, max_moves=6,
                threshold_fn=thresholds(),
                draws=jax_draws(jax.random.PRNGKey(seed), SearchConfig(**kw),
                                b, size, True, False))
            games = tc.run(5) + tc.run(4)
            runs.append((games, [getattr(tc, k) for k in COUNTERS]))
    finally:
        torch.set_num_threads(threads)
    (g1, c1), (g4, c4) = runs
    assert c1 == c4 and len(g1) == len(g4)
    for a, b_ in zip(g1, g4):
        assert a.keys() == b_.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b_[k])), k
