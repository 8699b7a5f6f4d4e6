"""The port's rollout-prior engine (sejonggo_torch.search.rollout)
against the JAX package's.

heuristic_priors is exact (sums of integer weights, one rounded product
by W_SELF_ATARI).  The predict functions' policies divide by a sum whose
order differs between XLA and torch: within 1e-6 relative.  The 'score'
value goes through tanh: within 1e-6.  The 'rollout' value takes JAX's
draws (its key is folded from the boards' contents) and is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.search import rollout as JR
from sejonggo_torch.search import rollout as TR
from test_torch_heuristics import played_boards, one_torch_thread  # noqa: F401

POLICY_RTOL = 1e-6
VALUE_ATOL = 1e-6
STEPS = 40


@pytest.fixture(scope="module")
def boards():
    b, _ = played_boards(9, 4, (6, 20, 45), seed=4)
    return b


def rollout_gumbels(boards, seed, steps):
    """The (S, B, A) Gumbels of JAX's 'rollout' predict on ``boards``."""
    mix = jnp.sum(jnp.asarray(boards).astype(jnp.uint32)) + jnp.uint32(seed)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), mix)
    b, a = boards.shape[0], boards.shape[-3] ** 2 + 1

    def per_step(k):
        return jax.vmap(lambda kk: jax.random.gumbel(kk, (a,)))(
            jax.random.split(k, b))

    return torch.from_numpy(np.array(
        jax.jit(jax.vmap(per_step))(jax.random.split(rng, steps))))


def test_heuristic_priors_match_jax(boards):
    want = np.asarray(jax.jit(jax.vmap(JR.heuristic_priors))(boards.numpy()))
    got = TR.heuristic_priors(boards).numpy()
    assert np.array_equal(got, want)
    assert (want[:, :81] > 10).any()        # captures or escapes occur


@pytest.mark.parametrize("mode", ["score", "rollout"])
def test_predict_fn_matches_jax(boards, mode):
    feats = boards.to(torch.float32)
    jfn = jax.jit(JR.make_heuristic_predict_fn(
        5.5, rollout_steps=STEPS, value_mode=mode, seed=1))
    jpol, jval = jfn(None, feats.numpy())
    tfn = TR.make_heuristic_predict_fn(
        5.5, rollout_steps=STEPS, value_mode=mode, seed=1,
        draws=lambda bd: rollout_gumbels(bd.numpy(), 1, STEPS))
    pol, val = tfn(feats)
    np.testing.assert_allclose(pol.numpy(), np.asarray(jpol), rtol=POLICY_RTOL,
                               atol=0)
    if mode == "rollout":
        assert np.array_equal(val.numpy(), np.asarray(jval))
        assert set(np.unique(val.numpy())) <= {-1.0, 0.0, 1.0}
    else:
        np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=0,
                                   atol=VALUE_ATOL)
    # without draws the port is still a pure function of its input
    plain = TR.make_heuristic_predict_fn(5.5, rollout_steps=STEPS,
                                         value_mode=mode, seed=1)
    assert torch.equal(plain(feats)[1], plain(feats)[1])


def test_rollout_values_full_length_match_jax(boards):
    b = boards[:6]
    rng = jax.random.PRNGKey(8)
    want = jax.jit(lambda bd, r: JR.rollout_values(bd, r, 5.5))(b.numpy(), rng)

    def per_step(k):
        return jax.vmap(lambda kk: jax.random.gumbel(kk, (82,)))(
            jax.random.split(k, 6))

    g = torch.from_numpy(np.array(jax.jit(jax.vmap(per_step))(
        jax.random.split(rng, 162))))
    got = TR.rollout_values(b, 5.5, gumbel=g)
    assert np.array_equal(got.numpy(), np.asarray(want))
