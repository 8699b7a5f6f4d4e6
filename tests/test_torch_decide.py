"""Temperature-1 decisions of the port (search.decide_batch) against the
JAX package's, under JAX's own draws.

JAX's _decide samples with jax.random.categorical, which is
argmax(gumbel(key, (A,)) + log N) with one key per game from
split(r_decide, B).  The test draws the same Gumbel values from the same
keys and hands them to the port: every sampled move must be equal,
greedy rows and rows with no visits included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.search import mcts as JM
from sejonggo_tpu.search import tree as JT
from sejonggo_torch.search import mcts as TM
from sejonggo_torch.search import tree as TT


def jax_gumbel(r_decide, b, a):
    """The (B, A) draws JAX's decide_batch makes from ``r_decide``."""
    keys = jax.random.split(r_decide, b)
    return np.stack([np.asarray(jax.random.gumbel(k, (a,), jnp.float32))
                     for k in keys])


def _trees(b, size, seed):
    """B root trees with random visit counts and value sums: some rows
    have no visits, some are sparse, some dense, with count ties."""
    rng = np.random.RandomState(seed)
    a = size * size + 1
    boards = np.zeros((b, size, size, 17), np.int8)
    boards[..., 16] = 1
    pol = np.full((b, a), 1.0 / a, np.float32)
    jt = JT.new_tree_batch(jnp.asarray(pol), jnp.asarray(boards), 4)
    counts = np.zeros((b, 4, a), np.int32)
    for i in range(b):
        kind = i % 4
        if kind == 0:
            continue                         # no visits at all
        dens = {1: 0.05, 2: 0.3, 3: 1.0}[kind]
        counts[i, 0] = np.where(rng.rand(a) < dens,
                                rng.randint(0, 6 if kind == 3 else 40, a), 0)
    w = (rng.randn(b, 4, a) * counts).astype(np.float32)
    jt = jt._replace(child_N=jnp.asarray(counts), child_W=jnp.asarray(w))
    tt = TT.new_tree_batch(torch.from_numpy(pol), torch.from_numpy(boards), 4)
    tt = tt.replace(child_N=torch.from_numpy(counts), child_W=torch.from_numpy(w))
    return jt, tt


@pytest.mark.parametrize("size,seed", [(5, 0), (9, 1), (9, 2)])
def test_temperature_one_decisions_equal_jax(size, seed):
    b = 64
    jt, tt = _trees(b, size, seed)
    greedy = np.random.RandomState(seed).rand(b) < 0.25
    r_decide = jax.random.PRNGKey(100 + seed)
    want = np.asarray(jax.jit(JM.decide_batch)(jt, jnp.asarray(greedy), r_decide))
    gumbel = torch.from_numpy(jax_gumbel(r_decide, b, size * size + 1))
    got = TM.decide_batch(tt, torch.from_numpy(greedy), gumbel=gumbel).numpy()
    assert np.array_equal(want, got)
    # the sampled rows really sample: not every one is the greedy move
    greedy_moves = TM.decide_batch(tt, torch.ones(b, dtype=torch.bool)).numpy()
    visited = np.asarray(jt.child_N)[:, 0].max(-1) > 0
    assert (got != greedy_moves)[~greedy & visited].any()
    # rows without visits take the greedy move, sampled or not
    assert np.array_equal(got[~visited], greedy_moves[~visited])


def test_draws_move_to_the_trees_device():
    jt, tt = _trees(8, 5, 3)
    g = torch.from_numpy(jax_gumbel(jax.random.PRNGKey(0), 8, 26)).double()
    got = TM.decide_batch(tt, torch.zeros(8, dtype=torch.bool), gumbel=g)
    assert got.dtype == torch.int32 and got.shape == (8,)
