"""Re-rooting and root noise of the port (sejonggo_torch.search) against
the JAX package, on every tree: also the trees whose chosen child was
never expanded (valid False), which the move step discards.

In such a re-root the old root stays the root and every slot survives,
also the slots of inactive leaves, whose parent action is -1.  JAX's
index normalisation puts them on the last edge, the pass, where the
highest slot wins; the port must give the same child_idx.  The noisy
root priors must be bit-exact: XLA rounds the noise mix once."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.goenv import engine as JE
from sejonggo_tpu.nets import dummy_predict_fn as j_dummy
from sejonggo_tpu.search import mcts as JM
from sejonggo_tpu.search import tree as JT
from sejonggo_torch.goenv.positions import choose_actions
from sejonggo_torch.search import mcts as TM
from sejonggo_torch.search import tree as TT


def _boards(size, b, moves, seed):
    rng = np.random.RandomState(seed)
    boards = jnp.stack([JE.init_board(size)] * b)
    step = jax.jit(JE.step_batch)
    illegal = jax.jit(JE.illegal_moves_mask_batch)
    for _ in range(moves):
        ill = np.asarray(illegal(boards))
        occ = (np.asarray(boards)[..., 0] == 1) | (np.asarray(boards)[..., 1] == 1)
        boards = step(boards, jnp.asarray(choose_actions(rng, ill, occ, 0.5, 0.0)))
    return boards


def _to_torch(jtree):
    return TT.Tree(**{f.name: torch.from_numpy(np.array(getattr(jtree, f.name)))
                      for f in dataclasses.fields(TT.Tree)})


def _assert_equal(jtree, ttree, what):
    for f in dataclasses.fields(ttree):
        j = np.asarray(getattr(jtree, f.name))
        t = getattr(ttree, f.name).numpy()
        assert j.shape == t.shape, (what, f.name)
        assert np.array_equal(j, t), f"{what}: Tree.{f.name} differs"


def _searched(size, b, moves, cap, sims, k, seed):
    boards = _boards(size, b, moves, seed)
    pol, _ = j_dummy(jnp.asarray(boards, jnp.float32))
    jtree = JT.new_tree_batch(pol, boards, cap)
    jtree = jax.jit(partial(JM.run_search, predict_fn=j_dummy,
                            simulations=sims, batch_size=k))(
        jtree, rng=jax.random.PRNGKey(seed))
    return boards, jtree


def _advance_both(jtree, boards, actions, reserve):
    actions = np.asarray(actions, np.int32)
    jb = jax.jit(JE.step_batch)(boards, jnp.asarray(
        np.minimum(actions, boards.shape[1] ** 2)))
    jout, jvalid = jax.jit(partial(JM.advance_root_batch, reserve=reserve))(
        jtree, jnp.asarray(actions), jb)
    tout, tvalid = TM.advance_root_batch(
        _to_torch(jtree), torch.from_numpy(actions),
        torch.from_numpy(np.array(jb)), reserve=reserve)
    assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
    _assert_equal(jout, tout, "advance_root_batch")
    return jout, np.asarray(jvalid)


@pytest.mark.parametrize("size,cap,sims,k,reserve", [
    (9, 82, 64, 32, 64), (9, 40, 16, 8, 0), (7, 120, 24, 8, 24)])
def test_reroot_every_tree_matches_jax(size, cap, sims, k, reserve):
    """Per tree one of: an expanded child (valid), an unexpanded legal
    child and an occupied point (both invalid: the old root stays)."""
    b = 6
    boards, jtree = _searched(size, b, 6, cap, sims, k, cap + k)
    ci = np.asarray(jtree.child_idx)[:, 0]
    legal = np.asarray(jtree.node_legal)[:, 0]
    occupied = (np.asarray(boards)[..., 0] == 1) | (np.asarray(boards)[..., 1] == 1)
    actions = []
    for i in range(b):
        expanded = np.flatnonzero(ci[i] >= 0)
        unexpanded = np.flatnonzero((ci[i] < 0) & legal[i])
        taken = np.flatnonzero(occupied[i].reshape(-1))
        pick = [expanded, unexpanded, taken][i % 3]
        assert len(pick), (i, "no action of the wanted kind")
        actions.append(pick[len(pick) // 2])
    _, valid = _advance_both(jtree, boards, actions, reserve)
    assert valid.tolist() == [i % 3 == 0 for i in range(b)]


def test_reroot_inactive_slots_collide_with_the_pass_child():
    """5x5, three moves in, with 26 leaves in one round: every legal
    root child, the pass among them, is expanded and a leaf slot for
    each occupied point stays inactive (action -1).  Re-rooting at an
    occupied point keeps them all; their edge is the pass edge, where
    the highest slot wins, as in JAX."""
    size, b, k = 5, 3, 26
    boards = _boards(size, b, 3, 0)
    pol, _ = j_dummy(jnp.asarray(boards, jnp.float32))
    jtree = JT.new_tree_batch(pol, boards, 2 * k + 2)
    jtree = jax.jit(partial(JM.simulate_round, predict_fn=j_dummy,
                            batch_size=k))(jtree, rng=jax.random.PRNGKey(0))
    pa = np.asarray(jtree.parent_action)
    n = np.asarray(jtree.n_nodes)
    pass_a = size * size
    assert (np.asarray(jtree.child_idx)[:, 0, pass_a] >= 0).all()
    inactive = [np.flatnonzero(pa[i, 1:n[i]] < 0) + 1 for i in range(b)]
    assert all(len(s) > 0 for s in inactive)
    stones = (np.asarray(boards)[..., 0] == 1) | (np.asarray(boards)[..., 1] == 1)
    occupied = stones.reshape(b, -1).argmax(1)
    jout, valid = _advance_both(jtree, boards, occupied, reserve=0)
    assert not valid.any()
    # the unallocated slots (parent 0, action -1) survive too, so the
    # highest slot of the tree holds the pass edge
    got = np.asarray(jout.child_idx)[:, 0, pass_a]
    assert got.tolist() == [int(np.flatnonzero(pa[i] < 0).max())
                            for i in range(b)]


@pytest.mark.parametrize("alpha", [0.03, 0.15, 2.0])
def test_noisy_root_priors_bit_exact(alpha):
    """new_tree_batch with root noise: every field, the priors included,
    bit-exact against JAX's fresh tree with the same noise (the body of
    its new_tree_batch, which draws the noise inside the same program)."""
    b, size, cap = 64, 9, 16
    a = size * size + 1
    boards = _boards(size, b, 3, 1)
    logits = np.random.RandomState(2).randn(b, a).astype(np.float32) * 2
    pol = jax.nn.softmax(jnp.asarray(logits), -1)
    key = jax.random.PRNGKey(7)
    noise = jax.jit(lambda k: jax.random.dirichlet(
        k, jnp.full((a,), alpha, jnp.float32), (b,)))(key)
    legal = ~JE.illegal_moves_mask_batch(boards)
    jtree = jax.jit(jax.vmap(lambda p, bd, lg, nz: JT._new_tree(
        p, bd, lg, cap, nz, 0.25)))(pol, boards, legal, noise)
    ttree = TT.new_tree_batch(torch.from_numpy(np.array(pol)),
                              torch.from_numpy(np.array(boards)), cap,
                              noise=torch.from_numpy(np.array(noise)))
    _assert_equal(jtree, ttree, f"new_tree_batch alpha={alpha}")


def test_noise_mix_ties_round_like_jax():
    """Priors p where 0.75 * p lies halfway between two float32 values,
    with noise far below its last bit: rounding twice (or in float64)
    resolves the tie to even, one rounding follows the noise."""
    p = np.float32(1.0) + np.float32(2.0 ** -23) * np.arange(1, 9, dtype=np.float32)
    p = (p * np.float32(2.0 ** -6)).astype(np.float32)
    noise = np.asarray([1e-30, 0, 1e-20, 3e-12] * 2, np.float32)
    ref = jax.jit(lambda p, n: 0.75 * p + 0.25 * n)(jnp.asarray(p), jnp.asarray(noise))
    got = TT.mix_noise(torch.from_numpy(p), torch.from_numpy(noise), 0.25)
    assert np.array_equal(np.asarray(ref), got.numpy())
    twice = (np.float32(0.75) * p + np.float32(0.25) * noise).astype(np.float32)
    assert not np.array_equal(twice, got.numpy())
