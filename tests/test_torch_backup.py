"""The port's backup with a real net against the JAX search.

The dummy net's value is 1, so every value sum of tests/test_torch_mcts.py
is an integer and exact in any order.  Here a small seeded float32 AZNet
gives values that are not integers: the port's net and flax's agree to
~1e-6 (tests/test_torch_net.py), and the two backups add in other orders,
so child_W and root_W are held within ATOL_W of JAX, while every integer
field (child_N, the tree's shape) and every chosen move must be exact.
Each greedy decision's margin, the gap in (count, mean value) between the
chosen move and the runner-up, is asserted to exceed the tolerance, so a
near tie cannot pass or fail by chance.

The backup must not read anything back to the host: its trip count does
not depend on the tree's depth."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.nets import AZNet as JNet
from sejonggo_tpu.nets import make_predict_fn as j_make_predict
from sejonggo_tpu.search import mcts as JM
from sejonggo_tpu.search import tree as JT
from sejonggo_torch.config import NetConfig
from sejonggo_torch.goenv.positions import choose_actions
from sejonggo_torch.nets import (AZNet, from_jax_variables, make_predict_fn,
                                 seeded_flax_variables)
from sejonggo_torch.search import mcts as TM
from sejonggo_torch.search import tree as TT
from test_torch_heuristics import one_torch_thread  # noqa: F401

ATOL_W = 1e-4   # value sums of up to 64 net values, each within ~1e-6
NET = NetConfig(blocks=2, filters=16, value_hidden=16, compute_dtype="float32")


def nets(seed, size=9):
    """(JAX predict, port predict) of one seeded float32 net."""
    variables = seeded_flax_variables(size, NET, seed)
    jnet = JNet(size=size, blocks=NET.blocks, filters=NET.filters,
                value_hidden=NET.value_hidden, compute_dtype="float32")
    jpred = partial(j_make_predict(jnet), variables)
    net = AZNet.from_config(size, NET)
    net.load_state_dict(from_jax_variables(variables))
    return jpred, make_predict_fn(net)


def root_boards(size, b, moves, seed):
    """(B, N, N, 17) boards a few random moves into a game."""
    from sejonggo_tpu.goenv import engine as JE

    rng = np.random.RandomState(seed)
    boards = jnp.stack([JE.init_board(size)] * b)
    for _ in range(moves):
        ill = np.asarray(jax.jit(JE.illegal_moves_mask_batch)(boards))
        occ = (np.asarray(boards)[..., 0] == 1) | (np.asarray(boards)[..., 1] == 1)
        boards = jax.jit(JE.step_batch)(
            boards, jnp.asarray(choose_actions(rng, ill, occ, 0.5, 0.0)))
    return np.array(boards)


def greedy_margin(child_n, child_w, legal):
    """Per tree: the (count, mean) gap between the best legal action and
    the runner-up: (count gap, mean gap where the counts tie, else inf)."""
    out = []
    for n, w, ok in zip(child_n, child_w, legal):
        keys = sorted(((int(c), (float(s) / c) if c else 0.0)
                       for c, s, g in zip(n, w, ok) if g), reverse=True)
        (c1, m1), (c2, m2) = keys[0], keys[1]
        out.append((c1 - c2, abs(m1 - m2) if c1 == c2 else np.inf))
    return out


@pytest.mark.parametrize("negamax", [False, True])
@pytest.mark.parametrize("sims,k,cap,moves", [(32, 8, 48, 4), (64, 16, 100, 9)])
def test_real_net_search_matches_jax(negamax, sims, k, cap, moves):
    jpred, tpred = nets(seed=sims + moves)
    boards = root_boards(9, 4, moves, seed=cap)
    pol, _ = jax.jit(jpred)(jnp.asarray(boards, jnp.float32))
    jt = JT.new_tree_batch(pol, jnp.asarray(boards), cap)
    tt = TT.new_tree_batch(torch.from_numpy(np.array(pol)),
                           torch.from_numpy(boards), cap)
    jt = jax.jit(lambda t: JM.run_search(
        t, jpred, jax.random.PRNGKey(0), simulations=sims, batch_size=k,
        negamax=negamax))(jt)
    tt = TM.run_search(tt, tpred, simulations=sims, batch_size=k,
                       negamax=negamax)
    for f in dataclasses.fields(tt):
        j = np.asarray(getattr(jt, f.name))
        t = getattr(tt, f.name).numpy()
        if f.name in ("child_W", "root_W"):
            np.testing.assert_allclose(t, j, atol=ATOL_W, rtol=0, err_msg=f.name)
        elif f.name == "node_P":
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
        else:
            assert np.array_equal(j, t), f.name
    # the sums really are non-integer floats
    assert (np.abs(np.asarray(jt.child_W) % 1) > 1e-3).any()

    greedy = jnp.ones((4,), bool)
    want = np.asarray(JM.decide_batch(jt, greedy, jax.random.PRNGKey(1)))
    got = TM.decide_batch(tt, torch.ones(4, dtype=torch.bool)).numpy()
    assert np.array_equal(want, got)
    for c_gap, m_gap in greedy_margin(np.asarray(jt.child_N)[:, 0],
                                      np.asarray(jt.child_W)[:, 0],
                                      np.asarray(jt.node_legal)[:, 0]):
        assert c_gap > 0 or m_gap > 2 * ATOL_W


class NoHostReads(torch.overrides.TorchFunctionMode):
    """Fails on any call that copies a tensor's value to the host."""

    READS = (torch.Tensor.__bool__, torch.Tensor.item, torch.Tensor.tolist,
             torch.Tensor.__int__, torch.Tensor.__float__, torch.equal)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("slot_base", [None, 16])
def test_backup_reads_nothing_back_to_the_host(slot_base):
    """The backup's trip count is fixed by the shapes: no per-level check
    of whether a leaf is still climbing (a host sync on the card)."""
    jpred, tpred = nets(seed=1)
    boards = root_boards(9, 3, 5, seed=2)
    pol, _ = tpred(torch.from_numpy(boards))
    tree = TT.new_tree_batch(pol, torch.from_numpy(boards), 48)
    for r in range(3):
        leaf_p, leaf_a, active = TM.collect_leaves(tree, 8, 1.0)
        b, k = leaf_p.shape
        ps = TM._rows(tree.node_stones, leaf_p)
        side = TM._rows(tree.node_side, leaf_p)
        stones, illegal = TM.engine.step_and_illegal_stones_batch(
            ps.reshape(b * k, 9, 9), side.reshape(-1), leaf_a.reshape(-1))
        feats = TM.leaf_features(tree, leaf_p, stones.reshape(b, k, 9, 9), -side)
        policies, values = tpred(feats.reshape(b * k, 9, 9, 17))
        with NoHostReads():
            tree = TM.expand_backup(
                tree, leaf_p, leaf_a, stones.reshape(b, k, 9, 9), -side,
                active, policies.reshape(b, k, -1), values.reshape(b, k),
                (~illegal).reshape(b, k, -1), negamax=True,
                slot_base=None if slot_base is None else slot_base + r * k)
    assert int(tree.root_N.min()) == 24
