"""The port's tree and MCTS (sejonggo_torch.search) against the JAX
search, with the deterministic dummy net (values 1, so every value sum
is an integer and exact in any summation order).

Every Tree field must be equal after new_tree_batch, simulate_round,
run_search and advance_root_batch, at the bench capacity C=82, at C=256
and at C=600, where the JAX search takes its while-loop descent,
loop backup and pointer-doubling re-root paths (capacities above 512)."""
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
from sejonggo_torch.nets import dummy_predict_fn as t_dummy
from sejonggo_torch.search import mcts as TM
from sejonggo_torch.search import tree as TT


def _root_boards(size, b, moves, seed):
    """(B, N, N, 17) boards a few random moves into a game (JAX engine)."""
    rng = np.random.RandomState(seed)
    boards = jnp.stack([JE.init_board(size)] * b)
    step = jax.jit(JE.step_batch)
    illegal = jax.jit(JE.illegal_moves_mask_batch)
    for _ in range(moves):
        ill = np.asarray(illegal(boards))
        occ = (np.asarray(boards)[..., 0] == 1) | (np.asarray(boards)[..., 1] == 1)
        boards = step(boards, jnp.asarray(choose_actions(rng, ill, occ, 0.5, 0.0)))
    return np.array(boards)


def assert_trees_equal(jtree, ttree, what=""):
    for f in dataclasses.fields(ttree):
        j = np.asarray(getattr(jtree, f.name))
        t = getattr(ttree, f.name).numpy()
        assert j.shape == t.shape, (what, f.name, j.shape, t.shape)
        assert np.array_equal(j, t), f"{what}: Tree.{f.name} differs"


def _fresh(boards, cap):
    b = boards.shape[0]
    pol, _ = j_dummy(jnp.asarray(boards, jnp.float32))
    jtree = JT.new_tree_batch(pol, jnp.asarray(boards), cap)
    ttree = TT.new_tree_batch(torch.from_numpy(np.array(pol)),
                              torch.from_numpy(boards), cap)
    assert_trees_equal(jtree, ttree, f"new_tree_batch b={b} cap={cap}")
    return jtree, ttree


@pytest.mark.parametrize("cap,k,moves", [(82, 32, 0), (40, 8, 6), (600, 16, 9)])
def test_simulate_round_matches_jax(cap, k, moves):
    boards = _root_boards(9, 3, moves, cap)
    jtree, ttree = _fresh(boards, cap)
    jround = jax.jit(partial(JM.simulate_round, predict_fn=j_dummy,
                             batch_size=k))
    rng = jax.random.PRNGKey(0)
    for r in range(min(3, (cap - 1) // k)):   # without slot_base the
        jtree = jround(jtree, rng=rng)         # nodes go at n_nodes
        ttree = TM.simulate_round(ttree, t_dummy, batch_size=k)
        assert_trees_equal(jtree, ttree, f"round {r}")


@pytest.mark.parametrize("negamax", [False, True])
@pytest.mark.parametrize("per_game", [False, True])
def test_simulate_round_symmetry_matches_jax(negamax, per_game):
    """The D4 symmetry the JAX round draws from its key is handed to the
    port; the dummy policy is not symmetric, so a wrong transform or a
    wrong inverse changes the priors."""
    boards = _root_boards(9, 4, 5, 11)
    jtree, ttree = _fresh(boards, 64)
    jround = jax.jit(partial(JM.simulate_round, predict_fn=j_dummy,
                             batch_size=8, negamax=negamax,
                             use_symmetry=True, per_game_symmetry=per_game))
    for r in range(3):
        rng = jax.random.PRNGKey(100 + r)
        if per_game:
            sym = torch.from_numpy(np.array(jax.random.randint(rng, (4,), 0, 7)))
        else:
            sym = int(jax.random.randint(rng, (), 0, 7))
        jtree = jround(jtree, rng=rng)
        ttree = TM.simulate_round(ttree, t_dummy, batch_size=8,
                                  negamax=negamax, sym=sym)
        assert_trees_equal(jtree, ttree, f"round {r} sym={sym}")


@pytest.mark.parametrize("cap,sims,k,b", [(82, 64, 32, 4), (256, 192, 32, 2),
                                          (600, 100, 20, 2)])
def test_search_and_reroot_match_jax(cap, sims, k, b):
    """run_search, decide, the policy targets and advance_root for two
    moves (the second search reuses the re-rooted subtree)."""
    boards = _root_boards(9, b, 4, sims)
    jtree, ttree = _fresh(boards, cap)
    jsearch = jax.jit(partial(JM.run_search, predict_fn=j_dummy,
                              simulations=sims, batch_size=k))
    jdecide = jax.jit(JM.decide_batch)
    jadv = jax.jit(partial(JM.advance_root_batch, reserve=sims))
    jstep = jax.jit(JE.step_batch)
    greedy = np.ones((b,), bool)
    for move in range(2):
        jtree = jsearch(jtree, rng=jax.random.PRNGKey(move))
        ttree = TM.run_search(ttree, t_dummy, simulations=sims, batch_size=k)
        assert_trees_equal(jtree, ttree, f"search move {move}")
        ja = jdecide(jtree, jnp.asarray(greedy), jax.random.PRNGKey(1))
        ta = TM.decide_batch(ttree, torch.from_numpy(greedy))
        assert np.array_equal(np.asarray(ja), ta.numpy())
        for mode in ("prior", "visits"):
            assert np.array_equal(
                np.asarray(JM.policy_target_batch(jtree, mode)),
                TM.policy_target_batch(ttree, mode).numpy())
        jb = jstep(jnp.asarray(boards), ja)
        boards = np.array(jb)
        jtree, jvalid = jadv(jtree, ja, jb)
        ttree, tvalid = TM.advance_root_batch(ttree, ta, torch.from_numpy(boards),
                                              reserve=sims)
        assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
        assert_trees_equal(jtree, ttree, f"advance move {move}")


def test_collect_leaves_and_features_match_jax():
    boards = _root_boards(9, 3, 12, 5)
    jtree, ttree = _fresh(boards, 120)
    jround = jax.jit(partial(JM.simulate_round, predict_fn=j_dummy, batch_size=6))
    for _ in range(4):
        jtree = jround(jtree, rng=jax.random.PRNGKey(0))
        ttree = TM.simulate_round(ttree, t_dummy, batch_size=6)
    jp, ja, jact = jax.vmap(partial(JM._collect_leaves, k=10, c_puct=1.0))(jtree)
    tp, ta, tact = TM.collect_leaves(ttree, 10, 1.0)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jact), tact.numpy())
    stones = np.asarray(jtree.node_stones)[np.arange(3)[:, None], np.asarray(jp)]
    side = -np.asarray(jtree.node_side)[np.arange(3)[:, None], np.asarray(jp)]
    for sym in (None, 3):
        jf = JM.leaf_features(jtree, jp, jnp.asarray(stones), jnp.asarray(side),
                              sym=None if sym is None else jnp.asarray(sym))
        tf = TM.leaf_features(ttree, tp, torch.from_numpy(stones),
                              torch.from_numpy(side), sym=sym)
        assert np.array_equal(np.asarray(jf), tf.numpy())


def test_decide_ties_and_sampling():
    boards = _root_boards(9, 2, 0, 0)
    _, ttree = _fresh(boards, 16)
    cn = torch.zeros_like(ttree.child_N)
    cn[:, 0, 3] = 5
    cn[:, 0, 7] = 5
    cw = torch.zeros_like(ttree.child_W)
    cw[0, 0, 3] = 2.0            # game 0: mean value decides -> 3
    ttree = ttree.replace(child_N=cn, child_W=cw)
    greedy = TM.decide_batch(ttree, torch.ones(2, dtype=torch.bool))
    assert greedy.tolist() == [3, 7]   # game 1: a full tie -> larger action
    g = torch.Generator().manual_seed(0)
    sampled = TM.decide_batch(ttree, torch.zeros(2, dtype=torch.bool), g)
    assert set(sampled.tolist()) <= {3, 7}


@pytest.mark.parametrize("alpha", [0.03, 0.15, 2.0])
def test_dirichlet_sampler(alpha):
    g = torch.Generator().manual_seed(1)
    x = TT.sample_dirichlet(alpha, 4000, 82, g)
    assert torch.isfinite(x).all() and (x >= 0).all()
    assert torch.allclose(x.sum(-1), torch.ones(4000), atol=1e-5)
    # E[x_i] = 1/82; the mean over 4000 rows is within a few sigma of it
    assert abs(float(x.mean(0).mean()) - 1 / 82) < 1e-6
    var = alpha * (82 * alpha - alpha) / ((82 * alpha) ** 2 * (82 * alpha + 1))
    assert abs(float(x[:, 0].mean()) - 1 / 82) < 6 * (var / 4000) ** 0.5
