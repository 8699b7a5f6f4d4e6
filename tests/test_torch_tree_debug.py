"""The port's tree introspection (sejonggo_torch.search.tree_debug)
against the JAX package's, on the same searched and re-rooted trees
(the dummy policy, a position-dependent value exact in float32, 9x9,
64 slots): extract_tree, live_nodes, tree_depth,
check_consistency, principal_variation and show_tree give equal results,
and the port's check detects the broken back-pointer and the cycle of
tests/test_tree_debug.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.goenv import engine as JE
from sejonggo_tpu.nets import dummy_predict_fn as j_dummy
from sejonggo_tpu.search import (advance_root_batch as j_advance,
                                 decide_batch as j_decide,
                                 new_tree_batch as j_new, run_search as j_run)
from sejonggo_tpu.search import tree_debug as J
from sejonggo_torch.goenv import engine as TE
from sejonggo_torch.nets import dummy_predict_fn as t_dummy
from sejonggo_torch.search import (advance_root_batch, decide_batch,
                                   new_tree_batch, run_search)
from sejonggo_torch.search import tree_debug as T
from test_torch_heuristics import one_torch_thread  # noqa: F401

SIZE, CAP, B = 9, 64, 3


def j_pred(boards):
    """The dummy policy with a value that depends on the position and is
    exact in float32 in both frameworks (quarters of small integers)."""
    p, _ = j_dummy(boards)
    d = boards[..., 0].sum((1, 2)) - boards[..., 1].sum((1, 2))
    return p, (0.25 * d - 0.5).astype(jnp.float32)[:, None]


def t_pred(boards):
    p, _ = t_dummy(boards)
    d = boards[..., 0].sum((1, 2)) - boards[..., 1].sum((1, 2))
    return p, (0.25 * d - 0.5).to(torch.float32)[:, None]


@pytest.fixture(scope="module")
def trees():
    """(JAX, port) pairs: searched trees, then re-rooted at the greedy
    move with the search's reserve."""
    jb = jnp.stack([JE.init_board(SIZE)] * B)
    tb = TE.init_board(SIZE, batch=B, device="cpu")
    jt = j_new(j_dummy(jb)[0], jb, CAP)
    tt = new_tree_batch(t_dummy(tb)[0], tb, CAP)
    jt = jax.jit(lambda t, r: j_run(t, j_pred, r, simulations=24,
                                    batch_size=8))(jt, jax.random.PRNGKey(0))
    tt = run_search(tt, t_pred, simulations=24, batch_size=8)
    greedy = np.ones(B, bool)
    ja = j_decide(jt, jnp.asarray(greedy), jax.random.PRNGKey(1))
    ta = decide_batch(tt, torch.from_numpy(greedy))
    assert np.array_equal(np.asarray(ja), ta.numpy())
    jt2, jv = j_advance(jt, ja, jax.vmap(JE.step)(jb, ja), reserve=24)
    tt2, tv = advance_root_batch(tt, ta, TE.step_batch(tb, ta), reserve=24)
    assert np.array_equal(np.asarray(jv), tv.numpy()) and tv.all()
    return [(jt, tt), (jt2, tt2)]


@pytest.mark.parametrize("which", [0, 1], ids=["searched", "rerooted"])
def test_tree_debug_matches_jax(trees, which):
    jt, tt = trees[which]
    for g in range(B):
        jh, th = J.extract_tree(jt, g), T.extract_tree(tt, g)
        for f in T.HostTree._fields:
            assert np.array_equal(np.asarray(getattr(jh, f)),
                                  np.asarray(getattr(th, f))), f
            assert type(getattr(th, f)) is type(getattr(jh, f)) or \
                isinstance(getattr(th, f), np.ndarray), f
        assert T.check_consistency(th) == J.check_consistency(jh) == []
        assert T.live_nodes(th) == J.live_nodes(jh)
        assert T.node_depths(th) == J.node_depths(jh)
        assert T.tree_depth(th) == J.tree_depth(jh) >= 1 - which
        assert T.principal_variation(th, SIZE) == J.principal_variation(jh, SIZE)
        for depth, k in ((2, 5), (3, 2)):
            assert T.show_tree(th, SIZE, depth, k) == J.show_tree(jh, SIZE, depth, k)
    assert max(T.extract_tree(tt, g).n_nodes for g in range(B)) > 1
    # a tree without the batch axis, as extract_tree(trees) takes it
    one = type(tt)(**{f.name: getattr(tt, f.name)[0]
                      for f in dataclasses.fields(tt)})
    assert T.show_tree(T.extract_tree(one), SIZE) == \
        T.show_tree(T.extract_tree(tt, 0), SIZE)


def test_detects_broken_backpointer_and_cycle(trees):
    t = T.extract_tree(trees[0][1], 0)
    live = [n for n in T.live_nodes(t) if n != 0]
    child = live[0]
    t_bad = t._replace(parent=t.parent.copy())
    t_bad.parent[child] = child
    problems = T.check_consistency(t_bad)
    assert any("backpointer" in p for p in problems)
    assert problems == J.check_consistency(t_bad)
    p, a = int(t.parent[child]), int(t.parent_action[child])
    t_cyc = t._replace(child_idx=t.child_idx.copy())
    t_cyc.child_idx[p, a] = 0
    problems = T.check_consistency(t_cyc)
    assert any("acyclicity" in m or "out of range" in m for m in problems)
    assert problems == J.check_consistency(t_cyc)
