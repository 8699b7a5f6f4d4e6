"""The port's self-play move step (sejonggo_torch.actor) against the JAX
move step, with the deterministic dummy net.

Greedy games are compared move for move: actions, boards, every record
and every Tree field.  Where the JAX step draws root Dirichlet noise and
D4 symmetries from its key, the test draws the same values from the same
key with jax.random and hands them to the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sejonggo_tpu.actor.selfplay import _make_move_step
from sejonggo_tpu.config import SearchConfig as JSearch
from sejonggo_tpu.goenv import engine as JE
from sejonggo_tpu.nets import dummy_actor_fn
from sejonggo_tpu.search import new_tree_batch as j_new_tree
from sejonggo_torch.actor import init_state, make_move_step
from sejonggo_torch.config import SearchConfig
from sejonggo_torch.nets import dummy_predict_fn
from test_torch_heuristics import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _jax_state(b, size, cap):
    boards = jnp.stack([JE.init_board(size)] * b)
    trees = j_new_tree(jnp.zeros((b, size * size + 1), jnp.float32), boards, cap)
    zeros = jnp.zeros((b,), bool)
    return (jnp.array(boards, copy=True), trees, zeros, None, None,
            jnp.zeros((b,), bool), jnp.zeros((b,), bool), jnp.ones((b,), bool))


def _jax_draws(key, search, b, size, selfplay):
    """The noise and per-round symmetries the JAX move step draws."""
    _, r_noise, r_search, _ = jax.random.split(key, 4)
    a = size * size + 1
    noise = jax.random.dirichlet(
        r_noise, jnp.full((a,), search.dirichlet_alpha, jnp.float32), (b,))
    syms = []
    for _ in range(search.simulations // search.batch_size):
        r_search, sub = jax.random.split(r_search)
        if selfplay:
            syms.append(int(jax.random.randint(sub, (), 0, 7)))
        else:
            syms.append(torch.from_numpy(
                np.array(jax.random.randint(sub, (b,), 0, 7))))
    return torch.from_numpy(np.array(noise)), syms


def _close(j, t, what):
    """Priors with root noise: the port mixes them bit-exactly
    (tests/test_torch_reroot.py), but the noise handed to it here comes
    from a separate eager JAX draw, whose float32 gamma arithmetic may
    differ in the last bit from the draw fused into the jitted step."""
    np.testing.assert_allclose(np.asarray(j), np.asarray(t), rtol=1e-6,
                               atol=0, err_msg=str(what))


def _compare(jstate, jrec, tstate, trec, move):
    jb, jtrees, jvalid, _, _, jdone, jskip, _ = jstate
    assert np.array_equal(np.asarray(jrec["actions"]), trec["actions"].numpy()), \
        f"actions differ at move {move}"
    for key in ("stones", "values", "players", "move_valid", "tree_fresh"):
        assert np.array_equal(np.asarray(jrec[key]), trec[key].numpy()), (move, key)
    _close(jrec["policy_targets"], trec["policy_targets"], (move, "policy_targets"))
    assert np.array_equal(np.asarray(jb), tstate.boards.numpy()), move
    assert np.array_equal(np.asarray(jvalid), tstate.valid.numpy()), move
    assert np.array_equal(np.asarray(jdone), tstate.done.numpy()), move
    assert np.array_equal(np.asarray(jskip), tstate.skipped_last.numpy()), move
    # trees with valid False are never read again (the next move builds
    # fresh ones), so only the reusable trees are compared here; the
    # re-root of every tree, valid or not, is held exact against JAX in
    # tests/test_torch_reroot.py
    keep = np.asarray(jvalid)
    for f in dataclasses.fields(tstate.trees):
        j = np.asarray(getattr(jtrees, f.name))[keep]
        t = getattr(tstate.trees, f.name).numpy()[keep]
        if f.name == "node_P":
            _close(j, t, (move, f.name))
        else:
            assert np.array_equal(j, t), (move, f.name)


def _play(size, b, search_kw, selfplay, moves, thresholds, seed=0,
          stop_early=True):
    js = JSearch(**search_kw)
    ts = SearchConfig(**search_kw)
    jstep = _make_move_step(dummy_actor_fn, None, js, size, selfplay)
    tstep = make_move_step(dummy_predict_fn, ts, size, selfplay=selfplay)
    jstate = _jax_state(b, size, js.capacity())
    tstate = init_state(b, size, ts, device=CPU)
    greedy = np.ones((b,), bool)
    thr = np.asarray(thresholds, np.float32)
    key = jax.random.PRNGKey(seed)
    played = 0
    for move in range(moves):
        key, sub = jax.random.split(key)
        noise, syms = _jax_draws(sub, js, b, size, selfplay)
        jstate, jrec, _ = jstep(jstate, sub, jnp.asarray(greedy),
                                jnp.asarray(thr), None, None)
        tstate, trec, _ = tstep(tstate, torch.from_numpy(greedy),
                                torch.from_numpy(thr), noise=noise,
                                syms=syms if ts.use_symmetry else None)
        _compare(jstate, jrec, tstate, trec, move)
        played += 1
        if stop_early and bool(tstate.done.all()):
            break
    return tstate, played


def test_whole_greedy_games_match_jax():
    """5x5 evaluation-mode games (no noise, no symmetry) to the end: the
    both-pass end, a resigning game (threshold above the dummy value 1)
    and the move cap."""
    state, played = _play(
        5, 4, dict(simulations=16, batch_size=8, use_symmetry=False),
        selfplay=False, moves=50, thresholds=[np.nan, np.nan, 2.0, np.nan])
    assert bool(state.done[2])
    assert played >= 10


def test_selfplay_noise_and_symmetry_match_jax():
    """9x9 self-play mode: root Dirichlet noise and one D4 symmetry per
    round, as the JAX step draws them."""
    _play(9, 3, dict(simulations=16, batch_size=8, use_symmetry=True,
                     dirichlet_alpha=0.15, max_nodes=40),
          selfplay=True, moves=8, thresholds=[np.nan] * 3, seed=3)


def test_eval_mode_per_game_symmetry_matches_jax():
    _play(9, 3, dict(simulations=16, batch_size=8, use_symmetry=True,
                     negamax=True, policy_target="visits"),
          selfplay=False, moves=6, thresholds=[np.nan] * 3, seed=4)


def test_bench_shape_move_steps_match_jax():
    """The bench point's search shape (64 sims, 32 leaves a round, 82
    slots, symmetry) at a small batch."""
    _play(9, 2, dict(simulations=64, batch_size=32, use_symmetry=True,
                     max_nodes=82),
          selfplay=True, moves=5, thresholds=[np.nan] * 2, seed=5)


def test_sampled_moves_are_legal():
    ts = SearchConfig(simulations=16, batch_size=8, use_symmetry=True,
                      max_nodes=40)
    step = make_move_step(dummy_predict_fn, ts, 9)
    state = init_state(4, 9, ts, device=CPU)
    g = torch.Generator().manual_seed(0)
    from sejonggo_torch.goenv import engine
    for _ in range(6):
        illegal = engine.illegal_moves_mask_batch(state.boards)
        state, rec, _ = step(state, torch.zeros(4, dtype=torch.bool),
                             torch.full((4,), float("nan")), generator=g)
        assert not illegal.gather(1, rec["actions"].long()[:, None]).any()
