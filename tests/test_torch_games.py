"""Whole games: the port's play_games against the JAX package's, move for
move, on small seeded float32 nets.

The JAX loop draws, per move, root Dirichlet noise, one D4 symmetry per
round (one per game in evaluation) and the Gumbel draws of its
temperature-1 decisions from its key; ``jax_draws`` makes the same draws
from the same keys and hands them to the port.  Every GameBatch field
must match: integer fields and T exactly, the predicted values and the
policy targets within 1e-5 (the two nets agree to ~1e-6,
tests/test_torch_net.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sejonggo_tpu.actor.selfplay import play_games as j_play_games
from sejonggo_tpu.config import SearchConfig as JSearch
from sejonggo_tpu.nets import AZNet as JNet
from sejonggo_tpu.nets import make_predict_fn as j_make_predict
from sejonggo_torch.actor import play_games
from sejonggo_torch.config import NetConfig, SearchConfig
from sejonggo_torch.nets import (AZNet, from_jax_variables, make_predict_fn,
                                 seeded_flax_variables)
from test_torch_heuristics import one_torch_thread  # noqa: F401

FLOAT_ATOL = 1e-5
FLOAT_FIELDS = ("values", "policy_targets")


def seeded_nets(size, seed, blocks=2, filters=16):
    """(JAX predict(variables, x), variables, port predict(x)) of one
    seeded float32 net."""
    cfg = NetConfig(blocks=blocks, filters=filters, value_hidden=filters,
                    compute_dtype="float32")
    variables = seeded_flax_variables(size, cfg, seed)
    jnet = JNet(size=size, blocks=blocks, filters=filters,
                value_hidden=filters, compute_dtype="float32")
    net = AZNet.from_config(size, cfg)
    net.load_state_dict(from_jax_variables(variables))
    return j_make_predict(jnet), variables, make_predict_fn(net)


def step_draws(sub, search, b, size, selfplay, per_game_symmetry):
    """The draws one JAX move step makes from its key ``sub``."""
    _, r_noise, r_search, r_decide = jax.random.split(sub, 4)
    a = size * size + 1
    out = {}
    if selfplay:
        out["noise"] = torch.from_numpy(np.array(jax.random.dirichlet(
            r_noise, jnp.full((a,), search.dirichlet_alpha, jnp.float32), (b,))))
    if search.use_symmetry:
        syms = []
        for _ in range(search.simulations // search.batch_size):
            r_search, s = jax.random.split(r_search)
            if per_game_symmetry:
                syms.append(torch.from_numpy(
                    np.array(jax.random.randint(s, (b,), 0, 7))))
            else:
                syms.append(int(jax.random.randint(s, (), 0, 7)))
        out["syms"] = syms
    keys = jax.random.split(r_decide, b)
    out["gumbel"] = torch.from_numpy(np.stack(
        [np.asarray(jax.random.gumbel(k, (a,), jnp.float32)) for k in keys]))
    return out


def jax_draws(rng, search, b, size, selfplay, per_game_symmetry):
    """draws(move_n) for play_games: JAX's per-move key chain
    (rng, sub = split(rng) once a move), drawn in move order."""
    state = {"rng": rng, "next": 0}

    def draws(move_n):
        assert move_n == state["next"]
        state["rng"], sub = jax.random.split(state["rng"])
        state["next"] += 1
        return step_draws(sub, search, b, size, selfplay, per_game_symmetry)

    return draws


def assert_games_equal(jg, tg):
    assert jg.actions.shape == tg.actions.shape, "T differs"
    for f in dataclasses.fields(tg):
        j, t = np.asarray(getattr(jg, f.name)), getattr(tg, f.name)
        assert j.shape == t.shape, f.name
        if f.name in FLOAT_FIELDS:
            np.testing.assert_allclose(t, j, atol=FLOAT_ATOL, rtol=0,
                                       err_msg=f.name)
        else:
            assert np.array_equal(j, t), f.name
    assert np.array_equal(jg.value_targets(), tg.value_targets())


def _play_both(size, b, search_kw, *, seed, selfplay, two_nets=False, **kw):
    jpred1, v1, tpred1 = seeded_nets(size, seed)
    jpred2 = v2 = tpred2 = None
    if two_nets:
        jpred2, v2, tpred2 = seeded_nets(size, seed + 1)
    js, ts = JSearch(**search_kw), SearchConfig(**search_kw)
    rng = jax.random.PRNGKey(seed)
    jg = j_play_games(jpred1, jpred2, size=size, komi=5.5, search=js,
                      game_batch=b, rng=rng, variables1=v1, variables2=v2,
                      selfplay=selfplay, **kw)
    tg = play_games(tpred1, tpred2, size=size, komi=5.5, search=ts,
                    game_batch=b, selfplay=selfplay, device="cpu",
                    draws=jax_draws(rng, ts, b, size, selfplay,
                                    per_game_symmetry=not selfplay), **kw)
    assert_games_equal(jg, tg)
    return tg


def test_selfplay_games_with_temperature_one_moves_match_jax():
    """Self-play with root noise, a shared symmetry per round and sampled
    moves until stop_exploration."""
    g = _play_both(9, 4, dict(simulations=16, batch_size=8, use_symmetry=True,
                              dirichlet_alpha=0.15, max_nodes=40),
                   seed=3, selfplay=True, stop_exploration=6, max_moves=10)
    assert g.end_reasons.tolist() == [0, 0, 0, 0]
    assert g.tree_fresh[1:].sum() < g.tree_fresh[1:].size   # trees reused


def test_two_tree_evaluation_games_match_jax():
    """Evaluation: two nets, mixed colours, per-game symmetries, negamax
    backup and visit-count targets; the first two moves sampled."""
    g = _play_both(9, 4, dict(simulations=16, batch_size=8, use_symmetry=True,
                              negamax=True, policy_target="visits",
                              max_nodes=40),
                   seed=5, selfplay=False, two_nets=True, stop_exploration=2,
                   model1_isblack=[True, False, False, True], max_moves=10)
    assert g.model1_isblack.tolist() == [True, False, False, True]


def test_resigning_games_match_jax():
    """Resignation on for three of four games (one threshold above every
    value, so that game resigns at once), 5x5 so that games also end by
    both passing: the lagged end, the resigner, the resign winners and
    the end reasons."""
    g = _play_both(5, 4, dict(simulations=16, batch_size=8, use_symmetry=False,
                              max_nodes=40),
                   seed=7, selfplay=True, stop_exploration=3, max_moves=24,
                   resign_thresholds=[np.nan, 2.0, -0.05, 0.05])
    assert set(g.end_reasons.tolist()) == {1, 2}
    assert g.num_moves[1] == 0


def test_gate_matches_jax():
    """evaluate_models: latest (model 1) against best in two batches,
    colours drawn per game from JAX's keys, the games collected."""
    from sejonggo_tpu.config import EvalConfig as JEval
    from sejonggo_tpu.learn.evaluate import evaluate_models as j_evaluate
    from sejonggo_torch.config import EvalConfig
    from sejonggo_torch.learn import evaluate_models

    size, b = 5, 2
    kw = dict(simulations=16, batch_size=8, use_symmetry=True, max_nodes=40)
    js, ts = JSearch(**kw), SearchConfig(**kw)
    jl, vl, tl = seeded_nets(size, 21)
    jb, vb, tb = seeded_nets(size, 22)
    rng = jax.random.PRNGKey(9)
    common = dict(size=size, komi=5.5, game_batch=b, max_moves=12,
                  collect_games=True)
    want = j_evaluate(jl, jb, search=js, eval_cfg=JEval(num_games=4), rng=rng,
                      variables_latest=vl, variables_best=vb, **common)
    keys = []                     # JAX's (r_color, r_games) of each batch
    r = rng
    for _ in range(2):
        r, r_color, r_games = jax.random.split(r, 3)
        keys.append((r_color, r_games))
    batch_draws = [jax_draws(r_games, ts, b, size, False, True)
                   for _, r_games in keys]
    got = evaluate_models(
        tl, tb, search=ts, eval_cfg=EvalConfig(num_games=4), device="cpu",
        colors=lambda i: np.asarray(jax.random.bernoulli(keys[i][0], 0.5, (b,))),
        draws=lambda i, m: batch_draws[i](m), **common)
    for jg, tg in zip(want.pop("game_batches"), got.pop("game_batches")):
        assert_games_equal(jg, tg)
    assert want == got
