"""The port's learning properties, after tests/test_slow_learning.py, each
held against the JAX package on the same inputs.

- MCTS recovers from a poisoned policy that puts ~all mass on a suicide
  move: the port's search and decision equal JAX's (the decision and
  every root visit count), and the illegal move gets no visit.
- (slow) The net and trainer learn to prefer pass on a board covered by
  the mover's colour: the port and JAX train from the same initial
  variables on the same numpy batches, and both must reach the property.
- (slow) Generations of the port's closed loop at the JAX test's
  configuration promote at least twice, and the end-state best beats
  model_1 in a 48-game duel.  The two loops' random draws differ (torch
  and jax.random), so their trajectories differ; the bar is JAX's.

Run with: python -m pytest tests/test_torch_learning.py -m slow -q
(the poisoned-policy test is fast and always runs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu import config as jcfg
from sejonggo_torch import config as tcfg
from sejonggo_torch.tools.calibrate_slow_loop import make_config

from test_torch_heuristics import one_torch_thread  # noqa: F401

SIZE = 9
A = SIZE * SIZE + 1


def poisoned_board():
    """Action 0 (the corner) is suicide for the mover: opponent stones at
    (1, 0) and (0, 1) with outside liberties."""
    b = np.zeros((SIZE, SIZE, 17), np.int8)
    b[:, :, 16] = 1
    b[0, 1, 1] = 1
    b[1, 0, 1] = 1
    return b


def test_mcts_recovers_from_poisoned_policy():
    from sejonggo_tpu.goenv import engine as jengine
    from sejonggo_tpu.search import decide_batch as j_decide
    from sejonggo_tpu.search import new_tree_batch as j_new_tree
    from sejonggo_tpu.search import run_search as j_run_search
    from sejonggo_torch.goenv import engine
    from sejonggo_torch.search import (decide_batch, new_tree_batch,
                                       run_search)

    b = poisoned_board()
    search = tcfg.SearchConfig(simulations=32, batch_size=8,
                               use_symmetry=False)

    def j_poisoned(feats):
        pol = jnp.full((feats.shape[0], A), 1e-6, jnp.float32).at[:, 0].set(
            0.999)
        pol = pol / jnp.sum(pol, -1, keepdims=True)
        return pol, jnp.zeros((feats.shape[0], 1), jnp.float32)

    board = jnp.asarray(b)
    assert np.asarray(jengine.illegal_moves_mask(board))[0]
    trees = j_new_tree(j_poisoned(board[None].astype(jnp.float32))[0],
                       board[None], search.capacity())
    trees = jax.jit(lambda t: j_run_search(
        t, j_poisoned, jax.random.PRNGKey(0), simulations=32,
        batch_size=8))(trees)
    j_action = int(j_decide(trees, jnp.asarray([True]),
                            jax.random.PRNGKey(1))[0])
    j_counts = np.asarray(trees.child_N[0, 0])

    def poisoned(feats):
        pol = torch.full((feats.shape[0], A), 1e-6, dtype=torch.float32)
        pol[:, 0] = 0.999
        pol = pol / pol.sum(-1, keepdim=True)
        return pol, torch.zeros((feats.shape[0], 1), dtype=torch.float32)

    tboard = torch.from_numpy(b)[None]
    assert bool(engine.illegal_moves_mask_batch(tboard)[0, 0])
    ttrees = new_tree_batch(poisoned(tboard.to(torch.float32))[0], tboard,
                            search.capacity())
    ttrees = run_search(ttrees, poisoned, simulations=32, batch_size=8)
    action = int(decide_batch(ttrees, torch.ones((1,), dtype=torch.bool),
                              torch.Generator().manual_seed(1))[0])
    counts = ttrees.child_N[0, 0].numpy()

    assert action == j_action != 0, "search must not pick the poisoned move"
    assert counts[0] == j_counts[0] == 0, "the illegal move got visits"
    assert np.array_equal(counts, j_counts)
    assert counts.sum() == 32


def test_slow_loop_config_matches_jax_test():
    """The closed-loop configuration of tests/test_slow_learning.py, as
    the port's calibration tool builds it."""
    want = dataclasses.replace(
        jcfg.small_9x9(),
        go=jcfg.GoConfig(size=SIZE, komi=5.5),
        net=jcfg.NetConfig(blocks=2, filters=24, value_hidden=24,
                           compute_dtype="float32"),
        search=jcfg.SearchConfig(simulations=32, batch_size=8,
                                 use_symmetry=True, policy_target="visits",
                                 negamax=True, dirichlet_alpha=0.25),
        selfplay=jcfg.SelfPlayConfig(num_games=32, stop_exploration=8,
                                     game_batch=16, resignation_percent=1.0),
        train=jcfg.TrainConfig(batch_size=64, iters_per_epoch=64,
                               epochs_per_save=6, replay_window=6144,
                               lr=2e-2),
        eval=jcfg.EvalConfig(num_games=16, margin=0.55),
    )
    got = make_config(blocks=2, filters=24, epochs=6)
    for f in dataclasses.fields(got):
        tval, jval = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(tval):
            assert dataclasses.asdict(tval) == dataclasses.asdict(jval), f.name
        else:
            assert tval == jval, f.name


@pytest.mark.slow
def test_net_learns_pass_preference_on_full_own_board():
    """Supervised check of the real net and trainer (reference
    slow_tests.py:178-240 property): after training on samples where a
    board covered by the mover's colour labels 'pass', the policy puts
    its argmax on pass for such boards and the value sees them won."""
    from sejonggo_tpu.learn import make_optimizer as j_optimizer
    from sejonggo_tpu.learn import make_train_step as j_train_step
    from sejonggo_tpu.learn.train import init_train_state as j_init_state
    from sejonggo_tpu.nets import AZNet as JNet
    from sejonggo_tpu.nets import init_variables as j_init_variables
    from sejonggo_tpu.nets import make_predict_fn as j_predict_fn
    from sejonggo_torch.learn import (init_train_state, make_optimizer,
                                      make_train_step)
    from sejonggo_torch.nets import (AZNet, from_jax_variables,
                                     make_predict_fn)

    net_cfg = tcfg.NetConfig(blocks=1, filters=8, value_hidden=8,
                             compute_dtype="float32")
    jnet = JNet.from_config(SIZE, jcfg.NetConfig(
        blocks=1, filters=8, value_hidden=8, compute_dtype="float32"))
    variables = j_init_variables(jnet, jax.random.PRNGKey(0))
    tx = j_optimizer(lr=1e-2)
    jstate = j_init_state(jnet, variables, tx)
    jstep = j_train_step(jnet, tx)
    net = AZNet.from_config(SIZE, net_cfg)
    net.load_state_dict(from_jax_variables(jax.tree_util.tree_map(
        np.asarray, variables)))
    state = init_train_state(net)
    step = make_train_step(make_optimizer(lr=1e-2))

    rng = np.random.RandomState(0)

    def full_own_board():
        b = np.zeros((SIZE, SIZE, 17), np.float32)
        b[:, :, 0] = 1.0
        b[:, :, 16] = 1.0
        return b

    def random_board():
        b = np.zeros((SIZE, SIZE, 17), np.float32)
        stones = rng.rand(SIZE, SIZE) < 0.3
        b[:, :, 0] = stones & (rng.rand(SIZE, SIZE) < 0.5)
        b[:, :, 1] = stones & (b[:, :, 0] == 0)
        b[:, :, 16] = 1.0
        return b

    pass_target = np.zeros(A, np.float32)
    pass_target[-1] = 1.0
    for _ in range(60):
        boards, pols, vals = [], [], []
        for _ in range(16):
            if rng.rand() < 0.5:
                boards.append(full_own_board())
                pols.append(pass_target)
                vals.append(1.0)
            else:
                boards.append(random_board())
                p = rng.dirichlet(np.ones(A)).astype(np.float32)
                p[-1] = 0.0
                pols.append(p / p.sum())
                vals.append(float(rng.uniform(-1, 1)))
        batch = (np.stack(boards), np.stack(pols),
                 np.asarray(vals, np.float32))
        jstate, _ = jstep(jstate, *map(jnp.asarray, batch))
        state, _ = step(state, *map(torch.from_numpy, batch))
    test_board = full_own_board()[None]
    jpol, jval = j_predict_fn(jnet)(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(test_board))
    pol, val = make_predict_fn(state.net)(torch.from_numpy(test_board))
    for p, v in ((np.asarray(jpol)[0], float(jval[0, 0])),
                 (pol[0].numpy(), float(val[0, 0]))):
        assert int(np.argmax(p)) == A - 1, \
            "trained model must prefer pass on a full own-colored board"
        assert v > 0.3, "value must see the full board as won"


@pytest.mark.slow
def test_closed_loop_improves_over_generations(tmp_path):
    """Generations of the port's pipeline must promote: at least two gate
    promotions (each a 16-game match cleared at > 0.55) in 14
    generations, and the end-state best beats model_1 in a 48-game duel
    (the bar of tests/test_slow_learning.py, at its configuration)."""
    from sejonggo_torch.learn import evaluate_models
    from sejonggo_torch.nets import make_predict_fn
    from sejonggo_torch.pipeline import Pipeline

    cfg = make_config(blocks=2, filters=24, epochs=6)
    gens = 14
    pipe = Pipeline(cfg, str(tmp_path), seed=3, device="cpu")
    winrates = []
    promotions = []
    prev = "model_1"
    for gen in range(gens):
        r = pipe.run(generations=1)[0]
        winrates.append(r["evaluate"].get("winrate"))
        best = pipe.store.best_name()
        if best != prev:
            promotions.append((gen, best))
            prev = best
    best = pipe.store.best_name()
    print(f"winrates {winrates}, promotions {promotions}")
    assert len(promotions) >= 2, (
        f"closed loop promoted {len(promotions)} times in {gens} "
        f"generations (winrates: {winrates}) — the loop is not learning")
    res = evaluate_models(
        make_predict_fn(pipe.load(best).net),
        make_predict_fn(pipe.load("model_1").net), size=SIZE, komi=5.5,
        search=cfg.search, eval_cfg=tcfg.EvalConfig(num_games=48,
                                                    margin=0.55),
        generator=torch.Generator().manual_seed(123), game_batch=16,
        device="cpu")
    print(f"end duel {res['winrate']}")
    assert res["winrate"] > 0.5, (
        f"final best {best} must beat model_1 "
        f"(winrates per gen: {winrates}): {res}")
