"""Data parallelism over ranks (sejonggo_torch/parallel) against the JAX
package's mesh on the CPU.

Two ranks run as processes of a gloo group (``parallel.launch``); the JAX
side runs in the test process on two of the conftest's 8 virtual CPU
devices (``make_mesh(2)``).  The ranks import no JAX: their code is
``_rank_checks`` below, loaded from this file, so this module imports JAX
and the JAX-side helpers only inside the tests.  One launch of two ranks
answers every case; each test reads its part:
- the dp=2 train step against JAX's ``make_train_step(mesh=...)`` from the
  same weights (rank 1 starts from other weights, which the step's
  broadcast from rank 0 replaces), two steps on the same global batch:
  parameters, BatchNorm statistics, momentum and metrics within 1e-5
  (atol and rtol: float32 sums in another order), once on a batch whose
  halves have the same density and once on one whose halves differ, so
  that per-rank BatchNorm statistics would give another step;
- ``play_games`` (self-play with resignation) and ``evaluate_models``
  (padded batches) over the mesh against JAX's mesh runs with the dummy
  net and JAX's draws: every record exactly, game by game up to each
  game's end (a rank's batch may end sooner: only masked padding rows
  differ), and the gate's counts;
- ``ContinuousSelfPlay`` over the mesh: the ranks' games are those of one
  process with the same draws;
- the mesh helpers.
``local_game_slice`` is held to JAX's by patching jax.process_count and
jax.process_index, ``dryrun_multichip(2, device="cpu")`` is the twin of
tests/test_multihost.py, and the pipeline's command line joins the group
from its flags."""
import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch

SIZE, B, MAX_MOVES, GAMES_PER_BATCH = 5, 4, 14, 3
SEARCH = dict(simulations=16, batch_size=8, use_symmetry=False,
              dirichlet_alpha=0.3, max_nodes=40)
TRAIN_SIZE, BATCH, LR, MOMENTUM, L2, TOL = 9, 8, 2e-2, 0.9, 1e-4, 1e-5
THRESHOLDS = [np.nan, 2.0, np.nan, np.nan]    # game 1 resigns at once
CONT_STEPS = 18


def _net_cfg():
    from sejonggo_torch.config import NetConfig

    return NetConfig(blocks=2, filters=16, value_hidden=16,
                     compute_dtype="float32")


def _train_batch(seed, split):
    """A global batch; ``split`` gives its halves different densities."""
    rng = np.random.RandomState(seed)
    density = np.where(np.arange(BATCH) < BATCH // 2, 0.05 if split else 0.3,
                       0.6 if split else 0.3)
    boards = (rng.rand(BATCH, TRAIN_SIZE, TRAIN_SIZE, 17)
              < density[:, None, None, None]).astype(np.float32)
    boards[..., 16] = rng.rand(BATCH, 1, 1) < 0.5
    a = TRAIN_SIZE * TRAIN_SIZE + 1
    policy = rng.rand(BATCH, a).astype(np.float32) ** 4
    policy /= policy.sum(-1, keepdims=True)
    values = rng.choice([-1.0, 1.0], size=BATCH).astype(np.float32)
    return boards, policy, values


def _continuous_draws():
    rng = np.random.RandomState(3)
    a = SIZE * SIZE + 1
    return [dict(noise=rng.dirichlet([0.3] * a, size=B).astype(np.float32),
                 gumbel=rng.gumbel(size=(B, a)).astype(np.float32))
            for _ in range(CONT_STEPS + 1)]


def _torch_draws(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _games(gb):
    return {f.name: getattr(gb, f.name) for f in dataclasses.fields(gb)}


# --- the ranks' side (no JAX) ------------------------------------------

def _rank_checks(path):
    from sejonggo_torch.actor import ContinuousSelfPlay, play_games
    from sejonggo_torch.config import EvalConfig, SearchConfig
    from sejonggo_torch.learn import (evaluate_models, init_train_state,
                                      make_optimizer, make_train_step)
    from sejonggo_torch.learn.checkpoint import state_tree
    from sejonggo_torch.nets import AZNet, dummy_predict_fn, from_jax_variables
    from sejonggo_torch.parallel import (host_local_batch, make_mesh,
                                         process_count, replicate,
                                         shard_actor_state, shard_batch)

    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")]
    with open(path, "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh(device="cpu")
    assert (mesh.size, process_count()) == (2, 2)
    out = {"rank": mesh.rank, "train": {}}

    for case, (variables, batches) in inp["train"].items():
        net = AZNet.from_config(TRAIN_SIZE, _net_cfg())
        net.load_state_dict(from_jax_variables(variables))
        if mesh.rank == 1:         # the first step's broadcast repairs this
            with torch.no_grad():
                for p in net.parameters():
                    p.add_(1.0)
        state = init_train_state(net)
        step = make_train_step(make_optimizer(LR, MOMENTUM, L2), mesh=mesh)
        metrics = []
        for batch in batches:
            local = [host_local_batch(torch.from_numpy(shard_batch(x, mesh)),
                                      mesh, BATCH) for x in batch]
            state, m = step(state, *local)
            metrics.append({k: float(v) for k, v in m.items()})
        out["train"][case] = (state_tree(state), metrics)

    search = SearchConfig(**SEARCH)
    sp = inp["selfplay"]
    out["selfplay"] = _games(play_games(
        dummy_predict_fn, size=SIZE, komi=5.5, search=search, game_batch=B,
        stop_exploration=2, max_moves=MAX_MOVES, resign_thresholds=THRESHOLDS,
        device="cpu", mesh=mesh,
        draws=lambda m: _torch_draws(sp[m])))
    ev = inp["evaluate"]
    res = evaluate_models(
        dummy_predict_fn, dummy_predict_fn, size=SIZE, komi=5.5,
        search=search, eval_cfg=EvalConfig(num_games=2 * GAMES_PER_BATCH),
        game_batch=GAMES_PER_BATCH, stop_exploration=2, max_moves=MAX_MOVES,
        collect_games=True, device="cpu", mesh=mesh,
        colors=lambda i: ev["colors"][i],
        draws=lambda i, m: _torch_draws(ev["draws"][i][m]))
    res["game_batches"] = [_games(g) for g in res["game_batches"]]
    out["evaluate"] = res

    draws = inp["continuous"]
    actor = ContinuousSelfPlay(
        dummy_predict_fn, size=SIZE, komi=5.5, search=search, game_batch=B,
        stop_exploration=2, max_moves=8, device="cpu", mesh=mesh,
        draws=lambda s: _torch_draws(draws[s]))
    out["continuous"] = (actor.b, actor.run(100, max_steps=CONT_STEPS))

    t = torch.tensor([1.0 + mesh.rank, 10.0])
    out["helpers"] = dict(
        sum=mesh.all_reduce_sum(t).tolist(), mean=mesh.mean(t).tolist(),
        counts=mesh.sum_counts([mesh.rank, 3]),
        replicated=replicate({"w": torch.full((3,), float(mesh.rank))},
                             mesh)["w"].tolist(),
        rows=shard_batch(np.arange(6), mesh).tolist(),
        draws=shard_actor_state({"syms": [5, torch.arange(4)]}, mesh),
        game_slice=list(mesh.game_slice(5)))
    try:
        host_local_batch(torch.zeros(3), mesh, BATCH)
        out["helpers"]["uneven"] = "accepted"
    except ValueError:
        out["helpers"]["uneven"] = "refused"
    mesh.barrier()
    return out


# --- the test process's side ------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's draws and weights for every case, the two ranks' answers, and
    JAX's own answers (computed here, on two virtual CPU devices)."""
    import jax

    from sejonggo_tpu.actor.selfplay import play_games as j_play_games
    from sejonggo_tpu.config import EvalConfig as JEval
    from sejonggo_tpu.config import SearchConfig as JSearch
    from sejonggo_tpu.learn.evaluate import evaluate_models as j_evaluate
    from sejonggo_tpu.nets.stub import dummy_actor_fn
    from sejonggo_tpu.parallel import make_mesh as j_make_mesh
    from sejonggo_torch.config import SearchConfig
    from sejonggo_torch.nets import seeded_flax_variables
    from sejonggo_torch.parallel.launch import launch
    from test_torch_games import step_draws

    ts, js = SearchConfig(**SEARCH), JSearch(**SEARCH)
    jmesh = j_make_mesh(2)

    def chain(rng, b, selfplay):
        """JAX's per-move draws of play_games from ``rng``, as numpy."""
        out = []
        for _ in range(MAX_MOVES):
            rng, sub = jax.random.split(rng)
            d = step_draws(sub, ts, b, SIZE, selfplay, not selfplay)
            out.append({k: v.numpy() for k, v in d.items()})
        return out

    inp, want = {"train": {}}, {"train": {}}
    for case, seed in (("same_halves", 1), ("different_halves", 2)):
        variables = seeded_flax_variables(TRAIN_SIZE, _net_cfg(), seed)
        batches = [_train_batch(10 * seed + i, case == "different_halves")
                   for i in range(2)]
        inp["train"][case] = (variables, batches)
        want["train"][case] = _jax_train(variables, batches, jmesh)

    rng = jax.random.PRNGKey(7)
    inp["selfplay"] = chain(rng, B, True)
    want["selfplay"] = j_play_games(
        dummy_actor_fn, None, size=SIZE, komi=5.5, search=js, game_batch=B,
        rng=rng, selfplay=True, stop_exploration=2, max_moves=MAX_MOVES,
        resign_thresholds=THRESHOLDS, mesh=jmesh)

    rng = jax.random.PRNGKey(9)
    want["evaluate"] = j_evaluate(
        dummy_actor_fn, dummy_actor_fn, size=SIZE, komi=5.5, search=js,
        eval_cfg=JEval(num_games=2 * GAMES_PER_BATCH), rng=rng,
        game_batch=GAMES_PER_BATCH, stop_exploration=2, max_moves=MAX_MOVES,
        mesh=jmesh, collect_games=True)
    colors, draws, r = [], [], rng
    for b in (4, 2):        # 3 games padded to 4, then the last 2
        r, r_color, r_games = jax.random.split(r, 3)
        colors.append(np.asarray(jax.random.bernoulli(r_color, 0.5, (b,))))
        draws.append(chain(r_games, b, False))
    inp["evaluate"] = dict(colors=colors, draws=draws)
    inp["continuous"] = _continuous_draws()

    path = tmp_path_factory.mktemp("ranks") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        got = launch(2, f"{os.path.abspath(__file__)}:_rank_checks",
                     (str(path),), device="cpu", timeout_s=600)
    assert [g["rank"] for g in got] == [0, 1]
    return want, got


def _jax_train(variables, batches, jmesh):
    """Two steps of JAX's train step sharded over ``jmesh``: the state
    tree and metrics after each step."""
    import jax
    import jax.numpy as jnp

    from sejonggo_tpu import config as jcfg
    from sejonggo_tpu.learn import make_optimizer as j_make_optimizer
    from sejonggo_tpu.learn import make_train_step as j_make_train_step
    from sejonggo_tpu.learn.train import init_train_state as j_init_train_state
    from sejonggo_tpu.nets import AZNet as JNet

    jnet = JNet.from_config(TRAIN_SIZE, jcfg.NetConfig(
        **dataclasses.asdict(_net_cfg())))
    tx = j_make_optimizer(LR, MOMENTUM, L2)
    state = j_init_train_state(jnet, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    step = j_make_train_step(jnet, tx, mesh=jmesh)
    metrics = []
    for batch in batches:
        state, m = step(state, *batch)
        metrics.append({k: float(v) for k, v in m.items()})
    tree = jax.device_get({
        "params": state.params, "batch_stats": state.batch_stats,
        "trace": state.opt_state[1][0].trace, "step": np.asarray(state.step)})
    return tree, metrics


def _assert_tree_close(got, want, what):
    import jax

    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want), what
    for (p, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                         jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=f"{what} {p}")


@pytest.mark.parametrize("case", ["same_halves", "different_halves"])
def test_dp2_train_step_matches_jax_mesh(ranks, case):
    want, got = ranks
    w_tree, w_metrics = want["train"][case]
    trees = []
    for g in got:
        tree, metrics = g["train"][case]
        trees.append(tree)
        port = {"params": tree["params"], "batch_stats": tree["batch_stats"],
                "trace": tree["opt_state"]["1"]["0"]["trace"],
                "step": tree["step"]}
        _assert_tree_close(port, w_tree, f"rank {g['rank']}")
        for m, wm in zip(metrics, w_metrics):
            assert set(m) == set(wm)
            for k in wm:
                np.testing.assert_allclose(m[k], wm[k], atol=TOL, rtol=TOL,
                                           err_msg=k)
    # the ranks' states are bit-equal, not only close
    assert pickle.dumps(trees[0]) == pickle.dumps(trees[1])


PER_MOVE = ("boards", "policy_targets", "values", "actions", "players",
            "move_valid", "tree_fresh")
FLOAT_FIELDS = ("values", "policy_targets")   # float32 sums, as elsewhere


def _assert_rows_equal(want, got_ranks):
    """The ranks' GameBatches side by side equal JAX's batch: per-game
    fields exactly; per-move fields exactly up to each rank's T, and
    JAX's later rows of a rank's games are masked padding.  The predicted
    values and policy targets within 1e-5, as in test_torch_games."""
    per = want.actions.shape[1] // len(got_ranks)
    for r, g in enumerate(got_ranks):
        cols = slice(r * per, (r + 1) * per)
        t = g["actions"].shape[0]
        assert 0 < t <= want.actions.shape[0]
        assert set(g) == {f.name for f in dataclasses.fields(want)}
        for k, v in g.items():
            w = np.asarray(getattr(want, k))
            w = w[:t, cols] if k in PER_MOVE else w[cols]
            assert w.shape == v.shape, (r, k)
            if k in FLOAT_FIELDS:
                np.testing.assert_allclose(v, w, atol=TOL, rtol=0,
                                           err_msg=f"rank {r} {k}")
            else:
                assert np.array_equal(w, v), (r, k)
        assert not want.move_valid[t:, cols].any(), r


def test_sharded_play_games_matches_jax_mesh(ranks):
    want, got = ranks
    _assert_rows_equal(want["selfplay"], [g["selfplay"] for g in got])
    ends = np.concatenate([g["selfplay"]["end_reasons"] for g in got])
    assert ends[1] == 2 and want["selfplay"].num_moves[1] == 0   # resigned


def test_sharded_evaluate_models_matches_jax_mesh(ranks):
    want, got = ranks
    w = dict(want["evaluate"])
    w_batches = w.pop("game_batches")
    for g in got:
        res = dict(g["evaluate"])
        batches = res.pop("game_batches")
        assert res == w, g["rank"]           # the counts, summed over ranks
        assert len(batches) == len(w_batches) == 2
    assert w["games"] == 6                    # 3 games padded to 4, then 2
    for i, wb in enumerate(w_batches):
        _assert_rows_equal(wb, [g["evaluate"]["game_batches"][i] for g in got])


def test_sharded_continuous_self_play_matches_one_process(ranks):
    from sejonggo_torch.actor import ContinuousSelfPlay
    from sejonggo_torch.config import SearchConfig
    from sejonggo_torch.nets import dummy_predict_fn

    _, got = ranks
    draws = _continuous_draws()
    actor = ContinuousSelfPlay(
        dummy_predict_fn, size=SIZE, komi=5.5, search=SearchConfig(**SEARCH),
        game_batch=B, stop_exploration=2, max_moves=8, device="cpu",
        draws=lambda s: _torch_draws(draws[s]))
    want = actor.run(100, max_steps=CONT_STEPS)
    assert [g["continuous"][0] for g in got] == [B // 2, B // 2]
    games = [game for g in got for game in g["continuous"][1]]
    def key(gm):
        return gm["actions"].tobytes(), gm["policies"].tobytes()

    assert len(games) == len(want) > B
    for a, b in zip(sorted(games, key=key), sorted(want, key=key)):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_mesh_helpers_on_two_ranks(ranks):
    _, got = ranks
    for g in got:
        h = g["helpers"]
        assert h["sum"] == [3.0, 20.0] and h["mean"] == [1.5, 10.0]
        assert h["counts"] == [1.0, 6.0]
        assert h["replicated"] == [0.0, 0.0, 0.0]
        assert h["uneven"] == "refused"
        r = g["rank"]
        assert h["rows"] == [3 * r, 3 * r + 1, 3 * r + 2]
        assert h["draws"]["syms"][0] == 5
        assert h["draws"]["syms"][1].tolist() == [2 * r, 2 * r + 1]
        assert h["game_slice"] == [[0, 1, 2], [3, 4]][r]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
def test_local_game_slice_matches_jax(monkeypatch, world):
    import jax

    from sejonggo_torch.parallel import dist
    from sejonggo_tpu.parallel import local_game_slice as j_slice

    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(dist, "process_count", lambda: world)
    for total in (0, 1, 4, 7, 128, 512):
        covered = []
        for rank in range(world):
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            monkeypatch.setattr(dist, "process_index", lambda: rank)
            got = dist.local_game_slice(total)
            assert got == j_slice(total), (world, rank, total)
            covered += list(got)
        assert covered == list(range(total))


def test_one_process_world_is_a_noop():
    from sejonggo_torch.parallel import (init_distributed, make_mesh,
                                         process_count, rank_seed)

    assert init_distributed(device="cpu") == 0
    assert process_count() == 1 and rank_seed(7) == 7
    mesh = make_mesh(device="cpu")
    t = torch.ones(3, requires_grad=True)
    assert mesh.size == 1 and mesh.all_reduce_sum_grad(t) is t
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")


def test_dryrun_multichip_two_ranks_on_the_cpu(monkeypatch):
    """The twin of tests/test_multihost.py: one whole generation on two
    gloo ranks (model_2 written once, by rank 0; the promotion decision
    and best model the same on both ranks; the parameters bit-equal on
    both after training and on disk; run-state and segment files named
    _p0 and _p1)."""
    from sejonggo_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    reports = dryrun_multichip(2, device="cpu", timeout_s=600)
    assert [r["saved"] for r in reports] == [["model_1", "model_2"], []]
    assert reports[0]["promote"] == reports[1]["promote"]
    assert reports[0]["trained"] == reports[1]["trained"]
    assert {"run_state_p0.json", "run_state_p1.json", "replay_p0.npz",
            "replay_p1.npz"} <= set(reports[0]["files"])
    assert [r["segment"] for r in reports] == ["seg_p0_000000.npz",
                                              "seg_p1_000000.npz"]


def test_pipeline_main_joins_the_group_from_its_flags(monkeypatch, tmp_path):
    """``--coordinator/--num-hosts/--host-id`` reach ``init_distributed``
    before the pipeline is built, as in the JAX package's main; one host
    joins nothing."""
    from sejonggo_torch import pipeline
    from sejonggo_torch.utils import metrics

    calls = []

    class FakePipeline:
        def __init__(self, cfg, workdir, seed, device):
            calls.append(("pipeline", device))

        def run(self, generations, games):
            return []

    monkeypatch.setattr(pipeline, "Pipeline", FakePipeline)
    monkeypatch.setattr(pipeline, "init_distributed",
                        lambda *a, **kw: calls.append(("init", a, kw)))
    monkeypatch.setattr(metrics, "setup_logging", lambda log_dir: None)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    common = ["--device", "cpu", "--workdir", str(tmp_path)]
    pipeline.main(common + ["--coordinator", "host0:29500",
                            "--num-hosts", "2", "--host-id", "1"])
    assert calls == [("init", ("host0:29500", 2, 1),
                      {"device": "cpu", "local_rank": None}),
                     ("pipeline", "cpu")]
    calls.clear()
    pipeline.main(["--workdir", str(tmp_path), "--coordinator",
                   "host0:29500", "--num-hosts", "8", "--host-id", "6",
                   "--local-rank", "2"])
    assert calls == [("init", ("host0:29500", 8, 6),
                      {"device": None, "local_rank": 2}),
                     ("pipeline", None)]
    calls.clear()
    pipeline.main(common)
    assert calls == [("pipeline", "cpu")]


@pytest.mark.parametrize("env, rank, world, local_rank, cards, want", [
    # torchrun or parallel.launch: LOCAL_RANK and LOCAL_WORLD_SIZE
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, 5, 8, None, 4, (1, True)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 1, 2, None, 1, (0, False)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, 1, 4, None, 2, "raises"),
    # the pipeline's flags: --local-rank, else the world on this machine
    ({}, 6, 8, 2, 4, (2, True)),
    ({}, 1, 2, 0, 1, (0, True)),          # two machines of one card
    ({}, 1, 2, None, 4, (1, True)),
    ({}, 6, 8, None, 4, "raises"),        # two machines of 4 cards
    ({}, 1, 2, None, 1, "raises"),        # one card: name it to share it
    ({}, 1, 2, 4, 4, "raises"),
])
def test_card_layout(monkeypatch, env, rank, world, local_rank, cards, want):
    """Which card a rank takes, and whether it is its own (NCCL): never
    several ranks stacked on card 0 of a machine with more cards, and a
    rank of a world on several machines needs its local rank."""
    from sejonggo_torch.parallel.dist import card_layout

    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want == "raises":
        with pytest.raises(ValueError):
            card_layout(rank, world, local_rank, cards)
    else:
        assert card_layout(rank, world, local_rank, cards) == want


@pytest.mark.parametrize("rank", [0, 1])
def test_failed_train_phase_saves_without_a_barrier(monkeypatch, tmp_path,
                                                    rank):
    """A rank whose train phase fails meets no collective on its way out
    (the others may be inside one of another size): rank 0 writes
    'exit_backup', any other rank writes nothing, and the error goes on
    to the launcher."""
    from sejonggo_torch import pipeline
    from sejonggo_torch.parallel.dryrun import dryrun_config
    from sejonggo_torch.parallel.mesh import Mesh

    pipe = pipeline.Pipeline(dryrun_config(1), str(tmp_path), device="cpu")
    pipe.init_models()
    barriers = []
    monkeypatch.setattr(Mesh, "barrier", lambda self: barriers.append(1))
    monkeypatch.setattr(pipeline, "process_index", lambda: rank)

    def fail(n):
        raise RuntimeError("this rank's fault")

    monkeypatch.setattr(pipe.replay, "sample", fail)
    with pytest.raises(RuntimeError, match="this rank's fault"):
        pipe.train_phase()
    assert barriers == []
    assert os.path.exists(pipe.store._path("exit_backup")) == (rank == 0)
