"""The port's closed loop against the JAX package's, on the CPU at
tests/test_pipeline.py's micro configuration (1 block x 8 filters, 8
simulations, 4 games).

One generation leaves the same store layout and logs the same metric
events with the same keys as JAX; the gate promotes by the same rule
(the two loops play different games: their random draws come from
torch and from jax.random).  A train phase from the same model_1,
replay contents and sampler seed writes a model_2 within 1e-4 of JAX's.
The run state round-trips, and the selfplay role's segment feeds the
train role."""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import torch

from sejonggo_tpu import config as jcfg
from sejonggo_tpu.pipeline import Pipeline as JPipeline
from sejonggo_torch import config as tcfg
from sejonggo_torch.learn import restore
from sejonggo_torch.pipeline import Pipeline

TOL = 1e-4


def micro_config(cfgmod):
    """tests/test_pipeline.py:micro_config, from either package."""
    cfg = cfgmod.small_9x9()
    return dataclasses.replace(
        cfg,
        net=cfgmod.NetConfig(blocks=1, filters=8, value_hidden=8,
                             compute_dtype="float32"),
        search=cfgmod.SearchConfig(simulations=8, batch_size=4,
                                   use_symmetry=False),
        selfplay=cfgmod.SelfPlayConfig(num_games=4, stop_exploration=4,
                                       game_batch=4),
        train=cfgmod.TrainConfig(batch_size=8, iters_per_epoch=4,
                                 epochs_per_save=2, replay_window=4096),
        eval=cfgmod.EvalConfig(num_games=4, margin=0.55),
    )


def _events(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _rows(seed, n):
    rng = np.random.RandomState(seed)
    boards = (rng.rand(n, 9, 9, 17) < 0.3).astype(np.int8)
    policies = rng.rand(n, 82).astype(np.float32)
    values = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    return boards, policies, values


def test_one_generation_like_jax(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    (jr,) = JPipeline(micro_config(jcfg), jdir, seed=0).run(generations=1)
    pipe = Pipeline(micro_config(tcfg), tdir, seed=0, device="cpu")
    (tr,) = pipe.run(generations=1)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(os.listdir(os.path.join(tdir, "sp_models"))) == \
        sorted(os.listdir(os.path.join(jdir, "sp_models"))) == \
        ["index.json", "model_1.msgpack", "model_2.msgpack"]
    jev, tev = _events(jdir), _events(tdir)
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    for t, j in zip(tev, jev):
        assert sorted(t) == sorted(j), t["event"]
    assert sorted(tr) == sorted(jr)
    for r in (jr, tr):
        assert r["train"]["from"] == "model_1" and r["train"]["to"] == "model_2"
        assert np.isfinite(r["train"]["loss"])
        assert r["evaluate"]["games"] == 4
        promote = r["evaluate"]["winrate"] > 0.55
        assert r["evaluate"]["promote"] == promote
        assert r["best"] == ("model_2" if promote else "model_1")
    assert len(pipe.replay) == (tr["selfplay"]["moves"]
                                + tr["evaluate"]["eval_moves_to_replay"])
    assert tr["evaluate"]["eval_moves_to_replay"] > 0
    assert pipe.store.best_name() == tr["best"]


def test_train_phase_matches_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpipe = JPipeline(micro_config(jcfg), str(jdir), seed=4)
    jpipe.init_models()
    tpipe = Pipeline(micro_config(tcfg), str(tdir), seed=4, device="cpu")
    for f in ("model_1.msgpack", "index.json"):
        shutil.copy(jdir / "sp_models" / f, tdir / "sp_models" / f)
    rows = _rows(5, 300)
    jpipe.replay.add_samples(*rows)
    tpipe.replay.add_samples(*rows)
    jstats, tstats = jpipe.train_phase(), tpipe.train_phase()
    assert tstats["to"] == jstats["to"] == "model_2"
    for k in ("loss", "policy_ce", "value_mse", "grad_norm"):
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=TOL, atol=TOL)
    want = restore(str(jdir / "sp_models/model_2.msgpack"))
    got = restore(str(tdir / "sp_models/model_2.msgpack"))
    assert int(got["step"]) == int(want["step"]) == 8
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=str(path))


def test_run_state_round_trip(tmp_path):
    cfg = micro_config(tcfg)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, lr_plateau_factor=0.5))
    pipe = Pipeline(cfg, str(tmp_path), seed=1, device="cpu")
    pipe.replay.add_samples(*_rows(1, 40))
    pipe.calibrator.min_values = [-0.5, -0.25]
    pipe.calibrator.current = -0.5
    pipe.plateau.update(2.0)
    pipe.plateau.update(2.5)
    pipe.set_lr(5e-3)
    torch.rand(7, generator=pipe.generator)
    pipe.save_run_state()
    other = Pipeline(cfg, str(tmp_path), seed=2, device="cpu")
    assert other.load_run_state()
    for k in ("boards", "policies", "values"):
        np.testing.assert_array_equal(getattr(other.replay, k)[:40],
                                      getattr(pipe.replay, k)[:40])
    assert len(other.replay) == 40 and other.replay.cursor == 40
    assert other.calibrator.min_values == [-0.5, -0.25]
    assert other.calibrator.current == -0.5
    assert other.lr == other.tx.lr == 5e-3
    assert other.plateau.state_dict() == pipe.plateau.state_dict()
    assert torch.equal(torch.rand(5, generator=other.generator),
                       torch.rand(5, generator=pipe.generator))
    assert not Pipeline(cfg, str(tmp_path / "empty"), device="cpu") \
        .load_run_state()


def test_selfplay_segment_feeds_the_train_role(tmp_path):
    cfg = micro_config(tcfg)
    sp = Pipeline(cfg, str(tmp_path), seed=3, device="cpu")
    sp.run_selfplay_role(iterations=1)
    segs = sorted(os.listdir(tmp_path / "replay_segments"))
    assert segs == ["seg_p0_000000.npz"]
    moves = len(sp.replay)
    assert moves > 0
    tr = Pipeline(cfg, str(tmp_path), seed=3, device="cpu")
    tr.run_train_role(iterations=1)
    assert len(tr.replay) == moves
    assert tr._ingested_segments == set(segs)
    assert tr.store.latest_name() == "model_2"
    assert tr.store.best_name() == "model_1"
    sp._segment_games = []
    assert sp._publish_segment() is None      # nothing played since
