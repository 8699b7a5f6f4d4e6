"""The port's duels (sejonggo_torch.learn.duel, learn.duel_michi) against
the JAX package's, with JAX's draws handed in.

play_vs_michi: each move JAX splits (rng, r_net, r_mi); the net half's
search draws one D4 id per game and round from r_net, the michi half's
searcher runs its chunks from r_mi (``michi_draws`` rebuilds both).
Games must be equal move for move: actions, players, validity, winners,
points and resignations exactly (points are integer-valued floats)."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sejonggo_tpu.config import MichiConfig as JMichi
from sejonggo_tpu.config import SearchConfig as JSearch
from sejonggo_tpu.config import small_9x9 as j_small
from sejonggo_tpu.learn import duel as jduel
from sejonggo_tpu.learn import duel_michi as jdm
from sejonggo_tpu.nets import dummy_actor_fn
from sejonggo_torch.config import MichiConfig, SearchConfig, small_9x9
from sejonggo_torch.learn import duel, duel_michi
from sejonggo_torch.nets import dummy_predict_fn
from test_torch_games import jax_draws
from test_torch_michi import jax_searcher_draws
from test_torch_heuristics import one_torch_thread  # noqa: F401

SEARCH_KW = dict(simulations=16, batch_size=8, use_symmetry=True,
                 max_nodes=40)
MICHI_KW = dict(n_sims=16, komi=5.5)
GAMES, MAX_MOVES = 4, 24
FIELDS = ("actions", "players", "move_valid", "winners", "area_winners",
          "black_points", "white_points", "net_isblack", "num_moves")


def michi_draws(rng, search, michi, h, size):
    """draws(move) for play_vs_michi: JAX's per-move key chain."""
    state = {"rng": rng, "next": 0}
    rounds = search.simulations // search.batch_size

    def draws(move_n):
        assert move_n == state["next"]
        state["next"] += 1
        state["rng"], r_net, r_mi = jax.random.split(state["rng"], 3)
        r_search, _ = jax.random.split(r_net)
        syms = []
        for _ in range(rounds):
            r_search, s = jax.random.split(r_search)
            syms.append(torch.from_numpy(
                np.array(jax.random.randint(s, (h,), 0, 7))))
        return {"syms": syms,
                "michi": jax_searcher_draws(r_mi, michi, h, size)}

    return draws


@pytest.fixture(scope="module")
def duels():
    rng = jax.random.PRNGKey(2)
    want = jdm.play_vs_michi(
        dummy_actor_fn, None, size=9, komi=5.5, search=JSearch(**SEARCH_KW),
        michi=JMichi(**MICHI_KW), game_batch=GAMES, rng=rng,
        max_moves=MAX_MOVES)
    search, michi = SearchConfig(**SEARCH_KW), MichiConfig(**MICHI_KW)
    got = duel_michi.play_vs_michi(
        dummy_predict_fn, size=9, komi=5.5, search=search, michi=michi,
        game_batch=GAMES, max_moves=MAX_MOVES, device="cpu",
        draws=michi_draws(rng, search, michi, GAMES // 2, 9))
    return want, got


def test_play_vs_michi_matches_jax_move_for_move(duels):
    want, got = duels
    for f in FIELDS:
        assert np.array_equal(np.asarray(want[f]), got[f]), f
    for k in ("games", "net_wins", "draws", "michi_resigns", "winrate"):
        assert want[k] == got[k], k
    c = got["counts"]
    assert c["net_moves"] >= 1 and c["michi_moves"] >= 1
    assert c["michi_rounds"] >= c["michi_moves"]
    # the final positions replay from the moves through the plain engine
    from sejonggo_torch.goenv import engine

    boards = engine.init_board(9, batch=GAMES, device="cpu")
    for t in range(got["actions"].shape[0]):
        a = torch.as_tensor(np.where(got["move_valid"][t], got["actions"][t], 81))
        boards = engine.step_batch(boards, a)
    assert torch.equal(engine.signed_stones(boards),
                       engine.signed_stones(got["final_boards"]))


def test_michi_duel_sgfs_are_byte_equal(duels, tmp_path):
    want, got = duels
    kw = dict(size=9, komi=5.5, prefix="dummy_vs_michi16", net_name="dummy",
              michi_name="michi-16")
    jdm.save_michi_duel_sgfs(want, outdir=str(tmp_path / "j"), **kw)
    duel_michi.save_michi_duel_sgfs(got, outdir=str(tmp_path / "t"), **kw)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == GAMES
    for name in names:
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name


def test_duel_heuristic_vs_dummy_matches_jax(tmp_path):
    """duel('heuristic', 'dummy') through evaluate_models, colours and
    draws from JAX's keys, the games' SGFs byte-equal."""
    games, seed, b = 2, 3, 2
    jcfg = j_small(search=JSearch(**SEARCH_KW))
    tcfg = small_9x9(search=SearchConfig(**SEARCH_KW))
    want = jduel.duel("heuristic", "dummy", cfg=jcfg, model_dir="unused",
                      games=games, seed=seed, max_moves=10,
                      sgf_dir=str(tmp_path / "j"))
    r, r_color, r_games = jax.random.split(jax.random.PRNGKey(seed), 3)
    got = duel.duel(
        "heuristic", "dummy", cfg=tcfg, model_dir="unused", games=games,
        seed=seed, max_moves=10, sgf_dir=str(tmp_path / "t"), device="cpu",
        colors=lambda i: np.asarray(jax.random.bernoulli(r_color, 0.5, (b,))),
        draws=lambda i, m, d=jax_draws(r_games, tcfg.search, b, 9, False,
                                       True): d(m))
    assert want == got
    names = sorted(os.listdir(tmp_path / "j"))
    assert names and names == sorted(os.listdir(tmp_path / "t"))
    for name in names:
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name


def test_resolve_reads_model_291_as_the_net_to_duel():
    """_resolve('best') reads the committed model_291 at strength_9x9_xl's
    width and returns a predict function on the device asked for."""
    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.goenv import engine

    predict = duel._resolve("best", strength_9x9_xl(),
                            "runs/strength_r5b/sp_models", "cpu")
    p, v = predict(engine.init_board(9, batch=2, device="cpu").float())
    assert p.shape == (2, 82) and v.shape == (2, 1)
    assert torch.isfinite(p).all() and torch.allclose(p.sum(-1), torch.ones(2))


def test_elo_diff_matches_jax():
    for w in (0.0, 0.001, 0.25, 0.5, 0.53125, 0.9, 1.0):
        assert duel.elo_diff(w) == jduel.elo_diff(w)
    assert duel.elo_diff(0.5) == 0.0


def test_duel_vs_gtp_against_the_ports_own_gtp_on_the_cpu(monkeypatch):
    """duel_vs_gtp: our engine against the port's GTP engine in a
    subprocess, one game each colour, capped by the 9x9 move limit."""
    # one torch thread in the engine process: the test workers share the
    # machine's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cmd = (f"{sys.executable} -m sejonggo_torch.io.gtp --preset tiny "
           f"--dummy --device cpu")
    cfg = small_9x9(search=SearchConfig(simulations=8, batch_size=8,
                                        use_symmetry=False, max_nodes=24))
    res = duel.duel_vs_gtp("dummy", cmd, cfg=cfg, model_dir="unused",
                           games=2, device="cpu")
    assert res["games"] == 2 and 0 <= res["wins"] <= 2
    assert res["winrate"] == res["wins"] / 2
    assert res["elo_diff"] == duel.elo_diff(res["winrate"])


def _cli(args, timeout=300):
    # one torch thread in the duel process: the test workers share the
    # machine's cores
    return subprocess.run([sys.executable, "-m", "sejonggo_torch.learn.duel",
                           *args], capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_duel_command_line_michi_on_the_cpu_and_cuda_by_default():
    args = ["--a", "dummy", "--b", "michi", "--michi-sims", "16", "--games",
            "2", "--max-moves", "6", "--preset", "tiny"]
    proc = _cli(args + ["--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    out = eval(proc.stdout.strip().splitlines()[-1])   # the printed dict
    assert out["games"] == 2 and out["b"] == "michi@16"
    if not torch.cuda.is_available():
        proc = _cli(args)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
