"""Self-play archives of the port (Pipeline.archive_selfplay,
_archive_game, clean_archives) against the JAX package's.  A micro
self-play phase of the port (5x5) with archiving on writes SGF files and the
reference's HDF5 sample tree; the JAX pipeline archives the same game
dicts, and both trees must hold byte-equal SGF files, equal samples and
the same clean_archives statistics, also when the sweep removes short
games and prunes to the replay window."""
import dataclasses
import os

import numpy as np
import pytest

from sejonggo_tpu import config as jcfg
from sejonggo_tpu.io.h5data import load_move_sample
from sejonggo_tpu.pipeline import Pipeline as JPipeline
from sejonggo_torch import config as tcfg
from sejonggo_torch.pipeline import Pipeline
from test_torch_pipeline import micro_config
from test_torch_heuristics import one_torch_thread  # noqa: F401


def _tree(base):
    """{relative path: file bytes or None for a directory} under base."""
    out = {}
    for root, dirs, files in os.walk(base):
        for d in dirs:
            out[os.path.relpath(os.path.join(root, d), base)] = None
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, base)] = fh.read()
    return out


def _config(cfgmod, window):
    """micro_config on a 5x5 board (short games keep the test quick)
    with the given replay window, which bounds the archive."""
    cfg = micro_config(cfgmod)
    return cfg.replace(go=cfgmod.GoConfig(size=5, komi=5.5),
                       train=dataclasses.replace(cfg.train,
                                                 replay_window=window))


@pytest.mark.parametrize("fmt,window", [("sgf", 4096), ("both", 400)])
def test_archives_match_jax(tmp_path, fmt, window):
    """Two self-play phases of the port with archiving on (the game
    numbers go on across phases, each phase ends with a sweep), then a
    one-move game and a last sweep; the JAX pipeline replays the same
    sequence of archive and sweep calls on the same game dicts."""
    pipe = Pipeline(_config(tcfg, window),
                    str(tmp_path / "port"), seed=0, device="cpu")
    pipe.init_models()
    pipe.archive_selfplay, pipe.archive_format = True, fmt
    events = []
    real_archive, real_clean = pipe._archive_game, pipe.clean_archives

    def archive(game, model, n):
        events.append(("archive", (game, model, n)))
        real_archive(game, model, n)

    def clean(*a, **kw):
        stats = real_clean(*a, **kw)
        events.append(("clean", stats))
        return stats

    pipe._archive_game, pipe.clean_archives = archive, clean
    for _ in range(2):
        pipe.selfplay_phase()
    games = [e[1] for e in events if e[0] == "archive"]
    assert [n for _, _, n in games] == list(range(len(games))) and \
        len(games) >= 8
    short = dict(games[0][0])
    for k in ("boards", "policies", "values", "actions", "players"):
        short[k] = short[k][:1]
    pipe._archive_game(short, "model_1", len(games))
    pipe.clean_archives()
    sweeps = [e[1] for e in events if e[0] == "clean"]
    # a one-move game leaves an SGF file and, with "both", an HDF5 dir
    assert len(sweeps) == 3
    assert sweeps[-1]["swept_short"] == (2 if fmt == "both" else 1)
    assert any(s["pruned_window"] for s in sweeps) == (window < 4096)
    assert sweeps[-1]["games"] > 0

    jpipe = JPipeline(_config(jcfg, window),
                      str(tmp_path / "jax"), seed=0)
    jpipe.archive_format = fmt
    jsweeps = []
    for kind, arg in events:
        if kind == "archive":
            jpipe._archive_game(*arg)
        else:
            jsweeps.append(jpipe.clean_archives())
    assert jsweeps == sweeps

    base = "sp_self_play_data"
    port_tree = _tree(tmp_path / "port" / base)
    jax_tree = _tree(tmp_path / "jax" / base)
    assert sorted(port_tree) == sorted(jax_tree)
    assert any(rel.endswith(".sgf") for rel in port_tree)
    for rel, data in port_tree.items():
        if rel.endswith(".sgf"):
            assert data == jax_tree[rel], rel
        elif rel.endswith("sample.h5"):
            d = os.path.dirname(rel)
            for a, b in zip(load_move_sample(str(tmp_path / "port" / base / d)),
                            load_move_sample(str(tmp_path / "jax" / base / d))):
                assert np.array_equal(a, b) and a.dtype == b.dtype, rel
