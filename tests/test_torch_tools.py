"""The port's user tools (sejonggo_torch.tools) against the JAX package's
scripts, driven in-process (``runpy.run_path`` with a patched
``sys.argv``) on the CPU.

- build_patterns: ``canonical_neighborhoods`` equal at every point of
  9x9 and 19x19 positions; the pattern files byte-equal for 6 duel games
  at 9x9 and 2 corpus games at 19x19 (``slow`` cases: the script's
  documented harvest on both sides, and runs/patterns_r5 reproduced
  byte for byte from its first 300 games); an SGF the parser refuses is
  skipped on both sides, and a device error ends the port's harvest.
- strength_campaign at tests/test_torch_pipeline.py's micro
  configuration (the preset monkeypatched in both packages, its gate
  margin at -1 so every generation promotes, the duels replaced by one
  scripted stand-in that records its calls): the seeded store, the
  campaign.jsonl events and keys, the duels asked for (the michi rung
  doubling, the 130-move cap), the store layout and the promotion rule;
  a second call resumes.
- strength_report and ladder_continuation on one micro store with real
  duels: the strength.jsonl events and keys and the SGF file names.
- train_19x19: ``make_config`` field by field, one whole corpus game
  at 8 simulations with JAX's draws handed in, SGF byte-equal, and real
  games linked into the corpus only from a directory the caller names.
- Every CLI takes its script's flags, names and defaults, plus
  ``--device``.
"""
import argparse
import dataclasses
import filecmp
import json
import logging
import os
import pathlib
import runpy
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from sejonggo_tpu import config as jcfg
from sejonggo_torch import config as tcfg
from sejonggo_torch.goenv.positions import random_positions
from sejonggo_torch.pipeline import Pipeline
from sejonggo_torch.tools import (build_patterns, calibrate_slow_loop,
                                  ladder_continuation, strength_campaign,
                                  strength_report, train_19x19)
from test_torch_games import jax_draws
from test_torch_heuristics import one_torch_thread  # noqa: F401
from test_torch_pipeline import micro_config

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
DUELS_9 = str(REPO / "runs/strength_r4/duels")
DUELS_9B = str(REPO / "runs/strength_r4b/duels")
CORPUS_19 = str(REPO / "runs/full19_r5/corpus")

TOOLS = {"build_patterns": build_patterns,
         "strength_campaign": strength_campaign,
         "strength_report": strength_report,
         "ladder_continuation": ladder_continuation,
         "train_19x19": train_19x19,
         "calibrate_slow_loop": calibrate_slow_loop}


@pytest.fixture(autouse=True)
def root_handlers():
    """The tools and scripts install logging handlers (setup_logging);
    take them off again after each test."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def run_script(name, argv, monkeypatch):
    """Run scripts/<name>.py as __main__ with ``argv``."""
    path = str(SCRIPTS / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + list(argv))
    runpy.run_path(path, run_name="__main__")


def script_module(name):
    """scripts/<name>.py's globals, without running its main."""
    return runpy.run_path(str(SCRIPTS / f"{name}.py"),
                          run_name=f"script_{name}")


# --- flags -----------------------------------------------------------------

class _Parsed(Exception):
    pass


def _options(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.choices,
                                      a.nargs, a.required, type(a).__name__)
            for a in parser._actions if a.option_strings
            and a.dest != "help"}


def _parser_of(call, monkeypatch):
    captured = {}

    def fake_parse(self, args=None, namespace=None):
        captured["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", fake_parse)
        with pytest.raises(_Parsed):
            call()
    return captured["parser"]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_cli_flags_are_the_scripts_plus_device(name, monkeypatch):
    path = str(SCRIPTS / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path])
    want = _options(_parser_of(
        lambda: runpy.run_path(path, run_name="__main__"), monkeypatch))
    got = _options(_parser_of(lambda: TOOLS[name].main([]), monkeypatch))
    device = got.pop(("--device",))
    assert device[:2] == ("device", None)
    assert got == want


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_patterns.main(["--sgf-dirs", DUELS_9, "--max-games", "1",
                             "--out-dir", "unused"])


# --- build_patterns ----------------------------------------------------------

def _chars(stones):
    out = np.full(stones.shape, ".", dtype="<U1")
    out[stones == 1] = "X"
    out[stones == -1] = "x"
    return out


def test_canonical_neighborhoods_match_script():
    script = script_module("build_patterns")["canonical_neighborhoods"]
    boards = [s for s in random_positions(9, 2, 30, 1, contact=0.8)[0][-2:]]
    boards.append(random_positions(19, 1, 120, 2, contact=0.8)[0][-1])
    from sejonggo_torch.search.patterns import GRIDCULAR_SEQ

    for stones in boards:
        chars = _chars(stones.numpy())
        n = chars.shape[0]
        assert (chars != ".").any()
        for groups in (4, len(GRIDCULAR_SEQ)):
            for y in range(n):
                for x in range(n):
                    assert build_patterns.canonical_neighborhoods(
                        chars, y, x, groups) == script(chars, y, x, groups)


def _harvest_both(tmp_path, monkeypatch, argv):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    run_script("build_patterns", argv + ["--out-dir", str(jdir)], monkeypatch)
    out = build_patterns.main(argv + ["--out-dir", str(tdir),
                                      "--device", "cpu"])
    for f in ("patterns.spat", "patterns.prob"):
        assert filecmp.cmp(jdir / f, tdir / f, shallow=False), f
    return out, tdir


@pytest.mark.parametrize("argv", [
    ["--sgf-dirs", DUELS_9, "--max-games", "6"],
    ["--sgf-dirs", CORPUS_19, "--size", "19", "--max-games", "2"],
], ids=["9x9-duels", "19x19-corpus"])
def test_harvest_files_equal_script(argv, tmp_path, monkeypatch):
    out, _ = _harvest_both(tmp_path, monkeypatch, argv)
    assert out["games"] == int(argv[-1]) and out["kept"] > 0


def test_harvest_skips_unparseable_sgf_only(tmp_path, monkeypatch):
    """An SGF the parser refuses is skipped on both sides (the files stay
    byte-equal); an error of the replay's device ends the harvest."""
    sgfs = tmp_path / "sgfs"
    sgfs.mkdir()
    for f in sorted(pathlib.Path(DUELS_9).rglob("*.sgf"))[:2]:
        shutil.copy(f, sgfs / f.name)
    (sgfs / "0_bad.sgf").write_text("(;GM[1]SZ[x];B[cc])")
    out, _ = _harvest_both(tmp_path, monkeypatch,
                           ["--sgf-dirs", str(sgfs), "--max-games", "3"])
    assert out["games"] == 2

    from sejonggo_torch.io import kgs

    def device_fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(kgs, "replay_sgf", device_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        build_patterns.main(["--sgf-dirs", str(sgfs), "--out-dir",
                             str(tmp_path / "fault"), "--device", "cpu"])


@pytest.mark.slow
def test_whole_harvest_equals_script(tmp_path, monkeypatch):
    """The script's documented harvest (its default 400 games) on both
    sides."""
    out, tdir = _harvest_both(tmp_path, monkeypatch,
                              ["--sgf-dirs", DUELS_9, DUELS_9B])
    committed = REPO / "runs/patterns_r5"
    same = all(filecmp.cmp(committed / f, tdir / f, shallow=False)
               for f in ("patterns.spat", "patterns.prob"))
    print(f"harvest: {out}; equal to runs/patterns_r5: {same}")


@pytest.mark.slow
def test_harvest_reproduces_committed_store(tmp_path):
    """runs/patterns_r5 (its header: 300 games, 19,572 positions) is the
    harvest of the first 300 games of the two duel directories."""
    out = build_patterns.main(["--sgf-dirs", DUELS_9, DUELS_9B,
                               "--max-games", "300", "--out-dir",
                               str(tmp_path), "--device", "cpu"])
    assert (out["games"], out["positions"]) == (300, 19572)
    for f in ("patterns.spat", "patterns.prob"):
        assert filecmp.cmp(REPO / "runs/patterns_r5" / f, tmp_path / f,
                           shallow=False), f


# --- strength_campaign -------------------------------------------------------

def micro_campaign_config(cfgmod):
    """The micro configuration with a gate that always promotes."""
    cfg = micro_config(cfgmod)
    return cfg.replace(eval=dataclasses.replace(cfg.eval, margin=-1.0))


class ScriptedDuels:
    """Stands in for learn.duel.duel in both packages: records each call
    and answers michi 0.6 and the heuristic duels ``heuristic`` in turn."""

    def __init__(self, heuristic=(0.4, 0.8, 0.8)):
        self.calls = []
        self.heuristic = iter(heuristic)

    def __call__(self, a, b, *, cfg, model_dir, games, **kw):
        self.calls.append((a, b, games, kw.get("michi_sims"),
                           kw.get("max_moves"),
                           os.path.basename(kw.get("sgf_dir") or "")))
        wr = 0.6 if b == "michi" else next(self.heuristic)
        res = {"winrate": wr, "elo_diff_a_vs_b": 10.0 * wr}
        if b == "michi":
            res["michi_resigns"] = 1
        return res


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _printed(out, event):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{") and json.loads(line).get("event") == event]


def test_campaign_like_script(tmp_path, monkeypatch, capsys):
    seed_dir = tmp_path / "seed"
    Pipeline(micro_config(tcfg), str(seed_dir), seed=5,
             device="cpu").init_models()
    seed_from = tmp_path / "model_7.msgpack"
    shutil.copy(seed_dir / "sp_models/model_1.msgpack", seed_from)
    argv = ["--generations", "2", "--probe-every", "1", "--probe-games", "4",
            "--confirm-games", "6", "--michi-rung", "800",
            "--michi-probe-games", "2", "--target-winrate", "0.7",
            "--seed-from", str(seed_from)]
    import sejonggo_tpu.learn.duel as jduel
    import sejonggo_torch.learn.duel as tduel

    monkeypatch.setattr(jcfg, "strength_9x9",
                        lambda: micro_campaign_config(jcfg))
    monkeypatch.setattr(tcfg, "strength_9x9",
                        lambda: micro_campaign_config(tcfg))
    jduels, tduels = ScriptedDuels(), ScriptedDuels()
    monkeypatch.setattr(jduel, "duel", jduels)
    monkeypatch.setattr(tduel, "duel", tduels)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"

    run_script("strength_campaign", argv + ["--workdir", str(jdir)],
               monkeypatch)
    jstart = _printed(capsys.readouterr().out, "campaign_start")
    end = strength_campaign.main(argv + ["--workdir", str(tdir),
                                         "--device", "cpu"])
    tstart = _printed(capsys.readouterr().out, "campaign_start")

    # the seeded store
    for f in ("model_7.msgpack", "index.json"):
        assert filecmp.cmp(jdir / "sp_models" / f, tdir / "sp_models" / f,
                           shallow=False), f
    assert tstart == jstart == [{"event": "campaign_start", "resumed": False,
                                 "best": "model_7", "latest": "model_7"}]
    # the events, their keys, the duels asked for
    jev, tev = _jsonl(jdir / "campaign.jsonl"), _jsonl(tdir / "campaign.jsonl")
    assert [e["event"] for e in tev] == [e["event"] for e in jev] == [
        "generation", "michi_probe", "michi_probe", "michi_rung_confirmed",
        "heuristic_probe", "generation", "michi_probe", "michi_probe",
        "michi_rung_confirmed", "heuristic_probe", "heuristic_probe",
        "target_reached", "campaign_done"]
    for t, j in zip(tev, jev):
        assert sorted(t) == sorted(j), t["event"]
        if t["event"] != "generation":
            clock = ("seconds", "hours")
            assert {k: v for k, v in t.items() if k not in clock} == \
                {k: v for k, v in j.items() if k not in clock}
    assert tduels.calls == jduels.calls == [
        ("model_8", "michi", 2, 800, 130, ""),
        ("model_8", "michi", 64, 800, 130, "model_8_vs_michi800"),
        ("model_8", "heuristic", 4, None, None, ""),
        ("model_9", "michi", 2, 1400, 130, ""),
        ("model_9", "michi", 64, 1400, 130, "model_9_vs_michi1400"),
        ("model_9", "heuristic", 4, None, None, ""),
        ("model_9", "heuristic", 6, None, None, "model_9_vs_heuristic")]
    assert end == tev[-1]
    # the store and the promotion rule
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir / "sp_models")) == \
        sorted(os.listdir(jdir / "sp_models"))
    for d in (jdir, tdir):
        gates = [e for e in _jsonl(d / "metrics.jsonl")
                 if e["event"] == "evaluate"]
        assert [g["promote"] for g in gates] == [True, True]
        assert all(g["promote"] == (g["winrate"] > -1.0) for g in gates)
        assert json.load(open(d / "sp_models/index.json")) == \
            {"best": "model_9"}

    # a second call resumes the run
    monkeypatch.setattr(tduel, "duel", ScriptedDuels(heuristic=[0.25]))
    strength_campaign.main(["--workdir", str(tdir), "--generations", "1",
                            "--device", "cpu"])
    (again,) = _printed(capsys.readouterr().out, "campaign_start")
    assert again == {"event": "campaign_start", "resumed": True,
                     "best": "model_9", "latest": "model_9"}
    tev2 = _jsonl(tdir / "campaign.jsonl")[len(tev):]
    assert [e["event"] for e in tev2] == ["generation", "heuristic_probe",
                                          "campaign_done"]
    assert tev2[0]["best"] == "model_10" and tev2[0]["promotions"] == 1
    assert tev2[-1]["reached_target"] is False


# --- strength_report and ladder_continuation ---------------------------------

def test_ladder_tools_like_scripts(tmp_path, monkeypatch, capsys):
    import sejonggo_tpu.learn.duel as jduel
    import sejonggo_torch.learn.duel as tduel

    jmicro, tmicro = micro_config(jcfg), micro_config(tcfg)
    monkeypatch.setattr(jcfg, "small_9x9", lambda: jmicro)
    monkeypatch.setattr(tcfg, "small_9x9", lambda: tmicro)
    gtp_calls = []

    def fake_gtp(tag):
        def duel_vs_gtp(checkpoint, command, *, cfg, model_dir, games, **kw):
            gtp_calls.append((tag, checkpoint, command, games))
            return {"wins": 1, "games": games, "winrate": 1 / games,
                    "elo_diff": 0.0}
        return duel_vs_gtp

    monkeypatch.setattr(jduel, "duel_vs_gtp", fake_gtp("jax"))
    monkeypatch.setattr(tduel, "duel_vs_gtp", fake_gtp("port"))
    seed_dir = tmp_path / "seed"
    Pipeline(micro_config(tcfg), str(seed_dir), seed=6,
             device="cpu").init_models()
    for side in ("jax", "port"):
        models = tmp_path / side / "sp_models"
        models.mkdir(parents=True)
        for i in (1, 2, 3, 4):
            shutil.copy(seed_dir / "sp_models/model_1.msgpack",
                        models / f"model_{i}.msgpack")
        (models / "index.json").write_text(json.dumps({"best": "model_4"}))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    report = ["--preset", "tiny", "--games", "2", "--gtp", "engine --gtp"]
    run_script("strength_report", report + ["--workdir", str(jdir)],
               monkeypatch)
    strength_report.main(report + ["--workdir", str(tdir), "--device", "cpu"])
    cont = ["--preset", "tiny", "--games", "2", "--seed-model", "model_3"]
    run_script("ladder_continuation", cont + ["--workdir", str(jdir)],
               monkeypatch)
    ladder_continuation.main(cont + ["--workdir", str(tdir),
                                     "--device", "cpu"])
    capsys.readouterr()

    assert gtp_calls == [("jax", "model_4", "engine --gtp", 2),
                         ("port", "model_4", "engine --gtp", 2)]
    jev, tev = _jsonl(jdir / "strength.jsonl"), _jsonl(tdir / "strength.jsonl")
    assert [(e["event"], e.get("a"), e.get("b")) for e in tev] == \
        [(e["event"], e.get("a"), e.get("b")) for e in jev] == [
            ("duel", "model_4", "model_1"), ("duel", "model_4", "model_2"),
            ("duel", "model_4", "heuristic"),
            ("duel_gtp", "model_4", "gtp:engine --gtp"),
            ("duel", "model_4", "model_3"), ("duel", "model_4", "heuristic")]
    for t, j in zip(tev, jev):
        assert sorted(t) == sorted(j), (t["event"], t.get("b"))
        assert t["games"] == j["games"] == 2

    def sgfs(d):
        return sorted(str(p.relative_to(d)) for p in (d / "duels").rglob("*"))

    assert sgfs(tdir) == sgfs(jdir)
    assert len([p for p in sgfs(tdir) if p.endswith(".sgf")]) == 8


# --- train_19x19 -------------------------------------------------------------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _config_equal(tc, jc):
    """Every field of the port's Config equal to JAX's, section by section."""
    for name, tval in _fields(tc).items():
        jval = getattr(jc, name)
        if dataclasses.is_dataclass(tval):
            assert _fields(tval) == _fields(jval), name
        else:
            assert tval == jval, name


@pytest.mark.parametrize("args", [
    (8, 8, 8, 8, None),          # the script's defaults
    (2, 8, 2, 1, 60),            # the smoke's arguments
], ids=["defaults", "smoke"])
def test_make_config_matches_script(args):
    script = script_module("train_19x19")["make_config"]
    _config_equal(train_19x19.make_config(*args), script(*args))
    flags = train_19x19.parse_args([])
    _config_equal(train_19x19.config_of(flags), script(8, 8, 8, 8, None))


def test_corpus_game_sgf_equals_script(tmp_path):
    """One 19x19 corpus game of the heuristic engine at 8 simulations,
    played to its end by both, with JAX's draws handed to the port: the
    SGF files are byte-equal."""
    script = script_module("train_19x19")["generate_corpus"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    seed = 11
    assert script(str(jdir), games=1, game_batch=1, sims=8, seed=seed) == 1
    search = train_19x19.corpus_search(8)

    def draws(batch_i):
        rng = jax.random.PRNGKey(seed)
        for _ in range(batch_i + 1):
            rng, sub = jax.random.split(rng)
        return jax_draws(sub, search, 1, 19, selfplay=True,
                         per_game_symmetry=False)

    assert train_19x19.generate_corpus(
        str(tdir), games=1, game_batch=1, sims=8, seed=seed, device="cpu",
        draws=draws) == 1
    assert os.listdir(tdir) == os.listdir(jdir) == ["rollout_00_000.sgf"]
    assert filecmp.cmp(jdir / "rollout_00_000.sgf",
                       tdir / "rollout_00_000.sgf", shallow=False)


@pytest.mark.parametrize("named", [False, True], ids=["default", "named"])
def test_train_merges_only_named_games(named, tmp_path):
    """``train`` links real games into the corpus only from the directory
    its caller names; by default it reads nothing outside its workdir."""
    games = tmp_path / "real_games"
    games.mkdir()
    src = sorted(pathlib.Path(CORPUS_19).glob("rollout_*.sgf"))[:2]
    for f in src:
        shutil.copy(f, games / f.name)
    (games / "notes.txt").write_text("not a game")
    workdir = tmp_path / "work"
    args = train_19x19.parse_args([
        "--workdir", str(workdir), "--generations", "0", "--skip-corpus",
        "--skip-pretrain", "--device", "cpu"])
    events = train_19x19.train(micro_config(tcfg), args,
                               reference_games=str(games) if named
                               else None)
    assert [e["event"] for e in events] == ["start", "done"]
    corpus = workdir / "corpus"
    linked = sorted(os.listdir(corpus))
    if not named:
        assert linked == []
        return
    assert linked == [f.name for f in src]
    for name in linked:
        assert (corpus / name).is_symlink()
        assert (corpus / name).resolve() == (games / name).resolve()
