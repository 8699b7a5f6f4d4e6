"""The port's KGS pretraining path (sejonggo_torch.io.kgs and
Pipeline.kgs_pretrain_phase) against the JAX package's: replayed SGF
samples (handicap, passes, a skipped wrong-size game, a 19x19 corpus
game), the directory loader and the shuffled sample stream for one seed,
three pretraining steps from the same model_1 (model_2 within 1e-4, the
same store names and metric event), the archive extraction, the link
scraper, and the downloader returning 0 when nothing answers."""
import os
import pathlib
import shutil
import tarfile
import zipfile

import jax
import numpy as np
import pytest

from sejonggo_tpu import config as jcfg
from sejonggo_tpu.io import kgs as J
from sejonggo_tpu.pipeline import Pipeline as JPipeline
from sejonggo_torch import config as tcfg
from sejonggo_torch.io import kgs as T
from sejonggo_torch.learn import restore
from sejonggo_torch.pipeline import Pipeline
from test_torch_pipeline import TOL, _events, micro_config

REPO = pathlib.Path(__file__).resolve().parents[1]
GAME = "(;GM[1]FF[4]SZ[9]KM[5.5]RE[B+2.5];B[cc];W[gg];B[cf];W[];B[ff])"
HANDI = "(;GM[1]FF[4]SZ[9]KM[0.5]HA[2]RE[W+R]AB[cc][gg]AW[ee];W[dd];B[cf];W[tt])"
DRAW = "(;GM[1]FF[4]SZ[9]RE[0];B[aa];W[ii])"


def _same_samples(js, ts):
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        assert list(j) == list(t)
        for k in j:
            assert np.array_equal(np.asarray(j[k]), np.asarray(t[k])), k
            assert np.asarray(j[k]).dtype == np.asarray(t[k]).dtype, k


@pytest.mark.parametrize("text,size", [
    (GAME, 9), (HANDI, 9), (DRAW, 9), (GAME.replace("SZ[9]", "SZ[19]"), 9),
    ((REPO / "runs/full19_r5/corpus/rollout_01_007.sgf").read_text(), 19)],
    ids=["game", "handicap", "draw", "wrong_size", "corpus_19x19"])
def test_replay_sgf_matches_jax(text, size):
    ts = T.replay_sgf(text, size, device="cpu")
    _same_samples(J.replay_sgf(text, size), ts)
    if size == 19:
        assert len(ts) > 50


def _corpus(tmp_path):
    d = tmp_path / "kgs"
    (d / "sub").mkdir(parents=True)
    for i, text in enumerate([GAME, HANDI, DRAW, GAME]):
        (d / ("sub" if i % 2 else ".") / f"g{i}.sgf").write_text(text)
    (d / "broken.sgf").write_text("not an sgf at all ;;;[")
    (d / "dangling.sgf").symlink_to(tmp_path / "absent.sgf")
    (d / "notes.txt").write_text(GAME)
    return d


def test_directory_and_stream_match_jax(tmp_path):
    d = str(_corpus(tmp_path))
    assert list(T.iter_sgf_files(d)) == list(J.iter_sgf_files(d))
    for limit in (0, 2):
        for j, t in zip(J.load_kgs_directory(d, 9, limit),
                        T.load_kgs_directory(d, 9, limit, device="cpu")):
            assert np.array_equal(j, t) and j.dtype == t.dtype
    empty = T.load_kgs_directory(str(tmp_path / "kgs" / "sub"), 19,
                                 device="cpu")
    assert [a.shape for a in empty] == [(0, 19, 19, 17), (0, 362), (0,)]
    for seed, loop in ((0, False), (3, True)):
        jstream = J.kgs_sample_stream(d, 9, batch_size=3, loop=loop,
                                      rng=np.random.RandomState(seed))
        tstream = T.kgs_sample_stream(d, 9, batch_size=3, loop=loop,
                                      rng=np.random.RandomState(seed),
                                      device="cpu")
        n = 0
        for jb, tb in zip(jstream, tstream):
            for j, t in zip(jb, tb):
                assert np.array_equal(j, t) and j.dtype == t.dtype
            n += 1
            if n == 9:
                break
        assert n == (15 // 3 if not loop else 9)   # 15 samples in all


def test_kgs_pretrain_phase_matches_jax(tmp_path):
    data = tmp_path / "kgs"
    data.mkdir()
    for i, text in enumerate([GAME, HANDI, GAME]):
        (data / f"g{i}.sgf").write_text(text)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpipe = JPipeline(micro_config(jcfg), str(jdir), seed=0)
    jpipe.init_models()
    tpipe = Pipeline(micro_config(tcfg), str(tdir), seed=0, device="cpu")
    for f in ("model_1.msgpack", "index.json"):
        shutil.copy(jdir / "sp_models" / f, tdir / "sp_models" / f)
    jstats = jpipe.kgs_pretrain_phase(str(data), steps=3, backup_every=2)
    tstats = tpipe.kgs_pretrain_phase(str(data), steps=3, backup_every=2)
    assert sorted(tstats) == sorted(jstats)
    assert (tstats["from"], tstats["to"], tstats["steps"]) == \
        (jstats["from"], jstats["to"], jstats["steps"]) == ("model_1", "model_2", 3)
    for k in ("loss", "policy_ce", "value_mse", "grad_norm"):
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=TOL, atol=TOL)
    assert sorted(os.listdir(tdir / "sp_models")) == \
        sorted(os.listdir(jdir / "sp_models")) == \
        ["backup.msgpack", "index.json", "model_1.msgpack", "model_2.msgpack"]
    want = restore(str(jdir / "sp_models/model_2.msgpack"))
    got = restore(str(tdir / "sp_models/model_2.msgpack"))
    assert int(got["step"]) == int(want["step"]) == 3
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=str(path))
    (tev,), (jev,) = _events(str(tdir)), _events(str(jdir))
    assert tev["event"] == jev["event"] == "kgs_pretrain"
    assert sorted(tev) == sorted(jev)


def test_extract_archives_matches_jax(tmp_path):
    src = tmp_path / "archives"
    src.mkdir()
    with zipfile.ZipFile(src / "a.zip", "w") as z:
        z.writestr("kgs/a.sgf", GAME)
    with tarfile.open(src / "b.tar.gz", "w:gz") as t:
        t.add(_corpus(tmp_path) / "g0.sgf", arcname="kgs/b.sgf")
    (src / "c.txt").write_text("neither")
    counts = [mod.extract_archives(str(src), str(tmp_path / name))
              for name, mod in (("jax", J), ("port", T))]
    assert counts == [2, 2]
    assert sorted(os.listdir(tmp_path / "port" / "kgs")) == \
        sorted(os.listdir(tmp_path / "jax" / "kgs")) == ["a.sgf", "b.sgf"]


def test_scrape_links_and_offline_download_match_jax(tmp_path):
    html = ('<a href="https://example.org/games/a.sgf">a</a>'
            '<a href="http://example.org/games/b.sgf">b</a>'
            '<a href="https://example.org/games/a.sgf">dup</a>'
            '<a href="https://example.org/index.html">idx</a>')
    for suffix in ("", ".sgf", ".zip"):
        assert T.scrape_links(html, suffix) == J.scrape_links(html, suffix)
    assert T.scrape_links(html, ".sgf") == ["https://example.org/games/a.sgf",
                                            "http://example.org/games/b.sgf"]
    assert T.download_index("http://127.0.0.1:1/none.html",
                            str(tmp_path)) == 0
    assert T.download_archives(["http://127.0.0.1:1/x.zip"],
                               str(tmp_path / "d")) == 0
    assert os.listdir(tmp_path / "d") == []
