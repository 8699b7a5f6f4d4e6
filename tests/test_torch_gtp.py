"""The port's GTP engine (sejonggo_torch.io.gtp) against the JAX
package's: one command script through both GTPFrontends, on the dummy net
and on a seeded float32 net at 9x9.  The JAX engine splits its key for
the root noise, the search symmetries and the decision; ``gtp_draws``
makes the same draws and hands them to the port.  Every response must be
equal except name/version, which report the port: genmove vertices
(also a forced colour on a kept tree, and resign), showboard,
final_score, sg_showtree, known_command, list_commands, errors and
command ids.  The JAX engine's search runs jitted (``jitted_search``),
as the port's other parity tests hold it to the jitted JAX functions.
The command line runs the port's engine on the CPU."""
import functools
import io
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.config import SearchConfig as JSearch
from sejonggo_tpu.io import gtp as jgtp
from sejonggo_tpu.io.gtp import GoEngine as JEngine
from sejonggo_tpu.io.gtp import GTPFrontend as JFrontend
from sejonggo_tpu.nets import dummy_actor_fn
from sejonggo_torch import __version__
from sejonggo_torch.config import SearchConfig
from sejonggo_torch.io.gtp import GoEngine, GTPFrontend
from sejonggo_torch.nets import dummy_predict_fn
from test_torch_games import seeded_nets

SIZE = 9
SCRIPT = """protocol_version
7 protocol_version
name
version
boardsize 13
boardsize 9
komi 6.5
clear_board
sg_showtree
genmove B
sg_showtree 2 3
play W D4
genmove B
genmove B
showboard
genmove w
12 genmove b
play W pass
genmove B
sg_showtree 3 2
final_score
known_command genmove
known_command bogus_cmd
list_commands
bogus_cmd 1 2
play X D4
play W
3 final_score
clear_board
showboard
genmove W
final_score
quit
"""


def gtp_draws(seed, search, size):
    """draws(noise) for the port's GoEngine: the JAX engine's key chain
    (rng, sub = split(rng) for the noise when a fresh tree gets it, then
    for the search, then for the decision), drawn in its order."""
    state = {"rng": jax.random.PRNGKey(seed)}
    a = size * size + 1

    def split():
        state["rng"], sub = jax.random.split(state["rng"])
        return sub

    def draws(noise):
        out = {}
        if noise:
            out["noise"] = torch.from_numpy(np.array(jax.random.dirichlet(
                split(), jnp.full((a,), search.dirichlet_alpha, jnp.float32),
                (1,))))
        r = split()
        if search.use_symmetry:
            syms = []
            for _ in range(search.simulations // search.batch_size):
                r, s = jax.random.split(r)
                syms.append(int(jax.random.randint(s, (), 0, 7)))
            out["syms"] = syms
        (k,) = jax.random.split(split(), 1)
        out["gumbel"] = torch.from_numpy(
            np.array(jax.random.gumbel(k, (a,), jnp.float32))[None])
        return out

    return draws


JAX_RUN_SEARCH = jgtp.run_search


@pytest.fixture(autouse=True)
def jitted_search(monkeypatch):
    """The JAX GoEngine calls run_search eagerly (seconds per genmove on
    the CPU); run it under jit, one compile per engine (its predict
    closure is made once, in the engine's __init__)."""
    compiled = {}

    def run_search(trees, predict_fn, rng, **kw):
        key = (predict_fn, tuple(sorted(kw.items())))
        if key not in compiled:
            compiled[key] = jax.jit(functools.partial(
                JAX_RUN_SEARCH, predict_fn=predict_fn, **kw))
        return compiled[key](trees, rng=rng)

    monkeypatch.setattr(jgtp, "run_search", run_search)


def _transcript(frontend, script):
    return [frontend.parse_command(line) for line in script.splitlines()]


def _pair(net, seed=0, **kw):
    kw = dict(simulations=16, batch_size=8, use_symmetry=True,
              dirichlet_alpha=0.3, **kw)
    js, ts = JSearch(**kw), SearchConfig(**kw)
    if net == "dummy":
        jpred, variables, tpred = dummy_actor_fn, None, dummy_predict_fn
    else:
        jpred, variables, tpred = seeded_nets(SIZE, 3)
    return js, ts, jpred, variables, tpred


@pytest.mark.parametrize("net,engine_kw", [
    ("dummy", {}),
    ("seeded", {}),
    ("seeded", dict(add_noise=True, temperature=1, seed=5)),
])
def test_gtp_transcript_matches_jax(net, engine_kw):
    js, ts, jpred, variables, tpred = _pair(net)
    common = dict(size=SIZE, komi=5.5, **engine_kw)
    jeng = JEngine(jpred, variables, search=js, **common)
    teng = GoEngine(tpred, search=ts, device="cpu",
                    draws=gtp_draws(engine_kw.get("seed", 0), ts, SIZE),
                    **common)
    jout = _transcript(JFrontend(jeng), SCRIPT)
    tout = _transcript(GTPFrontend(teng), SCRIPT)
    lines = SCRIPT.splitlines()
    for line, j, t in zip(lines, jout, tout):
        if line in ("name", "version"):
            continue
        assert t == j, line
    assert tout[lines.index("name")] == "= sejonggo-torch - 16 simulations\n\n"
    assert tout[lines.index("version")] == f"= {__version__}\n\n"
    assert any("INCONSISTENT" not in t and "root: N=" in t for t in tout)
    assert np.array_equal(np.asarray(jeng.board), teng.board.numpy())


def test_gtp_resign_and_kept_tree_match_jax():
    """An engine that resigns below a value (the seeded net's values sit
    near 0: resign at 2.0 resigns at once), and the tree kept across the
    engine's own move and the opponent's reply."""
    js, ts, jpred, variables, tpred = _pair("seeded")
    jeng = JEngine(jpred, variables, search=js, size=SIZE, komi=5.5,
                   resign=2.0)
    teng = GoEngine(tpred, search=ts, size=SIZE, komi=5.5, resign=2.0,
                    device="cpu", draws=gtp_draws(0, ts, SIZE))
    script = "genmove B\nplay B C3\nshowboard\ngenmove W\n"
    jout = _transcript(JFrontend(jeng), script)
    assert jout == _transcript(GTPFrontend(teng), script)
    assert jout[0] == "= resign\n\n" and jout[3] == "= resign\n\n"

    teng = GoEngine(dummy_predict_fn, search=ts, size=SIZE, komi=5.5,
                    device="cpu", draws=gtp_draws(0, ts, SIZE))
    gtp = GTPFrontend(teng)
    gtp.parse_command("genmove B")
    assert teng.tree_valid       # the search expanded the move it chose
    n_before = int(teng.tree.root_N[0])
    gtp.parse_command("genmove W")
    assert teng.tree_valid and int(teng.tree.root_N[0]) >= n_before


def test_gtp_off_board_vertex_is_an_error():
    """The port refuses a vertex off the board; the JAX engine answers
    "=" and plays it as a clamped index (its one response the port does
    not copy)."""
    eng = GoEngine(dummy_predict_fn, size=SIZE, komi=5.5, device="cpu",
                   search=SearchConfig(simulations=8, batch_size=4,
                                       use_symmetry=False))
    gtp = GTPFrontend(eng)
    for vertex in ("Z99", "A10", "J0"):
        assert gtp.parse_command(f"play W {vertex}") == \
            f"? vertex {vertex} is off the 9x9 board\n\n"
    assert eng.move_n == 0
    assert gtp.parse_command("play W J9") == "=\n\n"


def test_gtp_command_line_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "sejonggo_torch.io.gtp", "--preset", "tiny",
         "--dummy", "--device", "cpu"],
        input="boardsize 9\ngenmove B\nplay W D4\nfinal_score\nquit\n",
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    chunks = [c for c in proc.stdout.split("\n\n") if c.strip()]
    assert len(chunks) == 5 and all(c.startswith("=") for c in chunks)
    assert "GTP engine ready" in proc.stderr


def test_gtp_frontend_run_loop():
    eng = GoEngine(dummy_predict_fn, size=SIZE, komi=5.5, device="cpu",
                   search=SearchConfig(simulations=8, batch_size=4,
                                       use_symmetry=False))
    out = io.StringIO()
    GTPFrontend(eng).run(io.StringIO(
        "protocol_version\n\ngenmove B\ngenmove W\nquit\ngenmove B\n"), out)
    chunks = [c for c in out.getvalue().split("\n\n") if c.strip()]
    assert len(chunks) == 4 and all(c.startswith("=") for c in chunks)
    assert eng.move_n == 2


MICHI_SCRIPT = """name
boardsize 9
komi 5.5
genmove B
play W D4
genmove B
showboard
genmove W
final_score
quit
"""


def test_gtp_michi_engine_matches_jax():
    """--engine michi with the committed pattern files (the table at
    every expansion, the host matcher at the root): one script through
    both frontends, JAX's searcher draws handed in (one key split a
    genmove, one a chunk)."""
    from sejonggo_tpu.config import MichiConfig as JMichi
    from sejonggo_tpu.io.gtp import MichiEngine as JMichiEngine
    from sejonggo_torch.config import MichiConfig
    from sejonggo_torch.io.gtp import MichiEngine
    from test_torch_michi import PROB, SPAT, jax_searcher_draws

    kw = dict(komi=5.5, n_sims=16, playout_parallel=4, expand_visits=2)
    jeng = JMichiEngine(size=SIZE, komi=5.5, michi=JMichi(**kw), seed=4,
                        spat_file=SPAT, prob_file=PROB)
    cfg = MichiConfig(**kw)
    state = {"rng": jax.random.PRNGKey(4)}

    def draws():
        state["rng"], sub = jax.random.split(state["rng"])
        return jax_searcher_draws(sub, cfg, 1, SIZE)

    teng = MichiEngine(size=SIZE, komi=5.5, michi=cfg, spat_file=SPAT,
                       prob_file=PROB, device="cpu", draws=draws)
    jout = _transcript(JFrontend(jeng), MICHI_SCRIPT)
    tout = _transcript(GTPFrontend(teng), MICHI_SCRIPT)
    for line, j, t in zip(MICHI_SCRIPT.splitlines(), jout, tout):
        if line != "name":
            assert t == j, line
    assert tout[0] == "= sejonggo-torch - 16 simulations\n\n"
    assert np.array_equal(np.asarray(jeng.board), teng.board.numpy())
    assert teng.move_n == 4


def test_gtp_michi_command_line_on_the_cpu_and_cuda_by_default(monkeypatch):
    # one torch thread in the engine process: the test workers share the
    # machine's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "sejonggo_torch.io.gtp", "--preset", "tiny",
           "--engine", "michi", "--sims", "16", "--spat",
           "runs/patterns_r5/patterns.spat", "--prob",
           "runs/patterns_r5/patterns.prob"]
    script = "genmove B\nplay W D4\ngenmove B\nfinal_score\nquit\n"
    proc = subprocess.run(cmd + ["--device", "cpu"], input=script,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    chunks = [c for c in proc.stdout.split("\n\n") if c.strip()]
    assert len(chunks) == 5 and all(c.startswith("=") for c in chunks)
    assert chunks[1] == "=" and chunks[3][2:4] in ("B+", "W+")
    assert proc.stderr.count("michi genmove: 16 simulations") == 2
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, input=script, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
