"""The port's pattern subsystem (search/patterns.py, search/pattern_lut.py)
against the JAX package's, on the committed pattern files of
runs/patterns_r5: the parsed store, the gridcular neighbourhoods, the
widest-match probabilities, the root bonus, the small-radius table and
its per-board bonus.  All equal exactly (the table and the bonus are
float32 values computed by the same expressions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sejonggo_tpu.search import pattern_lut as JL
from sejonggo_tpu.search import patterns as JP
from sejonggo_torch.search import pattern_lut as TL
from sejonggo_torch.search import patterns as TP
from test_torch_heuristics import played_boards, one_torch_thread  # noqa: F401

SPAT = "runs/patterns_r5/patterns.spat"
PROB = "runs/patterns_r5/patterns.prob"


@pytest.fixture(scope="module")
def stores():
    out = []
    for mod in (JP, TP):
        st = mod.PatternStore()
        n_spat, n_prob = st.load_spat(SPAT), st.load_probs(PROB)
        out.append((st, n_spat, n_prob))
    return out


@pytest.fixture(scope="module")
def boards():
    b, _ = played_boards(9, 4, (12, 30), seed=9)
    return b


def test_store_parses_the_committed_files_as_jax(stores):
    (js, jn, jp), (ts, tn, tp) = stores
    assert (jn, jp) == (tn, tp) and tn > 1000
    assert js.spat == ts.spat and js.probs == ts.probs
    assert bool(ts) and not TP.PatternStore()
    assert TP.GRIDCULAR_SEQ == JP.GRIDCULAR_SEQ


def test_neighborhoods_probabilities_and_root_bonus(stores, boards):
    (js, _, _), (ts, _, _) = stores
    hits = 0
    for bd in boards:
        chars_j = JP._board_chars(bd.numpy())
        chars_t = TP._board_chars(bd)
        assert np.array_equal(chars_j, chars_t)
        for y, x in ((0, 0), (4, 4), (8, 3)):
            assert list(JP.gridcular_neighborhoods(chars_j, y, x)) == \
                list(TP.gridcular_neighborhoods(chars_t, y, x))
        for y in range(9):
            for x in range(9):
                pj = JP.large_pattern_probability(js, bd.numpy(), y, x)
                assert pj == TP.large_pattern_probability(ts, bd, y, x)
                hits += pj is not None
        jb = JP.root_prior_bonus(js, bd.numpy(), 100.0)
        tb = TP.root_prior_bonus(ts, bd, 100.0)
        assert tb.dtype == np.float32 and np.array_equal(jb, tb)
    assert hits > 0
    assert TP.root_prior_bonus(TP.PatternStore(), boards[0], 100.0) is None


def test_small_pattern_lut_and_bonus(stores, boards):
    (js, _, _), (ts, _, _) = stores
    jl, tl = JL.build_small_pattern_lut(js), TL.build_small_pattern_lut(ts)
    assert tl.dtype == np.float32 and tl.shape == (4 ** 8,)
    assert np.array_equal(jl, tl) and tl.max() > 0
    assert np.array_equal(TL.load_small_pattern_lut(SPAT, PROB), tl)
    assert not TL.build_small_pattern_lut(TP.PatternStore()).any()
    fn = jax.jit(jax.vmap(lambda bd: JL.lut_bonus_from(
        bd[:, :, 0] == 1, bd[:, :, 1] == 1, jnp.asarray(jl))))
    want = np.asarray(fn(boards.numpy()))
    got = TL.lut_bonus_from(boards[..., 0] == 1, boards[..., 1] == 1, tl)
    assert np.array_equal(got.numpy(), want) and want.max() > 0
