"""The port's michi/RAVE engine (sejonggo_torch.search.michi) against the
JAX package's, with JAX's own draws handed in.

``jax_round_draws`` rebuilds JAX's key tree: ``split(rng, 3)`` a round;
``split(r1, k)``, ``split(., b)`` and one ``split`` a level for the
descents' jitter; ``split(r2, steps)``, ``split(., k*b)`` and
``split(., 6)`` for the playout (five Bernoulli gates as uniforms, the
categorical move as Gumbels).  With those, the integer outputs match
exactly; the float fields (priors, win and AMAF-win sums) are compared
with tolerance 0 as well: the port rounds as XLA's CPU code does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sejonggo_tpu.config import MichiConfig as JMichi
from sejonggo_tpu.goenv import engine as JE
from sejonggo_tpu.search import michi as JM
from sejonggo_tpu.search.pattern_lut import \
    load_small_pattern_lut as j_load_lut
from sejonggo_torch.config import MichiConfig
from sejonggo_torch.search import michi as M
from sejonggo_torch.search.pattern_lut import load_small_pattern_lut
from test_torch_heuristics import cases_9x9, one_torch_thread  # noqa: F401

SPAT = "runs/patterns_r5/patterns.spat"
PROB = "runs/patterns_r5/patterns.prob"
FLOAT_ATOL = 0.0     # float tree fields: bit-equal
SEARCH_KW = dict(n_sims=32, playout_parallel=4, expand_visits=2)


def _keys_levels(key, levels, a_dim):
    def lvl(rng, _):
        rng, sub = jax.random.split(rng)
        return rng, jax.random.uniform(sub, (a_dim,), maxval=1e-6)

    return lax.scan(lvl, key, None, length=levels)[1]


@jax.jit
def _playout_keys(r2, kb_proto, steps_proto, nn_proto):
    kb, steps, nn = kb_proto.shape[0], steps_proto.shape[0], nn_proto.shape[0]

    def per_board(key):
        r = jax.random.split(key, 6)
        gates = jnp.stack([jax.random.uniform(r[i]) for i in range(5)])
        return gates, jax.random.gumbel(r[5], (nn,))

    def per_step(key):
        return jax.vmap(per_board)(jax.random.split(key, kb))

    return jax.vmap(per_step)(jax.random.split(r2, steps))


def playout_draws(r2, kb, steps, nn):
    """{"gates": (S, kb, 5), "gumbel": (S, kb, nn)} of mc_playout_batch's
    key ``r2``."""
    g, u = _playout_keys(r2, jnp.zeros(kb), jnp.zeros(steps), jnp.zeros(nn))
    return {"gates": torch.from_numpy(np.array(g)),
            "gumbel": torch.from_numpy(np.array(u))}


@jax.jit
def _jitter(r1, k_proto, b_proto, d_proto, a_proto):
    k, b, d, a = (x.shape[0] for x in (k_proto, b_proto, d_proto, a_proto))

    def per_j(rj):
        return jax.vmap(lambda g: _keys_levels(g, d, a))(jax.random.split(rj, b))

    return jnp.transpose(jax.vmap(per_j)(jax.random.split(r1, k)), (0, 2, 1, 3))


def jax_round_draws(rng, cfg, b, size):
    """draws(r) for michi_search_batch: JAX's per-round key chain from
    ``rng`` (rng, r1, r2 = split(rng, 3) once a round), in round order."""
    k = max(1, cfg.playout_parallel)
    d, a, steps = cfg.max_depth(size), size * size + 1, cfg.playout_cap(size)
    state = {"rng": rng, "next": 0}

    def draws(r):
        assert r == state["next"]
        state["rng"], r1, r2 = jax.random.split(state["rng"], 3)
        state["next"] += 1
        jit = _jitter(r1, jnp.zeros(k), jnp.zeros(b), jnp.zeros(d), jnp.zeros(a))
        return {"jitter": torch.from_numpy(np.array(jit)),
                **playout_draws(r2, k * b, steps, size * size)}

    return draws


def jax_searcher_draws(rng, cfg, b, size):
    """draws(chunk, round) for MichiSearcher: JAX's searcher splits its
    key once a chunk (rng, sub = split(rng)) and runs the chunk from sub."""
    state = {"rng": rng, "chunk": -1, "draws": None}

    def draws(c, r):
        if c != state["chunk"]:
            assert c == state["chunk"] + 1
            state["rng"], sub = jax.random.split(state["rng"])
            state["chunk"], state["draws"] = c, jax_round_draws(sub, cfg, b, size)
        return state["draws"](r)

    return draws


def tree_equal(jtree, ttree, prefix=""):
    for name, t in ttree.fields().items():
        j = np.asarray(getattr(jtree, name))
        t = t.numpy()
        assert j.shape == t.shape, (prefix, name)
        if t.dtype == np.float32:
            np.testing.assert_allclose(t, j, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=f"{prefix}{name}")
        else:
            bad = np.argwhere(j != t)
            assert not bad.size, f"{prefix}{name}: {len(bad)} differ at {bad[:4]}"


@pytest.fixture(scope="module")
def boards():
    b, last = cases_9x9()
    return b, last


@pytest.fixture(scope="module")
def luts():
    return torch.from_numpy(load_small_pattern_lut(SPAT, PROB)), \
        jnp.asarray(j_load_lut(SPAT, PROB))


def test_priors_and_playable_match_jax(boards, luts):
    b, last = boards
    tlut, jlut = luts
    assert float(tlut.max()) > 0
    cfg, jcfg = MichiConfig(), JMichi()
    for lut_t, lut_j in ((None, None), (tlut, jlut)):
        fn = jax.jit(jax.vmap(lambda bd, la: JM.michi_priors(
            bd, la, jcfg, pattern_lut=lut_j)))
        jpv, jpw = fn(b.numpy(), last.numpy())
        pv, pw = M.michi_priors(b, last, cfg, lut_t)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jpv), rtol=0,
                                   atol=FLOAT_ATOL)
        np.testing.assert_allclose(pw.numpy(), np.asarray(jpw), rtol=0,
                                   atol=FLOAT_ATOL)
    play = jax.jit(jax.vmap(JM.playable_mask))(b.numpy())
    assert np.array_equal(M.playable_mask(b).numpy(), np.asarray(play))


def test_root_with_pattern_bonus_matches_jax(boards, luts):
    """The host matcher's root bonus and the table's term at the root, as
    the JAX searcher builds a root with a bonus (vmap, op by op)."""
    from sejonggo_tpu.search import patterns as JP
    from sejonggo_torch.search import patterns as TP

    b, last = boards
    tlut, jlut = luts
    b, last = b[:4], last[:4]
    js, ts = JP.PatternStore(), TP.PatternStore()
    for st in (js, ts):
        st.load_spat(SPAT)
        st.load_probs(PROB)
    cfg, jcfg = MichiConfig(), JMichi()
    jb = np.stack([JP.root_prior_bonus(js, x, 100.0) for x in b.numpy()])
    tb = np.stack([TP.root_prior_bonus(ts, x, 100.0) for x in b])
    assert np.array_equal(jb, tb) and jb.max() > 0
    jt = jax.vmap(lambda bd, la, rb: JM.new_michi_tree(
        bd, jcfg, last_action=la, root_bonus=rb, pattern_lut=jlut))(
        b.numpy(), last.numpy(), jnp.asarray(jb))
    tt = M.new_michi_tree_batch(b, cfg, last, tlut, torch.from_numpy(tb))
    tree_equal(jt, tt, "root ")


def _playout_oracle(boards, amaf, rng, cfg, last, last2):
    """JAX's mc_playout_batch with its final stones and side returned:
    the same scan over JAX's own _playout_choose and gostep path."""
    b, n = boards.shape[0], boards.shape[-3]
    nn = n * n
    side = boards[:, 0, 0, 16].astype(jnp.int8)
    stones = jax.vmap(JE.signed_stones)(boards)
    prev = ((boards[..., 2].astype(jnp.int8) - boards[..., 3].astype(jnp.int8))
            * side[:, None, None])
    illegal = JE.illegal_moves_mask_stones_batch(stones, prev, side)
    rows = jnp.arange(b)

    def body(carry, rng_step):
        stones, illegal, side, amaf, passes, last, last2 = carry
        done = passes >= 2
        actions = JM._playout_choose(stones, side, illegal, last, last2,
                                     jax.random.split(rng_step, b), cfg)
        any_move = actions < nn
        cur = amaf[rows, actions]
        amaf = amaf.at[rows, actions].set(
            jnp.where(any_move & (cur == 0) & ~done, side, cur), mode="drop")
        new_passes = jnp.where(any_move, 0, passes + 1)
        frozen = done | (new_passes >= 2)
        ns, ni = JE.step_and_illegal_stones_batch(
            stones, side, jnp.where(frozen, nn, actions))
        return (jnp.where(frozen[:, None, None], stones, ns),
                jnp.where(frozen[:, None], illegal, ni),
                jnp.where(frozen, side, -side), amaf,
                jnp.where(done, passes, new_passes),
                jnp.where(done, last, actions),
                jnp.where(done, last2, last)), None

    carry = (stones, illegal, side, amaf, jnp.zeros((b,), jnp.int32),
             last, last2)
    carry, _ = lax.scan(body, carry, jax.random.split(rng, cfg.playout_cap(n)))
    return carry[0], carry[2], carry[4]


def test_playout_matches_jax_and_ends_early_exactly(boards, monkeypatch):
    b, last = boards
    kb = b.shape[0]
    cfg, jcfg = MichiConfig(), JMichi()
    rng = jax.random.PRNGKey(7)
    amaf0 = np.zeros((kb, 82), np.int8)
    last2 = np.where(last.numpy() >= 0, (last.numpy() + 9) % 81, -1)
    jfn = jax.jit(lambda bd, am, r, l1, l2: JM.mc_playout_batch(
        bd, am, r, jcfg, last=l1, last2=l2))
    jscores, jamaf = jfn(b.numpy(), amaf0, rng, last.numpy(), last2)
    ostones, oside, opasses = jax.jit(
        lambda bd, am, r, l1, l2: _playout_oracle(bd, am, r, jcfg, l1, l2))(
        b.numpy(), amaf0, rng, last.numpy(), last2)
    draws = playout_draws(rng, kb, cfg.playout_cap(9), 81)
    finals = {}
    check_every = M._PLAYOUT_CHECK_EVERY
    for every in (check_every, 10 ** 6):
        monkeypatch.setattr(M, "_PLAYOUT_CHECK_EVERY", every)
        stats = {}
        scores, amaf, stones, side = M.mc_playout_batch(
            b, torch.from_numpy(amaf0), cfg, last, torch.from_numpy(last2),
            draws=draws, stats=stats, return_final=True)
        assert np.array_equal(scores.numpy(), np.asarray(jscores))
        assert np.array_equal(amaf.numpy(), np.asarray(jamaf))
        assert np.array_equal(stones.numpy(), np.asarray(ostones))
        assert np.array_equal(side.numpy(), np.asarray(oside))
        finals[every] = (scores, amaf, stats["playout_steps"])
    assert (np.asarray(opasses) >= 2).all()      # every playout ended
    early, full = finals[check_every], finals[10 ** 6]
    assert early[2] < full[2] == cfg.playout_cap(9)
    assert torch.equal(early[0], full[0]) and torch.equal(early[1], full[1])


@pytest.fixture(scope="module")
def search_case(boards):
    b, last = boards
    idx = [5, 20, 32]                    # mid-game, late, the ladder shape
    return b[idx], last[idx]


@pytest.fixture(scope="module")
def jax_search():
    jcfg = JMichi(**SEARCH_KW)
    new = jax.jit(lambda bd, la: JM.new_michi_tree_batch(bd, jcfg, la))
    search = jax.jit(lambda t, r: JM.michi_search_batch(t, r, jcfg))
    best = jax.jit(jax.vmap(JM.best_root_stats))
    return jcfg, new, search, best


def test_michi_search_matches_jax(search_case, jax_search):
    b, last = search_case
    jcfg, jnew, jsearch, jbest = jax_search
    cfg = MichiConfig(**SEARCH_KW)
    rng = jax.random.PRNGKey(3)
    jt0 = jnew(b.numpy(), last.numpy())
    t0 = M.new_michi_tree_batch(b, cfg, last)
    tree_equal(jt0, t0, "root ")
    jt, jactive = jsearch(jt0, rng)
    stats = {}
    tt, active = M.michi_search_batch(
        t0, cfg, draws=jax_round_draws(rng, cfg, 3, 9), stats=stats)
    tree_equal(jt, tt)
    assert np.array_equal(active.numpy(), np.asarray(jactive))
    ja, jw = jbest(jt)
    ta, tw = M.best_root_stats(tt)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=0)
    for node in (0, 1):              # the urgencies the next walk reads
        want = jax.jit(jax.vmap(lambda t: JM.rave_urgency(
            t, node, jcfg.rave_equiv)))(jt)
        got = M.rave_urgency(tt, torch.full((3,), node), cfg.rave_equiv)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(tt.n_nodes.min()) > 1                  # expansions happened
    assert stats["rounds"] * cfg.playout_parallel >= 8
    assert stats.get("ladder_calls", 0) >= 1          # ladders were read
    assert int(t0.edge_v.sum()) == 0                  # input untouched


def test_searcher_chunks_equal_the_one_shot_search(search_case):
    """Chunked search (one chunk per round) equals one call over the whole
    budget with the same generator draws."""
    b, last = search_case
    cfg = MichiConfig(**SEARCH_KW)
    s = M.MichiSearcher(cfg, chunk_sims=cfg.playout_parallel, device="cpu",
                        seed=11)
    assert s.chunk == 4
    chunked = s.search(b, last)
    t0 = M.new_michi_tree_batch(b, cfg, last)
    g = torch.Generator().manual_seed(11)
    one, _ = M.michi_search_batch(t0, cfg, generator=g)
    for name, x in one.fields().items():
        assert torch.equal(x, chunked.fields()[name]), name
    assert torch.equal(M.best_root_stats(one)[0],
                       M.best_root_stats(chunked)[0])
