"""The port's engine (sejonggo_torch.goenv) against the JAX engine.

The same numpy-chosen moves go through the jitted JAX batched engine and
the port on the CPU; planes, legality masks and scores must be equal bit
for bit, at 9x9 and 19x19, on uniform and contact-biased random games
and on the scripted ko fight."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu import config as jcfg
from sejonggo_tpu.goenv import coords as jcoords
from sejonggo_tpu.goenv import engine as J
from sejonggo_torch import config as tcfg
from sejonggo_torch.goenv import coords as tcoords
from sejonggo_torch.goenv import engine as T
from sejonggo_torch.goenv.positions import choose_actions, random_positions
from test_torch_heuristics import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
# tests/test_engine_vs_reference.py: B41 captures W40, a simple ko at 40
KO_SEQUENCE = [39, 40, 31, 32, 49, 50, 10, 42, 41]


@pytest.fixture(scope="module")
def jax_engine():
    return dict(
        step=jax.jit(J.step_batch),
        illegal=jax.jit(J.illegal_moves_mask_batch),
        score=jax.jit(jax.vmap(J.score, in_axes=(0, None))),
        stones_step=jax.jit(J.step_stones_batch),
        stones_illegal=jax.jit(J.illegal_moves_mask_stones_batch),
    )


def _play_lockstep(jx, size, games, moves, seed, contact, prefix=()):
    """Step both engines with the same moves; compare every move."""
    rng = np.random.RandomState(seed)
    jb = jnp.stack([J.init_board(size)] * games)
    tb = T.init_board(size, batch=games, device=CPU)
    for a in prefix:
        acts = np.full((games,), a, np.int32)
        jb = jx["step"](jb, jnp.asarray(acts))
        tb = T.step_batch(tb, torch.from_numpy(acts))
    for move in range(moves):
        j_ill = np.asarray(jx["illegal"](jb))
        t_ill = T.illegal_moves_mask_batch(tb).numpy()
        assert np.array_equal(j_ill, t_ill), f"legality differs at move {move}"
        occ = (np.asarray(jb)[..., 0] == 1) | (np.asarray(jb)[..., 1] == 1)
        acts = choose_actions(rng, j_ill, occ, contact, 0.02)
        jb = jx["step"](jb, jnp.asarray(acts))
        tb = T.step_batch(tb, torch.from_numpy(acts))
        assert np.array_equal(np.asarray(jb), tb.numpy()), \
            f"planes differ after move {move}"
    return jb, tb


@pytest.mark.parametrize("size,games,moves,seed,contact", [
    (9, 8, 70, 0, 0.0), (9, 8, 70, 1, 0.9), (19, 3, 45, 2, 0.0),
    (19, 3, 45, 3, 0.9)])
def test_games_match_jax(jax_engine, size, games, moves, seed, contact):
    jb, tb = _play_lockstep(jax_engine, size, games, moves, seed, contact)
    jw, jbp, jwp = jax_engine["score"](jb, 5.5)
    tw, tbp, twp = T.score_batch(tb, 5.5)
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert np.array_equal(np.asarray(jbp), tbp.numpy())
    assert np.array_equal(np.asarray(jwp), twp.numpy())


def test_ko_sequence_matches_jax(jax_engine):
    jb, tb = _play_lockstep(jax_engine, 9, 2, 0, 0, 0.9, prefix=KO_SEQUENCE)
    ill = T.illegal_moves_mask_batch(tb).numpy()
    assert ill[:, 40].all(), "the ko recapture at 40 must be illegal"
    _play_lockstep(jax_engine, 9, 2, 40, 7, 0.9, prefix=KO_SEQUENCE)


@pytest.mark.parametrize("size,seed", [(9, 4), (19, 5)])
def test_stone_grid_api_matches_jax(jax_engine, size, seed):
    stones, sides, actions = random_positions(size, 6, 30, seed, contact=0.9)
    j_new = jax_engine["stones_step"](jnp.asarray(stones.numpy()),
                                      jnp.asarray(sides.numpy()),
                                      jnp.asarray(actions.numpy()))
    t_new = T.step_stones_batch(stones, sides, actions)
    assert np.array_equal(np.asarray(j_new), t_new.numpy())
    j_ill = jax_engine["stones_illegal"](j_new, jnp.asarray(stones.numpy()),
                                         -jnp.asarray(sides.numpy()))
    t_ill = T.illegal_moves_mask_stones_batch(t_new, stones, -sides)
    assert np.array_equal(np.asarray(j_ill), t_ill.numpy())


def test_board_helpers_match_jax(jax_engine):
    jb = jnp.stack([J.init_board(9)] * 3)
    tb = T.init_board(9, batch=3, device=CPU)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    acts = np.array([40, 81, 0], np.int32)
    jb = jax_engine["step"](jb, jnp.asarray(acts))
    tb = T.step_batch(tb, torch.from_numpy(acts))
    assert np.array_equal(np.asarray(jax.vmap(J.signed_stones)(jb)),
                          T.signed_stones(tb).numpy())
    assert np.array_equal(np.asarray(J.to_features(jb)),
                          T.to_features(tb).numpy())
    assert T.SWAP_INDEX == J.SWAP_INDEX and T.NUM_PLANES == J.NUM_PLANES


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the no-CUDA refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_board(9)


@pytest.mark.parametrize("preset", ["small_9x9", "strength_9x9"])
def test_config_presets_match_jax(preset):
    j = getattr(jcfg, preset)()
    t = getattr(tcfg, preset)()
    for part in ("go", "net", "search"):
        assert dataclasses.asdict(getattr(t, part)) == \
            dataclasses.asdict(getattr(j, part))
    assert t.search.capacity() == j.search.capacity()
    assert t.search.rounds == j.search.rounds
    assert tcfg.SearchConfig(max_nodes=82).capacity() == 82


def test_coords_match_jax():
    for size in (9, 19):
        for i in range(size * size + 1):
            x, y = tcoords.index2coord(i, size)
            assert (x, y) == jcoords.index2coord(i, size)
            assert tcoords.coord2index(x, y, size) == i
            v = tcoords.xy_to_gtp(x, y, size)
            assert v == jcoords.xy_to_gtp(x, y, size)
            assert tcoords.gtp_to_xy(v, size) == jcoords.gtp_to_xy(v, size)
