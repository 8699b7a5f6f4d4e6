"""The port's D4 symmetries (sejonggo_torch.goenv.symmetry) against the
JAX package's tables and transforms (which fix the reference's rot90 /
rot270 inverse)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.goenv import symmetry as J
from sejonggo_torch.goenv import symmetry as T


@pytest.mark.parametrize("size", [5, 9, 19])
def test_tables_match_jax(size):
    jb, jp = J.symmetry_tables(size)
    tb, tp = T.symmetry_tables(size)
    assert np.array_equal(jb, tb) and np.array_equal(jp, tp)
    assert T.NUM_SYMMETRIES == J.NUM_SYMMETRIES
    assert T.NUM_REFERENCE_SYMMETRIES == J.NUM_REFERENCE_SYMMETRIES


def test_batch_transforms_match_jax_and_invert():
    rng = np.random.RandomState(0)
    boards = rng.randint(-1, 2, size=(16, 9, 9, 17)).astype(np.int8)
    pol = rng.rand(16, 82).astype(np.float32)
    syms = rng.randint(0, 8, size=16).astype(np.int32)
    jt = np.asarray(J.transform_boards_batch(jnp.asarray(boards), jnp.asarray(syms)))
    tt = T.transform_boards_batch(torch.from_numpy(boards), torch.from_numpy(syms))
    assert np.array_equal(jt, tt.numpy())
    jpol = np.asarray(J.inverse_policy_batch(jnp.asarray(pol), jnp.asarray(syms)))
    tpol = T.inverse_policy_batch(torch.from_numpy(pol), torch.from_numpy(syms))
    assert np.array_equal(jpol, tpol.numpy())
    # the policy of a transformed one-hot board maps back to the point
    for s in range(T.NUM_SYMMETRIES):
        for i in (0, 10, 40, 80):
            flat = torch.zeros((1, 81))
            flat[0, i] = 1
            moved = T.transform_flat(flat, s, 9)
            back = T.inverse_policy(torch.cat([moved, torch.zeros((1, 1))], 1), s)
            assert back[0, i] == 1 and back.sum() == 1


@pytest.mark.parametrize("sym", range(8))
def test_flat_switch_and_pergame_match_jax(sym):
    rng = np.random.RandomState(sym)
    x = rng.randint(-1, 2, size=(3, 4, 81)).astype(np.int8)
    j = np.asarray(J.transform_flat_switch(jnp.asarray(x), sym, 9))
    assert np.array_equal(j, T.transform_flat(torch.from_numpy(x), sym, 9).numpy())
    ids = np.array([sym, (sym + 3) % 8, 0], np.int32)
    jg = np.asarray(J.transform_flat_pergame(jnp.asarray(x), jnp.asarray(ids), 9))
    tg = T.transform_flat(torch.from_numpy(x), torch.from_numpy(ids), 9)
    assert np.array_equal(jg, tg.numpy())
    p = rng.rand(5, 82).astype(np.float32)
    jp = np.asarray(J.inverse_policy_switch(jnp.asarray(p), sym))
    assert np.array_equal(jp, T.inverse_policy(torch.from_numpy(p), sym).numpy())
