"""The port's two kernels (sejonggo_torch.ops).

On the CPU the wrappers run their plain versions; these are held to the
JAX package's XLA composition (which tests/test_ops_flood.py and
tests/test_ops_gostep.py hold equal to the Pallas kernels) and, on small
cases, to the Pallas kernels in interpret mode.  The CUDA kernels are held
to the plain versions on the card in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.goenv import engine as J
from sejonggo_tpu.ops.flood import flood_fixpoint_pallas
from sejonggo_tpu.ops.gostep import step_legal_pallas
from sejonggo_torch import ops
from sejonggo_torch.goenv.positions import random_positions
from test_torch_heuristics import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_ops():
    def step_legal(stones, sides, actions):
        new = J.step_stones_batch(stones, sides, actions)
        ill = J.illegal_moves_mask_stones_batch(
            new, stones, -jnp.asarray(sides, jnp.int8))
        return new, ill

    return dict(flood=jax.jit(jax.vmap(J._flood)), step_legal=jax.jit(step_legal))


def _random_masks(n, b, seed):
    rng = np.random.RandomState(seed)
    allowed = rng.rand(b, n, n) < 0.6
    seeds = allowed & (rng.rand(b, n, n) < 0.15)
    return seeds, allowed


def _serpentine(n):
    allowed = np.zeros((1, n, n), bool)
    path = []
    for y in range(n):
        xs = range(n - 1) if y % 2 == 0 else range(n - 1, 0, -1)
        path += [(y, x) for x in xs]
    for y, x in path:
        allowed[0, y, x] = True
    seeds = np.zeros_like(allowed)
    seeds[0, path[0][0], path[0][1]] = True
    return seeds, allowed


@pytest.mark.parametrize("n,b,seed", [(9, 7, 0), (9, 33, 1), (19, 5, 2)])
def test_flood_plain_matches_jax(jax_ops, n, b, seed):
    seeds, allowed = _random_masks(n, b, seed)
    exp = np.asarray(jax_ops["flood"](jnp.asarray(seeds), jnp.asarray(allowed)))
    got = ops.flood_fixpoint(torch.from_numpy(seeds), torch.from_numpy(allowed))
    assert np.array_equal(exp, got.numpy())


def test_flood_plain_long_chain_and_pallas():
    seeds, allowed = _serpentine(9)
    got = ops.flood_plain(torch.from_numpy(seeds), torch.from_numpy(allowed))
    pallas = flood_fixpoint_pallas(jnp.asarray(seeds), jnp.asarray(allowed),
                                   interpret=True)
    assert np.array_equal(np.asarray(pallas), got.numpy())
    assert got.sum() == allowed.sum()


@pytest.mark.parametrize("n,games,moves,seed,contact", [
    (9, 6, 50, 0, 0.0), (9, 6, 50, 1, 0.9), (19, 2, 40, 2, 0.9)])
def test_step_legal_plain_matches_jax(jax_ops, n, games, moves, seed, contact):
    stones, sides, actions = random_positions(n, games, moves, seed,
                                              contact=contact)
    exp_s, exp_i = jax_ops["step_legal"](jnp.asarray(stones.numpy()),
                                         jnp.asarray(sides.numpy()),
                                         jnp.asarray(actions.numpy()))
    got_s, got_i = ops.step_legal(stones, sides, actions)
    assert np.array_equal(np.asarray(exp_s), got_s.numpy())
    assert np.array_equal(np.asarray(exp_i), got_i.numpy())


def _ko_case(n=9):
    grid = np.zeros((n, n), np.int8)
    grid[0, 1] = grid[1, 0] = grid[1, 2] = 1
    grid[1, 1] = grid[2, 0] = grid[2, 2] = grid[3, 1] = -1
    return (torch.from_numpy(grid[None]), torch.tensor([1], dtype=torch.int8),
            torch.tensor([2 * n + 1], dtype=torch.int32))


def test_step_legal_plain_ko_matches_pallas():
    stones, sides, actions = _ko_case()
    got_s, got_i = ops.step_legal(stones, sides, actions)
    exp_s, exp_i = step_legal_pallas(jnp.asarray(stones.numpy()),
                                     jnp.asarray(sides.numpy()),
                                     jnp.asarray(actions.numpy()),
                                     interpret=True)
    assert np.array_equal(np.asarray(exp_s), got_s.numpy())
    assert np.array_equal(np.asarray(exp_i), got_i.numpy())
    assert got_i[0, 1 * 9 + 1], "the ko retake must be illegal"


def test_step_legal_plain_passes_ragged_batch_matches_pallas():
    stones, sides, actions = random_positions(9, 2, 10, 7)
    actions = actions.clone()
    actions[::3] = 81
    got_s, got_i = ops.step_legal(stones, sides, actions)
    exp_s, exp_i = step_legal_pallas(jnp.asarray(stones.numpy()),
                                     jnp.asarray(sides.numpy()),
                                     jnp.asarray(actions.numpy()),
                                     block_b=16, interpret=True)
    assert stones.shape[0] % 16 != 0
    assert np.array_equal(np.asarray(exp_s), got_s.numpy())
    assert np.array_equal(np.asarray(exp_i), got_i.numpy())


def test_wrappers_check_their_inputs():
    m = torch.zeros((2, 9, 9), dtype=torch.bool)
    with pytest.raises(TypeError):
        ops.flood_fixpoint(m.to(torch.int8), m)
    with pytest.raises(ValueError):
        ops.flood_fixpoint(m, m[:1])
    s = torch.zeros((2, 9, 9), dtype=torch.int8)
    with pytest.raises(ValueError):
        ops.step_legal(s.to(torch.int32), torch.ones(2, dtype=torch.int8),
                       torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.step_legal(s, torch.ones(3, dtype=torch.int8),
                       torch.zeros(2, dtype=torch.int32))


def test_plain_versions_do_not_count_launches():
    ops.reset_kernel_launches()
    stones, sides, actions = _ko_case()
    ops.step_legal(stones, sides, actions)
    ops.flood_fixpoint(stones != 0, stones != 0)
    assert ops.kernel_launches() == {"gostep": 0, "flood": 0}
