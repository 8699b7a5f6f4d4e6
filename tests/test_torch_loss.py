"""The port's az_loss against the JAX package's, in both modes, float32,
on the same numpy-seeded logits, values and unnormalised targets
(rtol 1e-6: one log-softmax and a few sums over 82 actions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.nets import az_loss as j_az_loss
from sejonggo_torch.nets import az_loss

RTOL = 1e-6


def _inputs(seed, b=16, a=82):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(b, a)).astype(np.float32)
    values = np.tanh(rng.randn(b, 1)).astype(np.float32)
    # prior-style targets: not normalised, some rows all zero
    policy = (rng.rand(b, a) * (rng.rand(b, a) < 0.3)).astype(np.float32)
    policy[0] = 0
    value_t = rng.choice([-1.0, 0.0, 1.0], size=b).astype(np.float32)
    return logits, values, policy, value_t


@pytest.mark.parametrize("mode", ["agz", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_az_loss_matches_jax(mode, seed):
    args = _inputs(seed)
    jtotal, jm = jax.jit(lambda *a: j_az_loss(*a, mode=mode))(
        *map(jnp.asarray, args))
    total, m = az_loss(*map(torch.from_numpy, args), mode=mode)
    assert total.dtype == torch.float32
    np.testing.assert_allclose(float(total), float(jtotal), rtol=RTOL)
    assert set(m) == set(jm) == {"loss", "policy_ce", "value_mse"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL)


def test_unknown_mode_raises():
    logits, values, policy, value_t = map(torch.from_numpy, _inputs(2))
    with pytest.raises(ValueError, match="loss mode"):
        az_loss(logits, values, policy, value_t, mode="keras")
