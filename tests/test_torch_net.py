"""The port's net (sejonggo_torch.nets) against the flax AZNet.

Weights go from the flax variable tree through from_jax_variables.
Logits and values are compared in float32 within atol 1e-4: the two
frameworks sum the convolutions in different orders, so the last bits
differ and grow slowly with depth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.config import NetConfig as JNetConfig
from sejonggo_tpu.nets import AZNet as JNet
from sejonggo_tpu.nets import dummy_predict_fn as j_dummy
from sejonggo_tpu.nets import init_variables
from sejonggo_tpu.nets import make_predict_fn as j_make_predict
from sejonggo_torch.config import NetConfig
from sejonggo_torch.nets import (AZNet, dummy_predict_fn, from_jax_variables,
                                 make_predict_fn, seeded_flax_variables)
from test_torch_heuristics import one_torch_thread  # noqa: F401

ATOL = 1e-4


def _boards(size, b, seed):
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, size, size, 17) < 0.3).astype(np.int8)
    x[..., 16] = rng.choice([-1, 1], size=(b, 1, 1))
    return x


def _torch_net(size, cfg, variables):
    net = AZNet.from_config(size, cfg)
    net.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jax.device_get(variables))))
    return net


@pytest.mark.parametrize("size,blocks,filters,hidden", [
    (9, 2, 16, 16), (9, 4, 64, 64), (5, 1, 8, 4)])
def test_predict_matches_flax(size, blocks, filters, hidden):
    cfg = NetConfig(blocks=blocks, filters=filters, value_hidden=hidden,
                    compute_dtype="float32")
    jnet = JNet(size=size, blocks=blocks, filters=filters,
                value_hidden=hidden, compute_dtype="float32")
    variables = init_variables(jnet, jax.random.PRNGKey(size + blocks))
    # init has zero BN statistics; use seeded ones so BN really acts
    seeded = seeded_flax_variables(size, cfg, seed=blocks)
    variables = {"params": variables["params"], "batch_stats": seeded["batch_stats"]}
    boards = _boards(size, 6, blocks)
    jp, jv = jax.jit(j_make_predict(jnet))(variables, jnp.asarray(boards))
    jl, _ = jax.jit(lambda v, x: jnet.apply(v, x.astype(jnp.float32)))(
        variables, jnp.asarray(boards))
    net = _torch_net(size, cfg, variables)
    tp, tv = make_predict_fn(net)(torch.from_numpy(boards))
    with torch.no_grad():
        tl, _ = net(torch.from_numpy(boards))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    assert tp.shape == (6, size * size + 1) and tv.shape == (6, 1)


def test_seeded_variables_have_flax_shapes():
    size = 9
    cfg = JNetConfig(blocks=2, filters=16, value_hidden=8, compute_dtype="float32")
    jnet = JNet.from_config(size, cfg)
    ref = jax.device_get(init_variables(jnet, jax.random.PRNGKey(0)))
    got = seeded_flax_variables(size, NetConfig(blocks=2, filters=16, value_hidden=8), 3)
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(got)
    assert jax.tree_util.tree_map(np.shape, ref) == jax.tree_util.tree_map(np.shape, got)
    # the flax net runs on them and agrees with the port
    boards = _boards(size, 3, 9)
    jl, jv = jnet.apply(got, jnp.asarray(boards, jnp.float32))
    net = AZNet.from_config(size, NetConfig(blocks=2, filters=16, value_hidden=8,
                                            compute_dtype="float32"))
    net.load_state_dict(from_jax_variables(got))
    net.eval()
    with torch.no_grad():
        tl, tv = net(torch.from_numpy(boards))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_stub_predict_fn_matches_jax():
    boards = _boards(9, 4, 0)
    jp, jv = j_dummy(jnp.asarray(boards))
    tp, tv = dummy_predict_fn(torch.from_numpy(boards))
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
