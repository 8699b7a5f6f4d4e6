"""The port's net honours NetConfig.compute_dtype as flax does: float32
parameters and BatchNorm statistics, convolutions, dense layers and
activations in the compute dtype.

bf16 cannot match flax bit for bit (the two frameworks round at other
points inside a convolution), so the bf16 outputs are held to a stated
tolerance: twice flax's own gap between its bf16 and float32 outputs on
the same boards.  The float32 path stays within 1e-4 of flax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.nets import AZNet as JNet
from sejonggo_tpu.nets import make_predict_fn as j_make_predict
from sejonggo_torch.config import NetConfig, strength_9x9_xl
from sejonggo_torch.nets import (AZNet, from_jax_variables, make_predict_fn,
                                 seeded_flax_variables)
from test_torch_heuristics import one_torch_thread  # noqa: F401

F32_ATOL = 1e-4


def _boards(b, seed):
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, 9, 9, 17) < 0.3).astype(np.int8)
    x[..., 16] = rng.choice([-1, 1], size=(b, 1, 1))
    return x


def _flax(cfg, variables, boards, dtype):
    jnet = JNet(size=9, blocks=cfg.blocks, filters=cfg.filters,
                value_hidden=cfg.value_hidden, compute_dtype=dtype)
    p, v = jax.jit(j_make_predict(jnet))(variables, jnp.asarray(boards))
    return np.asarray(p), np.asarray(v)


def _port(cfg, variables, boards, dtype):
    net = AZNet.from_config(9, dataclasses.replace(cfg, compute_dtype=dtype))
    net.load_state_dict(from_jax_variables(variables))
    p, v = make_predict_fn(net)(torch.from_numpy(boards))
    return net, p.numpy(), v.numpy()


@pytest.mark.parametrize("blocks,filters", [(4, 64), (6, 96)])
def test_bf16_follows_compute_dtype_like_flax(blocks, filters):
    cfg = NetConfig(blocks=blocks, filters=filters, value_hidden=filters,
                    compute_dtype="bfloat16")
    variables = seeded_flax_variables(9, cfg, seed=blocks)
    boards = _boards(256, blocks)
    jp16, jv16 = _flax(cfg, variables, boards, "bfloat16")
    jp32, jv32 = _flax(cfg, variables, boards, "float32")
    net, tp16, tv16 = _port(cfg, variables, boards, "bfloat16")
    _, tp32, tv32 = _port(cfg, variables, boards, "float32")

    # parameters and BatchNorm statistics stay float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(b.dtype == torch.float32 for n, b in net.named_buffers()
               if "running" in n)
    assert tp16.dtype == np.float32 and tv16.dtype == np.float32
    # the bf16 net really computes in bf16 ...
    assert np.abs(tv16 - tv32).max() > 1e-3
    # ... and lands within twice flax's own bf16-vs-float32 gap of flax
    v_tol = 2 * np.abs(jv16 - jv32).max()
    p_tol = 2 * np.abs(jp16 - jp32).max()
    assert np.abs(tv16 - jv16).max() <= v_tol
    assert np.abs(tp16 - jp16).max() <= p_tol
    np.testing.assert_allclose(tv32, jv32, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(tp32, jp32, atol=F32_ATOL, rtol=0)


def test_from_config_passes_the_dtype_on():
    cfg = strength_9x9_xl().net
    assert cfg.compute_dtype == "bfloat16"
    net = AZNet.from_config(9, cfg)
    assert net.compute_dtype == torch.bfloat16
    net.eval()
    with torch.no_grad():
        logits, value = net(torch.zeros((2, 9, 9, 17), dtype=torch.int8))
    assert logits.dtype == torch.float32 and value.dtype == torch.float32


def test_cast_weights_follow_a_weight_change():
    """The bf16 copy of the weights kept between calls is made anew when
    the float32 parameters are written, so a predict function sees
    weights loaded after it was made."""
    cfg = NetConfig(blocks=1, filters=16, value_hidden=16,
                    compute_dtype="bfloat16")
    boards = torch.from_numpy(_boards(8, 3))
    net = AZNet.from_config(9, cfg)
    net.load_state_dict(from_jax_variables(seeded_flax_variables(9, cfg, 1)))
    predict = make_predict_fn(net)
    p1, v1 = predict(boards)
    assert torch.equal(predict(boards)[1], v1)        # the kept copy
    net.load_state_dict(from_jax_variables(seeded_flax_variables(9, cfg, 2)))
    p2, v2 = predict(boards)
    fresh = AZNet.from_config(9, cfg)
    fresh.load_state_dict(net.state_dict())
    p3, v3 = make_predict_fn(fresh)(boards)
    assert not torch.equal(v2, v1)
    assert torch.equal(v2, v3) and torch.equal(p2, p3)
