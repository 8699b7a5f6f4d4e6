"""The port's train step against the JAX package's jitted one.

From the same variables and batches (numpy-seeded, 1-2 blocks x 8-16
filters, float32) the port and JAX take one step, three steps, and one
step from a non-zero momentum trace; loss, metrics, new parameters, new
BatchNorm statistics, the momentum trace and the step agree within 1e-5
(atol and rtol: float32 sums in another order).  The train-mode forward
folds flax's BIASED batch variance into the running averages, where
torch's own BatchNorm folds the unbiased one: at 5x5 and batch 2 the two
differ by 2%, which the forward test resolves.  A non-finite batch
leaves the state bit-unchanged.  A bf16 step lands within twice JAX's own
bf16-vs-float32 gap (in L2 over the updated values).  The plateau
scheduler gives JAX's sequence."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu import config as jcfg
from sejonggo_tpu.learn import make_optimizer as j_make_optimizer
from sejonggo_tpu.learn import make_train_step as j_make_train_step
from sejonggo_tpu.learn.train import PlateauScheduler as JPlateau
from sejonggo_tpu.learn.train import _decay_mask as j_decay_mask
from sejonggo_tpu.learn.train import init_train_state as j_init_train_state
from sejonggo_tpu.nets import AZNet as JNet
from sejonggo_torch import config as tcfg
from sejonggo_torch.config import NetConfig
from sejonggo_torch.learn import (PlateauScheduler, init_train_state,
                                  make_optimizer, make_train_step)
from sejonggo_torch.learn.checkpoint import state_tree
from sejonggo_torch.learn.train import _decay_mask
from sejonggo_torch.nets import (AZNet, batch_norms, fold_batch_stats,
                                 from_jax_variables, init_variables,
                                 seeded_flax_variables, to_jax_params,
                                 to_jax_variables)
from test_torch_heuristics import one_torch_thread  # noqa: F401

TOL = 1e-5
LR, MOMENTUM, L2 = 2e-2, 0.9, 1e-4


def _cfg(blocks, filters, dtype="float32"):
    return NetConfig(blocks=blocks, filters=filters, value_hidden=filters,
                     compute_dtype=dtype)


def _batch(seed, b=8):
    rng = np.random.RandomState(seed)
    boards = (rng.rand(b, 9, 9, 17) < 0.3).astype(np.float32)
    boards[..., 16] = rng.rand(b, 1, 1) < 0.5
    policy = rng.rand(b, 82).astype(np.float32) ** 4
    policy /= policy.sum(-1, keepdims=True)
    values = rng.choice([-1.0, 1.0], size=b).astype(np.float32)
    return boards, policy, values


def _trace_tree(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.01 * rng.randn(*a.shape)).astype(np.float32),
        variables["params"])


def _jax_side(cfg, variables, trace=None):
    jnet = JNet.from_config(9, jcfg.NetConfig(**dataclasses.asdict(cfg)))
    tx = j_make_optimizer(LR, MOMENTUM, L2)
    state = j_init_train_state(jnet, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    if trace is not None:
        masked, (tr, empty) = state.opt_state
        state = state._replace(opt_state=(
            masked, (tr._replace(trace=jax.tree_util.tree_map(
                jnp.asarray, trace)), empty)))
    return state, j_make_train_step(jnet, tx)


def _port_side(cfg, variables, trace=None):
    net = AZNet.from_config(9, cfg)
    net.load_state_dict(from_jax_variables(variables))
    flat = None
    if trace is not None:
        named = from_jax_variables({"params": trace})
        flat = torch.cat([named[n].reshape(-1)
                          for n, _ in net.named_parameters()])
    state = init_train_state(net, trace=flat)
    return state, make_train_step(make_optimizer(LR, MOMENTUM, L2))


def _jax_tree(state):
    return jax.device_get({
        "params": state.params, "batch_stats": state.batch_stats,
        "trace": state.opt_state[1][0].trace,
        "step": np.asarray(state.step)})


def _port_tree(state):
    t = state_tree(state)
    return {"params": t["params"], "batch_stats": t["batch_stats"],
            "trace": t["opt_state"]["1"]["0"]["trace"], "step": t["step"]}


def _assert_close(got, want, atol=TOL, rtol=TOL):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=rtol, err_msg=str(path))


@pytest.mark.parametrize("preset", ["small_9x9", "strength_9x9",
                                    "strength_9x9_xl"])
def test_train_config_presets_match_jax(preset):
    j, t = getattr(jcfg, preset)(), getattr(tcfg, preset)()
    assert dataclasses.asdict(t.train) == dataclasses.asdict(j.train)
    for d in ("model_dir", "selfplay_dir", "log_dir"):
        assert getattr(t, d) == getattr(j, d)


def test_init_variables_follow_flax_initialisers():
    """init_variables has flax's tree (keys in flax's order, shapes,
    dtypes), its constant leaves, and LeCun-normal kernels truncated at
    two standard deviations; the same generator seed gives the same
    tree."""
    cfg = _cfg(2, 16)
    jnet = JNet.from_config(9, jcfg.NetConfig(**dataclasses.asdict(cfg)))
    want = jax.device_get(jax.jit(lambda k: jnet.init(
        k, jnp.zeros((1, 9, 9, 17)), train=False))(jax.random.PRNGKey(0)))
    got = init_variables(9, cfg, torch.Generator().manual_seed(1))
    again = init_variables(9, cfg, torch.Generator().manual_seed(1))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert list(got["params"]) == sorted(want["params"])
    for (path, g), w, a in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree_util.tree_leaves(want),
                               jax.tree_util.tree_leaves(again)):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, a)
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            std = 1 / np.sqrt(np.prod(g.shape[:-1]))   # 1/sqrt(fan_in)
            assert np.abs(g).max() <= 2 * std / 0.87962566103423978 + 1e-6
            if g.size >= 1000:
                assert abs(g.std() / std - 1) < 0.1
                assert abs(w.std() / std - 1) < 0.1
        else:
            np.testing.assert_array_equal(g, w)    # zeros and ones
    other = init_variables(9, cfg, torch.Generator().manual_seed(2))
    assert not np.array_equal(other["params"]["Conv_0"]["kernel"],
                              got["params"]["Conv_0"]["kernel"])


def test_train_forward_folds_flax_batch_statistics():
    """One train-mode forward at 5x5 and batch 2 (50 values a channel, so
    the unbiased variance is 2% larger than the biased one): outputs and
    the folded running statistics match flax's train-mode apply within
    1e-6, and torch's own BatchNorm2d in train mode misses flax's running
    variance by more than 100 times that."""
    size, cfg = 5, _cfg(1, 8)
    variables = seeded_flax_variables(size, cfg, 7)
    rng = np.random.RandomState(8)
    # planes of 0 and 3: batch variances of a few units, so the 2%
    # between the two variances stands far above float32 noise
    boards = 3 * (rng.rand(2, size, size, 17) < 0.4).astype(np.float32)
    jnet = JNet(size=size, blocks=1, filters=8, value_hidden=8,
                compute_dtype="float32")
    (jl, jv), mut = jax.jit(lambda v, x: jnet.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, boards)
    net = AZNet(size, blocks=1, filters=8, value_hidden=8,
                compute_dtype="float32")
    net.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        logits, values, batch = net(torch.from_numpy(boards), train=True)
        folded = fold_batch_stats(net, batch)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5)
        np.testing.assert_allclose(values.numpy(), np.asarray(jv), atol=1e-5)
        x = net.stem_conv(torch.from_numpy(boards).permute(0, 3, 1, 2))
        torch_bn = AZNet(size, blocks=1, filters=8, value_hidden=8).stem_bn
        torch_bn.load_state_dict(net.stem_bn.state_dict())
        torch_bn.train()(x)
        for bn, (m, v) in zip(batch_norms(net), zip(folded[::2], folded[1::2])):
            bn.running_mean.copy_(m)
            bn.running_var.copy_(v)
    got = to_jax_variables(net.state_dict())["batch_stats"]
    want = jax.device_get(mut["batch_stats"])
    _assert_close(got, want, atol=1e-6, rtol=1e-6)
    miss = np.abs(torch_bn.running_var.numpy()
                  - want["BatchNorm_0"]["var"]).max()
    assert miss > 100 * 1e-6 * (1 + np.abs(want["BatchNorm_0"]["var"]).max())


def test_decay_mask_matches_jax():
    cfg = _cfg(2, 8)
    variables = seeded_flax_variables(9, cfg, 0)
    net = AZNet.from_config(9, cfg)
    mask = _decay_mask(net)
    assert sum(mask.values()) < len(mask)     # BatchNorm is masked out
    as_tree = to_jax_params({n: torch.full_like(p, float(mask[n]))
                             for n, p in net.named_parameters()})
    want = j_decay_mask(variables["params"])
    assert jax.tree_util.tree_structure(as_tree) == \
        jax.tree_util.tree_structure(want)
    for a, w in zip(jax.tree_util.tree_leaves(as_tree),
                    jax.tree_util.tree_leaves(want)):
        assert np.all(a == float(w))


@pytest.mark.parametrize("blocks,filters,steps,momentum", [
    (1, 8, 1, False), (2, 16, 3, False), (1, 16, 1, True)])
def test_train_steps_match_jax(blocks, filters, steps, momentum):
    cfg = _cfg(blocks, filters)
    variables = seeded_flax_variables(9, cfg, blocks + filters)
    trace = _trace_tree(variables, 5) if momentum else None
    jstate, jstep = _jax_side(cfg, variables, trace)
    state, step = _port_side(cfg, variables, trace)
    for i in range(steps):
        batch = _batch(10 * steps + i)
        jstate, jm = jstep(jstate, *map(jnp.asarray, batch))
        state, m = step(state, *map(torch.from_numpy, batch))
        assert set(m) == set(jm) == {"loss", "policy_ce", "value_mse",
                                     "grad_norm", "nonfinite"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=TOL,
                                       rtol=TOL, err_msg=k)
        assert float(m["nonfinite"]) == 0.0
    got, want = _port_tree(state), _jax_tree(jstate)
    assert int(got["step"]) == int(want["step"]) == steps
    _assert_close(got, want)
    # the statistics really moved: BatchNorm ran in train mode
    first = from_jax_variables(variables)
    moved = state.net.state_dict()
    assert not torch.equal(moved["stem_bn.running_var"],
                           first["stem_bn.running_var"])


def test_nonfinite_batch_leaves_state_unchanged():
    cfg = _cfg(1, 8)
    variables = seeded_flax_variables(9, cfg, 3)
    trace = _trace_tree(variables, 6)
    state, step = _port_side(cfg, variables, trace)
    jstate, jstep = _jax_side(cfg, variables, trace)
    boards, policy, values = _batch(4)
    values[2] = np.nan
    before = _port_tree(state)
    state, m = step(state, *map(torch.from_numpy, (boards, policy, values)))
    _, jm = jstep(jstate, *map(jnp.asarray, (boards, policy, values)))
    assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 1.0
    after = _port_tree(state)
    assert int(after["step"]) == 0
    for a, b in zip(jax.tree_util.tree_leaves(after),
                    jax.tree_util.tree_leaves(before)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the next finite batch is applied
    state, m = step(state, *map(torch.from_numpy, _batch(5)))
    assert float(m["nonfinite"]) == 0.0 and int(state.step) == 1


def _flat_part(tree, part):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree[part])])


def test_bf16_step_within_twice_jax_gap():
    """The bf16 step against JAX's bf16 step, held to twice JAX's own
    bf16-vs-float32 gap: the updated parameters, momentum trace and
    BatchNorm statistics in L2 over all values, the loss and grad norm
    with the gap floored at one bf16 step (2^-8 relative) of the value,
    since one scalar's gap can vanish by chance."""
    cfg16, cfg32 = _cfg(2, 16, "bfloat16"), _cfg(2, 16, "float32")
    variables = seeded_flax_variables(9, cfg16, 11)
    batch = _batch(12, b=16)
    out = {}
    for name, cfg in (("j16", cfg16), ("j32", cfg32)):
        jstate, jstep = _jax_side(cfg, variables)
        jstate, jm = jstep(jstate, *map(jnp.asarray, batch))
        out[name] = (_jax_tree(jstate), jm)
    state, step = _port_side(cfg16, variables)
    state, m = step(state, *map(torch.from_numpy, batch))
    out["t16"] = (_port_tree(state), m)
    assert state.net.compute_dtype == torch.bfloat16
    for k in ("loss", "grad_norm"):
        t16, j16, j32 = (float(out[n][1][k]) for n in ("t16", "j16", "j32"))
        gap = max(abs(j16 - j32), 2.0 ** -8 * abs(j32))
        assert abs(t16 - j16) <= 2 * gap, (k, t16, j16, j32)
    for part in ("params", "batch_stats", "trace"):
        t16, j16, j32 = (_flat_part(out[n][0], part)
                         for n in ("t16", "j16", "j32"))
        gap = np.linalg.norm(j16 - j32)
        assert 0 < np.linalg.norm(t16 - j16) <= 2 * gap, part


def test_plateau_scheduler_matches_jax():
    metrics = [3.0, 2.5, 2.5, 2.4995, float("nan"), 2.6, 2.7, 2.5,
               float("inf"), 2.8, 2.9, 3.0, 2.2, 2.3, 2.3, 2.3, 2.3, 2.3]
    j = JPlateau(1e-2, factor=0.5, patience=2, min_lr=2e-3)
    t = PlateauScheduler(1e-2, factor=0.5, patience=2, min_lr=2e-3)
    for x in metrics:
        assert t.update(x) == j.update(x)
        assert t.state_dict() == j.state_dict()
    assert t.lr == 2e-3                   # reached the floor
    t2 = PlateauScheduler(1.0)
    t2.load_state_dict(j.state_dict())
    assert t2.state_dict() == j.state_dict()
