"""The write side of the port's checkpoint store against flax: model_291
read into the port's net and optimiser state and written back gives the
file's bytes; the JAX store reads a port-written checkpoint bit-equal,
the port reads a JAX-written one bit-equal; naming, the best pointer and
the fallback from a torn file work as in the JAX store."""
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from sejonggo_tpu.learn import CheckpointStore as JStore
from sejonggo_tpu.learn import make_optimizer as j_make_optimizer
from sejonggo_tpu.learn import make_train_step as j_make_train_step
from sejonggo_tpu.learn.train import init_train_state as j_init_train_state
from sejonggo_tpu.nets import AZNet as JNet
from sejonggo_tpu.nets import init_variables as j_init_variables
from sejonggo_torch.config import NetConfig, strength_9x9_xl
from sejonggo_torch.learn import (CheckpointStore, init_train_state,
                                  make_optimizer, make_train_step, packb)
from sejonggo_torch.learn.checkpoint import state_tree
from sejonggo_torch.nets import AZNet, from_jax_variables

MODELS = pathlib.Path(__file__).resolve().parents[1] / \
    "runs/strength_r5b/sp_models"
CFG = NetConfig(blocks=1, filters=8, value_hidden=8, compute_dtype="float32")


def _batch(seed, b=8):
    rng = np.random.RandomState(seed)
    boards = (rng.rand(b, 9, 9, 17) < 0.3).astype(np.float32)
    policy = rng.rand(b, 82).astype(np.float32)
    values = rng.choice([-1.0, 1.0], size=b).astype(np.float32)
    return boards, policy, values


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _jax_state_dict(state):
    from flax import serialization
    return jax.device_get({
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": serialization.to_state_dict(state.opt_state),
        "step": np.asarray(state.step)})


def test_model_291_rewritten_byte_equal(tmp_path):
    store = CheckpointStore(str(tmp_path / "models"))
    src = CheckpointStore(str(MODELS))
    net = AZNet.from_config(9, strength_9x9_xl().net)
    state = src.load_state("model_291", net)
    assert int(state.step) == 74240
    assert float(state.opt_state.abs().max()) > 0     # a real trace
    store.save_state("model_291", state)
    assert (tmp_path / "models/model_291.msgpack").read_bytes() == \
        (MODELS / "model_291.msgpack").read_bytes()


def test_jax_reads_port_checkpoint_bit_equal(tmp_path):
    net = AZNet.from_config(9, CFG)
    jnet = JNet.from_config(9, CFG)
    variables = jax.device_get(j_init_variables(jnet, jax.random.PRNGKey(1)))
    net.load_state_dict(from_jax_variables(variables))
    state = init_train_state(net)
    step = make_train_step(make_optimizer())
    for i in range(2):
        state, _ = step(state, *map(torch.from_numpy, _batch(i)))
    CheckpointStore(str(tmp_path)).save_state("model_2", state)
    tx = j_make_optimizer()
    template = j_init_train_state(jnet, j_init_variables(
        jnet, jax.random.PRNGKey(9)), tx)
    restored = JStore(str(tmp_path)).load_state("model_2", template)
    want = state_tree(state)
    _leaves_equal(_jax_state_dict(restored), want)
    assert int(restored.step) == 2


def test_port_reads_jax_checkpoint_bit_equal(tmp_path):
    jnet = JNet.from_config(9, CFG)
    tx = j_make_optimizer()
    jstate = j_init_train_state(jnet, j_init_variables(
        jnet, jax.random.PRNGKey(2)), tx)
    jstate, _ = j_make_train_step(jnet, tx)(
        jstate, *map(jnp.asarray, _batch(3)))
    want = _jax_state_dict(jstate)
    JStore(str(tmp_path)).save_state("model_5", jstate)
    state = CheckpointStore(str(tmp_path)).load_state(
        "model_5", AZNet.from_config(9, CFG))
    got = state_tree(state)
    _leaves_equal(got, want)
    # and writes it back in the same bytes
    data = (tmp_path / "model_5.msgpack").read_bytes()
    CheckpointStore(str(tmp_path)).save_state("model_6", state)
    assert (tmp_path / "model_6.msgpack").read_bytes() == data


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -0.0, None, True, False, "", "a" * 31, "a" * 32, "a" * 256,
    "a" * 65536, b"", b"x" * 255, b"x" * 256, b"x" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)}])
def test_primitives_encode_like_msgpack(obj):
    assert packb(obj) == msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("arr", [
    np.zeros((), np.int32), np.arange(3, dtype=np.float32),
    np.zeros((2, 3, 4), np.int8), np.zeros(0, np.float32),
    np.ones(1, bool), np.arange(1000, dtype=np.float64).reshape(10, 100),
    np.zeros(3, np.uint16), np.zeros(2, np.float32)])
def test_arrays_encode_like_flax(arr):
    from flax import serialization
    tree = {"a": arr, "b": {"c": arr, "d": {}}}
    assert packb(tree) == serialization.msgpack_serialize(tree)


def test_names_and_best_pointer_like_jax(tmp_path):
    t = CheckpointStore(str(tmp_path / "t"))
    j = JStore(str(tmp_path / "j"))
    assert t.next_name() == j.next_name() == "model_1"
    assert t.best_name() is None
    net = AZNet.from_config(9, CFG)
    state = init_train_state(net)
    for name in ("model_1", "model_2", "model_10"):
        t.save_state(name, state)
        shutil.copy(tmp_path / "t" / f"{name}.msgpack", tmp_path / "j")
        assert t.latest_name() == j.latest_name() == name
        assert t.next_name() == j.next_name()
    assert t.next_name() == "model_11"
    t.set_best("model_2")
    j.set_best("model_2")
    assert (tmp_path / "t/index.json").read_text() == \
        (tmp_path / "j/index.json").read_text()
    assert t.best_name() == "model_2"
    assert not [f for f in os.listdir(tmp_path / "t") if f.endswith(".tmp")]


def test_torn_checkpoint_falls_back(tmp_path):
    """As tests/test_learn.py's torn-write test: a truncated model_2 is
    skipped for the newest loadable model, model_1."""
    store = CheckpointStore(str(tmp_path))
    net = AZNet.from_config(9, CFG)
    net.load_state_dict(from_jax_variables(jax.device_get(j_init_variables(
        JNet.from_config(9, CFG), jax.random.PRNGKey(0)))))
    state = init_train_state(net)
    store.save_state("model_1", state)
    want = state_tree(state)
    state, _ = make_train_step(make_optimizer())(
        state, *map(torch.from_numpy, _batch(0)))
    store.save_state("model_2", state)
    store.set_best("model_2")
    p2 = tmp_path / "model_2.msgpack"
    p2.write_bytes(p2.read_bytes()[: p2.stat().st_size // 2])
    restored = store.load_state_or_fallback("model_2",
                                            AZNet.from_config(9, CFG))
    assert int(restored.step) == 0
    _leaves_equal(state_tree(restored), want)
