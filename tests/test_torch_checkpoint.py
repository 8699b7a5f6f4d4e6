"""The port's checkpoint reader against flax: learn/msgpack.py decodes
the committed model_291 checkpoint (6 blocks x 96 filters, 9x9) into the
same arrays as flax.serialization.msgpack_restore, CheckpointStore finds
models and pointers as the JAX store does, and the net built from the
file predicts as flax does (float32, within 1e-4)."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from sejonggo_tpu.config import strength_9x9_xl as j_xl
from sejonggo_tpu.learn.checkpoint import CheckpointStore as JStore
from sejonggo_tpu.nets import AZNet as JNet
from sejonggo_tpu.nets import make_predict_fn as j_make_predict
from sejonggo_torch.config import strength_9x9_xl
from sejonggo_torch.learn import CheckpointStore, restore
from sejonggo_torch.learn import msgpack as port_msgpack
from sejonggo_torch.nets import AZNet, from_jax_variables, make_predict_fn
from test_torch_heuristics import one_torch_thread  # noqa: F401

MODELS = pathlib.Path(__file__).resolve().parents[1] / \
    "runs/strength_r5b/sp_models"
MODEL_291 = MODELS / "model_291.msgpack"


def test_model_291_decodes_like_flax():
    want = serialization.msgpack_restore(MODEL_291.read_bytes())
    got = restore(str(MODEL_291))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) > 100
    for (path, w), (gpath, g) in zip(leaves,
                                     jax.tree_util.tree_leaves_with_path(got)):
        assert path == gpath
        w, g = np.asarray(w), np.asarray(g)
        assert (g.shape, g.dtype) == (w.shape, w.dtype), path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("obj", [
    {"a": [1, -1, 127, 128, -33, 65535, 2 ** 40, -2 ** 40], "b": None,
     "c": True, "d": False, "e": 1.5, "f": "x" * 40, "g": b"\x00" * 300},
    {"n": {str(i): i for i in range(20)}, "l": list(range(70000))},
    {"s": "é" * 70000, "bin": bytes(range(256)) * 300},
])
def test_primitives_decode_like_msgpack(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert port_msgpack.unpackb(data) == msgpack.unpackb(data, raw=False)


@pytest.mark.parametrize("arr", [
    np.arange(24, dtype=np.int8).reshape(2, 3, 4),
    np.linspace(-1, 1, 7, dtype=np.float64),
    np.ones((0, 3), np.float32),
    np.asarray(5, np.int32),
    np.array([True, False]),
])
def test_flax_arrays_decode(arr):
    data = serialization.msgpack_serialize({"x": arr})
    got = port_msgpack.unpackb(data)["x"]
    assert got.shape == arr.shape and got.dtype == arr.dtype
    assert got.tobytes() == arr.tobytes()


def test_other_ext_codes_and_dtypes_raise():
    scalar = serialization.msgpack_serialize({"x": np.float32(2.0)})  # ext 3
    with pytest.raises(ValueError, match="ext type 3"):
        port_msgpack.unpackb(scalar)
    bf16 = serialization.msgpack_serialize({"x": jnp.ones(3, jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        port_msgpack.unpackb(bf16)
    with pytest.raises(ValueError, match="ends inside"):
        port_msgpack.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="follow"):
        port_msgpack.unpackb(msgpack.packb(1) + b"\x00")


def test_store_names_and_pointers_like_jax(tmp_path):
    for n in (3, 12, 7):
        (tmp_path / f"model_{n}.msgpack").write_bytes(MODEL_291.read_bytes()[:64])
    (tmp_path / "model_40.msgpack").write_bytes(b"")       # empty: skipped
    (tmp_path / "model_x.msgpack").write_bytes(b"1")        # not a model
    (tmp_path / "notes.txt").write_text("")
    store, jstore = CheckpointStore(str(tmp_path)), JStore(str(tmp_path))
    assert store.model_names() == jstore.model_names() == \
        ["model_12", "model_7", "model_3"]
    assert store.latest_name() == jstore.latest_name() == "model_12"
    assert store.best_name() is None and jstore.best_name() is None
    (tmp_path / "index.json").write_text(json.dumps({"best": "model_7"}))
    assert store.best_name() == jstore.best_name() == "model_7"
    assert store.exists("model_3") and not store.exists("model_4")
    empty = CheckpointStore(str(tmp_path / "nothing"))
    assert (tmp_path / "nothing").is_dir()      # made, as JAX's store does
    assert empty.latest_name() is None and empty.best_name() is None


def test_model_291_net_predicts_like_flax():
    store = CheckpointStore(str(MODELS))
    assert store.best_name() == "model_291" == store.latest_name()
    variables = store.load_variables("model_291")
    assert set(variables) == {"params", "batch_stats"}
    jnet = JNet.from_config(9, dataclasses.replace(j_xl().net,
                                                   compute_dtype="float32"))
    net = AZNet.from_config(9, dataclasses.replace(strength_9x9_xl().net,
                                                   compute_dtype="float32"))
    net.load_state_dict(from_jax_variables(variables))
    rng = np.random.RandomState(0)
    boards = (rng.rand(32, 9, 9, 17) < 0.3).astype(np.int8)
    boards[..., 16] = rng.choice([-1, 1], size=(32, 1, 1))
    jp, jv = jax.jit(j_make_predict(jnet))(variables, jnp.asarray(boards))
    tp, tv = make_predict_fn(net)(torch.from_numpy(boards))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4, rtol=0)
