"""Flax variable trees (numpy arrays) <-> AZNet ``state_dict``.

Conv kernels go from HWIO to OIHW, Dense kernels (in, out) to Linear
weights (out, in); BatchNorm ``scale``/``bias`` and ``batch_stats``
``mean``/``var`` become ``weight``/``bias``/``running_mean``/
``running_var``.  The flax module names follow its compact order:
Conv_0/BatchNorm_0 (stem), ResBlock_i, Conv_1/BatchNorm_1/policy_out
(policy head), Conv_2/BatchNorm_2/Dense_0/value_out (value head).
``to_jax_variables``/``to_jax_params`` go back, with every dict's keys in
the sorted order of the trees flax writes to its checkpoints.

``seeded_flax_variables`` makes a random tree at the flax shapes from a
seed with numpy, so a run can build weights without flax or a file;
``init_variables`` draws flax's own initial tree from a torch Generator.
"""
from __future__ import annotations

import numpy as np
import torch

from sejonggo_torch.config import NetConfig

# flax module -> AZNet prefix, outside the residual blocks
_TOP = {
    "Conv_0": "stem_conv", "BatchNorm_0": "stem_bn",
    "Conv_1": "policy_conv", "BatchNorm_1": "policy_bn",
    "policy_out": "policy_out",
    "Conv_2": "value_conv", "BatchNorm_2": "value_bn",
    "Dense_0": "value_hidden", "value_out": "value_out",
}
_BLOCK = {"Conv_0": "conv1", "BatchNorm_0": "bn1",
          "Conv_1": "conv2", "BatchNorm_1": "bn2"}


_FROM_TOP = {v: k for k, v in _TOP.items()}
_FROM_BLOCK = {v: k for k, v in _BLOCK.items()}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _module(prefix: str, params: dict, stats: dict | None, out: dict) -> None:
    if "kernel" in params:
        k = np.asarray(params["kernel"])
        if k.ndim == 4:      # conv HWIO -> OIHW
            out[prefix + ".weight"] = _tensor(k.transpose(3, 2, 0, 1))
        else:                # dense (in, out) -> linear (out, in)
            out[prefix + ".weight"] = _tensor(k.T)
        out[prefix + ".bias"] = _tensor(params["bias"])
        return
    out[prefix + ".weight"] = _tensor(params["scale"])
    out[prefix + ".bias"] = _tensor(params["bias"])
    if stats is None:        # a tree of parameters only (a momentum trace)
        return
    out[prefix + ".running_mean"] = _tensor(stats["mean"])
    out[prefix + ".running_var"] = _tensor(stats["var"])
    out[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def from_jax_variables(variables: dict) -> dict:
    """{'params': ..., 'batch_stats': ...} of numpy arrays at the flax
    shapes -> AZNet state_dict.  Without 'batch_stats' the tree is one of
    parameters only (a momentum trace) and so is the result."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    sub_stats = (lambda name: None) if stats is None else stats.get
    out: dict = {}
    for name, sub in params.items():
        if name.startswith("ResBlock_"):
            i = int(name.split("_")[1])
            bstats = sub_stats(name)
            for fname, tname in _BLOCK.items():
                _module(f"blocks.{i}.{tname}", sub[fname],
                        None if bstats is None else bstats.get(fname), out)
        elif name in _TOP:
            _module(_TOP[name], sub, sub_stats(name), out)
        else:
            raise KeyError(f"unexpected flax module {name!r}")
    return out


def _flax_module(prefix: str) -> tuple:
    """AZNet module prefix -> its path in the flax tree."""
    if prefix.startswith("blocks."):
        _, i, tname = prefix.split(".")
        return f"ResBlock_{i}", _FROM_BLOCK[tname]
    return (_FROM_TOP[prefix],)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A C-order copy (never a view of the tensor, which may change)."""
    return t.detach().cpu().numpy().copy()


def _sorted(tree: dict) -> dict:
    """``tree`` with every dict's keys sorted, the order of the trees
    flax writes (jax's tree functions sort dict keys)."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def to_jax_params(named: dict) -> dict:
    """{AZNet parameter name: tensor} -> the flax ``params`` tree of numpy
    arrays (also used for a momentum trace, which has its shape)."""
    tree: dict = {}
    for name, t in named.items():
        prefix, leaf = name.rsplit(".", 1)
        node = tree
        for key in _flax_module(prefix):
            node = node.setdefault(key, {})
        a = _numpy(t)
        if a.ndim == 4:                      # conv OIHW -> HWIO
            node["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif a.ndim == 2:                    # linear (out, in) -> (in, out)
            node["kernel"] = np.ascontiguousarray(a.T)
        elif leaf == "weight":               # BatchNorm scale
            node["scale"] = a
        else:
            node["bias"] = a
    return _sorted(tree)


def to_jax_variables(state_dict: dict) -> dict:
    """AZNet state_dict -> {'params': ..., 'batch_stats': ...} of numpy
    arrays at the flax shapes, keys in flax's checkpoint order (the
    inverse of ``from_jax_variables``)."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        prefix, leaf = name.rsplit(".", 1)
        if leaf in ("running_mean", "running_var"):
            node = stats
            for key in _flax_module(prefix):
                node = node.setdefault(key, {})
            node["mean" if leaf == "running_mean" else "var"] = _numpy(t)
        elif leaf != "num_batches_tracked":
            params[name] = t
    return {"params": to_jax_params(params), "batch_stats": _sorted(stats)}


def seeded_flax_variables(size: int, cfg: NetConfig, seed: int) -> dict:
    """Random variables at the flax shapes of AZNet(size, cfg), made with
    numpy from ``seed``: LeCun-normal kernels, small random biases and
    BatchNorm affine/statistics near identity."""
    rng = np.random.RandomState(seed)
    f, nn_ = cfg.filters, size * size

    def conv(kh, cin, cout):
        k = rng.randn(kh, kh, cin, cout) / np.sqrt(kh * kh * cin)
        return {"kernel": k.astype(np.float32),
                "bias": (0.01 * rng.randn(cout)).astype(np.float32)}

    def dense(cin, cout):
        return {"kernel": (rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32),
                "bias": (0.01 * rng.randn(cout)).astype(np.float32)}

    def bn(c):
        return ({"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                 "bias": (0.1 * rng.randn(c)).astype(np.float32)},
                {"mean": (0.1 * rng.randn(c)).astype(np.float32),
                 "var": (1 + 0.1 * rng.rand(c)).astype(np.float32)})

    params: dict = {}
    stats: dict = {}

    def put_bn(tree_p, tree_s, name, c):
        tree_p[name], tree_s[name] = bn(c)

    params["Conv_0"] = conv(3, 17, f)
    put_bn(params, stats, "BatchNorm_0", f)
    for i in range(cfg.blocks):
        bp: dict = {}
        bs: dict = {}
        bp["Conv_0"] = conv(3, f, f)
        put_bn(bp, bs, "BatchNorm_0", f)
        bp["Conv_1"] = conv(3, f, f)
        put_bn(bp, bs, "BatchNorm_1", f)
        params[f"ResBlock_{i}"] = bp
        stats[f"ResBlock_{i}"] = bs
    params["Conv_1"] = conv(1, f, cfg.policy_filters)
    put_bn(params, stats, "BatchNorm_1", cfg.policy_filters)
    params["policy_out"] = dense(cfg.policy_filters * nn_, nn_ + 1)
    params["Conv_2"] = conv(1, f, cfg.value_filters)
    put_bn(params, stats, "BatchNorm_2", cfg.value_filters)
    params["Dense_0"] = dense(cfg.value_filters * nn_, cfg.value_hidden)
    params["value_out"] = dense(cfg.value_hidden, 1)
    return {"params": params, "batch_stats": stats}


def init_variables(size: int, cfg: NetConfig,
                   generator: torch.Generator) -> dict:
    """The variables flax's ``AZNet.init`` makes, drawn from
    ``generator``: LeCun-normal kernels (a normal truncated to +-2
    standard deviations, scaled to variance 1/fan_in as
    ``jax.nn.initializers.lecun_normal``), zero biases, BatchNorm scale 1
    and bias 0, running mean 0 and variance 1.  Numpy trees at the flax
    shapes, in flax's key order."""
    # stddev of a unit normal truncated to [-2, 2] (jax's variance_scaling)
    trunc_std = 0.87962566103423978
    f, nn_ = cfg.filters, size * size

    def kernel(shape, fan_in):
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (t * float(np.sqrt(1.0 / fan_in) / trunc_std)).numpy()

    def conv(kh, cin, cout):
        return {"bias": np.zeros(cout, np.float32),
                "kernel": kernel((kh, kh, cin, cout), kh * kh * cin)}

    def dense(cin, cout):
        return {"bias": np.zeros(cout, np.float32),
                "kernel": kernel((cin, cout), cin)}

    def bn(c):
        return ({"bias": np.zeros(c, np.float32),
                 "scale": np.ones(c, np.float32)},
                {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32)})

    params: dict = {"Conv_0": conv(3, 17, f)}
    stats: dict = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn(f)
    for i in range(cfg.blocks):
        bp, bs = {"Conv_0": conv(3, f, f)}, {}
        bp["BatchNorm_0"], bs["BatchNorm_0"] = bn(f)
        bp["Conv_1"] = conv(3, f, f)
        bp["BatchNorm_1"], bs["BatchNorm_1"] = bn(f)
        params[f"ResBlock_{i}"], stats[f"ResBlock_{i}"] = bp, bs
    params["Conv_1"] = conv(1, f, cfg.policy_filters)
    params["BatchNorm_1"], stats["BatchNorm_1"] = bn(cfg.policy_filters)
    params["policy_out"] = dense(cfg.policy_filters * nn_, nn_ + 1)
    params["Conv_2"] = conv(1, f, cfg.value_filters)
    params["BatchNorm_2"], stats["BatchNorm_2"] = bn(cfg.value_filters)
    params["Dense_0"] = dense(cfg.value_filters * nn_, cfg.value_hidden)
    params["value_out"] = dense(cfg.value_hidden, 1)
    return {"params": _sorted(params), "batch_stats": _sorted(stats)}
