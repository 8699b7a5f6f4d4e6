"""Flax variable trees (numpy arrays) -> AZNet ``state_dict``.

Conv kernels go from HWIO to OIHW, Dense kernels (in, out) to Linear
weights (out, in); BatchNorm ``scale``/``bias`` and ``batch_stats``
``mean``/``var`` become ``weight``/``bias``/``running_mean``/
``running_var``.  The flax module names follow its compact order:
Conv_0/BatchNorm_0 (stem), ResBlock_i, Conv_1/BatchNorm_1/policy_out
(policy head), Conv_2/BatchNorm_2/Dense_0/value_out (value head).

``seeded_flax_variables`` makes a random tree at the flax shapes from a
seed with numpy, so a run can build weights without flax or a file.
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
    out[prefix + ".running_mean"] = _tensor(stats["mean"])
    out[prefix + ".running_var"] = _tensor(stats["var"])
    out[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def from_jax_variables(variables: dict) -> dict:
    """{'params': ..., 'batch_stats': ...} of numpy arrays at the flax
    shapes -> AZNet state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict = {}
    for name, sub in params.items():
        if name.startswith("ResBlock_"):
            i = int(name.split("_")[1])
            for fname, tname in _BLOCK.items():
                _module(f"blocks.{i}.{tname}", sub[fname],
                        stats.get(name, {}).get(fname), out)
        elif name in _TOP:
            _module(_TOP[name], sub, stats.get(name), out)
        else:
            raise KeyError(f"unexpected flax module {name!r}")
    return out


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
