"""utils/metrics.py:profile_trace, the port's counterpart of the JAX
package's jax.profiler hook: a torch.profiler trace of a block, written
as a Chrome trace that names the aten calls of the net's forward;
nothing is written when it is off."""
import json

import torch

from sejonggo_torch.config import NetConfig
from sejonggo_torch.nets import AZNet, make_predict_fn
from sejonggo_torch.utils.metrics import profile_trace
from test_torch_heuristics import one_torch_thread  # noqa: F401


def _forward():
    net = AZNet.from_config(5, NetConfig(blocks=1, filters=8, value_hidden=8,
                                         compute_dtype="float32"))
    return make_predict_fn(net)(torch.zeros(2, 5, 5, 17))


def test_profile_trace_writes_a_chrome_trace_of_the_forward(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        policy, _ = _forward()
    assert prof is not None and policy.shape == (2, 26)
    (path,) = (tmp_path / "trace").iterdir()
    assert path.name.startswith("trace_") and path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::conv2d" in names and "aten::softmax" in names


def test_profile_trace_off_writes_nothing(tmp_path):
    with profile_trace(str(tmp_path / "trace"), enabled=False) as prof:
        _forward()
    assert prof is None and not (tmp_path / "trace").exists()
