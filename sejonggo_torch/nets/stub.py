"""Deterministic predict functions for tests and kernel-path checks
(port of sejonggo_tpu/nets/stub.py; the reference's DummyModel,
test/tests.py:34-49: decreasing policy, value 1)."""
from __future__ import annotations

import torch


def dummy_predict_fn(boards: torch.Tensor):
    """policy[i] = (A - i) / sum, value = 1, on the boards' device."""
    b, n = boards.shape[0], boards.shape[-3]
    a = n * n + 1
    ramp = torch.arange(a, 0, -1, dtype=torch.float32, device=boards.device)
    policy = (ramp / ramp.sum()).expand(b, a)
    return policy, torch.ones((b, 1), dtype=torch.float32, device=boards.device)

