"""Loss functions (port of sejonggo_tpu/nets/losses.py).

Reference loss (model.py:49-52) applies `mse + categorical_crossentropy`
to BOTH heads.  For the scalar tanh value head, Keras's
categorical_crossentropy normalizes the prediction across its (single)
axis, so the CE term degenerates to zero and the value loss is
effectively MSE; the policy loss is MSE + CE.  'reference' mode
replicates that effective behavior; 'agz' is the AlphaGo-Zero paper
loss (CE policy + MSE value).
"""
from __future__ import annotations

import torch


def az_loss(policy_logits, values, policy_target, value_target,
            mode: str = "agz"):
    """Per-batch mean loss and its parts.

    policy_logits: (B, A); values: (B, 1) or (B,); policy_target: (B, A)
    (need not be normalized — the reference's prior-targets aren't);
    value_target: (B,) in [-1, 1].
    """
    values = values.reshape(-1)
    value_target = value_target.reshape(-1).to(values.dtype)
    logp = torch.log_softmax(policy_logits, dim=-1)
    ce = -(policy_target * logp).sum(-1)
    mse_v = (values - value_target).square()
    if mode == "agz":
        total = ce + mse_v
    elif mode == "reference":
        mse_p = (logp.exp() - policy_target).square().mean(-1)
        total = (mse_p + ce) + mse_v
    else:
        raise ValueError(f"unknown loss mode {mode!r}")
    loss = total.mean()
    return loss, {"loss": loss, "policy_ce": ce.mean(),
                  "value_mse": mse_v.mean()}
