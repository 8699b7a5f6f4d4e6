"""Checkpoint store with the reference's best/latest model identities
(port of sejonggo_tpu/learn/checkpoint.py:CheckpointStore).

A model directory holds ``model_<N>.msgpack`` files (flax msgpack of
params, batch_stats, opt_state and step) and an ``index.json`` whose
"best" names the gated model.  ``latest`` is the highest N.  The files
are read and written with the port's own msgpack code
(``learn/msgpack.py``) in the bytes flax writes, so either package reads
the other's checkpoints.  The optimiser state has optax's shape for the
masked-decay SGD chain: ``{"0": {"inner_state": {}}, "1": {"0": {"trace":
<params tree>}, "1": {}}}``.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from sejonggo_torch.learn.msgpack import packb, restore
from sejonggo_torch.learn.train import TrainState, init_train_state
from sejonggo_torch.nets import from_jax_variables, to_jax_params, to_jax_variables

logger = logging.getLogger("sejonggo_torch.checkpoint")


def state_tree(state: TrainState) -> dict:
    """The flax checkpoint tree of ``state`` (numpy arrays, keys in the
    order flax writes them)."""
    variables = to_jax_variables(state.net.state_dict())
    params = dict(state.net.named_parameters())
    parts = state.opt_state.detach().split([p.numel() for p in params.values()])
    trace = {n: part.view_as(p) for (n, p), part in zip(params.items(), parts)}
    return {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": {"0": {"inner_state": {}},
                      "1": {"0": {"trace": to_jax_params(trace)}, "1": {}}},
        "step": np.asarray(int(state.step), np.int32),
    }


class CheckpointStore:
    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self._index_path = os.path.join(model_dir, "index.json")

    # --- naming (reference model_<N> scheme) ---------------------------

    def model_names(self) -> List[str]:
        """All model_<N> checkpoints, newest first, skipping empty files
        and files that vanish mid-scan."""
        found = []
        for fn in os.listdir(self.model_dir):
            m = re.fullmatch(r"(model_(\d+))\.msgpack", fn)
            if not m:
                continue
            try:
                if os.path.getsize(os.path.join(self.model_dir, fn)) == 0:
                    logger.warning("skipping empty checkpoint %s", fn)
                    continue
            except OSError:
                continue
            found.append((int(m.group(2)), m.group(1)))
        return [name for _, name in sorted(found, reverse=True)]

    def latest_name(self) -> Optional[str]:
        """The highest model index (reference model.py:125-144)."""
        names = self.model_names()
        return names[0] if names else None

    def next_name(self) -> str:
        """Reference train.py:29-31: increment the latest index."""
        latest = self.latest_name()
        n = int(latest.split("_")[-1]) + 1 if latest else 1
        return f"model_{n}"

    def best_name(self) -> Optional[str]:
        """The gated model named by index.json, None without an index."""
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f).get("best")
        return None

    def set_best(self, name: str) -> None:
        """Promotion (reference elect_model_as_best_model evaluator.py:18-21)."""
        idx = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                idx = json.load(f)
        idx["best"] = name
        with open(self._index_path, "w") as f:
            json.dump(idx, f)

    # --- state io -------------------------------------------------------

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, f"{name}.msgpack")

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def save_state(self, name: str, state: TrainState) -> None:
        """Atomic write (tmp + os.replace): a crash mid-save must never
        leave a torn model_<N>.msgpack that latest_name()/best would then
        serve forever (other deployment roles poll this directory)."""
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(packb(state_tree(state)))
        os.replace(tmp, path)

    def load_state(self, name: str, net: nn.Module) -> TrainState:
        """Checkpoint ``name`` loaded into ``net`` (its parameters and
        running statistics are overwritten), with the momentum trace and
        step.  Raises on an unreadable file or a tree that does not fit
        the net."""
        tree = restore(self._path(name))
        net.load_state_dict(from_jax_variables(tree))
        trace = from_jax_variables({"params": tree["opt_state"]["1"]["0"]["trace"]})
        parts = []
        for n, p in net.named_parameters():
            if trace[n].shape != p.shape:
                raise ValueError(f"momentum trace of {n} has shape "
                                 f"{tuple(trace[n].shape)}, not {tuple(p.shape)}")
            parts.append(trace[n].reshape(-1))
        return init_train_state(net, int(tree["step"]), torch.cat(parts))

    def load_state_or_fallback(self, name: str, net: nn.Module) -> TrainState:
        """Load `name`; on failure (missing/torn file — e.g. a dangling
        best pointer or a checkpoint corrupted by a crash mid-write
        before saves were atomic) fall back to the newest loadable
        model with a loud warning instead of crashing the run.

        Reference posture: idempotent resume (selfplay_worker.py:84-90)
        — a wedged artifact must not brick every role polling the
        directory."""
        try:
            return self.load_state(name, net)
        except Exception as e:  # noqa: BLE001 — any parse/IO failure
            logger.error("checkpoint %r unreadable (%s); falling back to "
                         "newest loadable model", name, e)
            for cand in self.model_names():
                if cand == name:
                    continue
                try:
                    state = self.load_state(cand, net)
                except Exception as e2:  # noqa: BLE001
                    logger.error("checkpoint %r also unreadable (%s)",
                                 cand, e2)
                    continue
                logger.warning("serving %r in place of unreadable %r",
                               cand, name)
                return state
            raise

    def load_variables(self, name: str) -> Dict:
        """{"params", "batch_stats"} of checkpoint ``name`` as numpy trees
        (``nets.from_jax_variables`` turns them into an AZNet state)."""
        tree = restore(self._path(name))
        return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
