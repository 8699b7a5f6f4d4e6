"""The read side of the JAX package's checkpoint store (port of
sejonggo_tpu/learn/checkpoint.py:CheckpointStore).

A model directory holds ``model_<N>.msgpack`` files (flax msgpack of
params, batch_stats, opt_state and step) and an ``index.json`` whose
"best" names the gated model.  ``latest`` is the highest N.  The files
are read with the port's own decoder (``learn/msgpack.py``); writing,
resume and the fallback to an older model wait for the training slice.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, List, Optional

from sejonggo_torch.learn.msgpack import restore

logger = logging.getLogger("sejonggo_torch.checkpoint")


class CheckpointStore:
    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self._index_path = os.path.join(model_dir, "index.json")

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

    def best_name(self) -> Optional[str]:
        """The gated model named by index.json, None without an index."""
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f).get("best")
        return None

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, f"{name}.msgpack")

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def load_variables(self, name: str) -> Dict:
        """{"params", "batch_stats"} of checkpoint ``name`` as numpy trees
        (``nets.from_jax_variables`` turns them into an AZNet state)."""
        tree = restore(self._path(name))
        return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
