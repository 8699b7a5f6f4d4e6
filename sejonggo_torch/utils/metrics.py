"""Metrics, timing and a profiler trace (port of
sejonggo_tpu/utils/metrics.py).

Reference counterpart: wall-clock deltas in tqdm descriptions and log
lines (self_play.py:332-334, evaluator.py:38), TensorBoard scalar
writing via the fake-epoch trick (train.py:63-70), rotating-file
logging config (app_log.py, logconfig.json).  Here: a JSONL metrics
stream with env-steps/s and sims/s counters.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


class Timer:
    """Context manager measuring wall seconds; .rate(n) = n/seconds."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.seconds = 0.0
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False

    def rate(self, n: float) -> float:
        return n / max(self.seconds, 1e-9)


class MetricsLogger:
    """Append-only JSONL metrics (one dict per event)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, event: str, **fields) -> Dict:
        rec = {"event": event, "ts": time.time(), **fields}
        self.events.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        return rec

    def last(self, event: str) -> Optional[Dict]:
        for rec in reversed(self.events):
            if rec["event"] == event:
                return rec
        return None


def setup_logging(log_dir: Optional[str] = None, level: int = 20,
                  max_bytes: int = 10 * 1024 * 1024,
                  backup_count: int = 5) -> None:
    """Rotating-file logging (reference app_log.py:6-24 + logconfig.json:
    rotating info/debug/errors files plus console).  With log_dir=None
    only the console handler is installed."""
    import logging
    from logging.handlers import RotatingFileHandler

    root = logging.getLogger()
    # keep root at `level` (a global DEBUG root makes library loggers
    # flood the files); the debug.log handler still captures package
    # debug when callers lower individual logger levels
    root.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s %(message)s")
    console = logging.StreamHandler()
    console.setLevel(level)
    console.setFormatter(fmt)
    root.addHandler(console)
    if not log_dir:
        return
    os.makedirs(log_dir, exist_ok=True)
    for fname, lvl in (("info.log", logging.INFO),
                       ("debug.log", logging.DEBUG),
                       ("errors.log", logging.ERROR)):
        h = RotatingFileHandler(os.path.join(log_dir, fname),
                                maxBytes=max_bytes, backupCount=backup_count)
        h.setLevel(lvl)
        h.setFormatter(fmt)
        root.addHandler(h)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace around a block (the host's aten calls,
    and the card's kernels when CUDA is available), written on exit as a
    Chrome trace ``trace_<pid>_<ns>.json`` in ``log_dir`` (open it in
    Perfetto or chrome://tracing); the profiler is yielded.  The
    counterpart of the JAX package's ``jax.profiler`` hook: the reference
    had no profiler integration at all (SURVEY.md §5).  ``enabled=False``
    runs the block untraced and writes nothing."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
