"""Times of the move step's parts on one CUDA card: the net call, the
expand/backup of one search round, and the whole move step at the bench
point; and of the strength_9x9_xl train step.

    python sejonggo_torch/time_parts.py [--root DIR] [--label NAME] [--seed 0]

``--root`` imports the ``sejonggo_torch`` package found in DIR (default:
the checkout this file is in), so that one call can time two trees of
the port in turns: unpack the other tree with ``git archive`` into a
directory and run this file once for each.  A tree whose ``AZNet`` has
no ``compute_dtype`` predates the dtype repair; its net is cast whole to
bf16, as its smoke run did.

Shapes: the bench point (B=3072 games, 64 simulations in rounds of 32,
82 tree slots, a 4x64 bf16 net: 98,304 leaves a round) and
strength_9x9_xl (B=384 self-play games or 128 gate games, 192
simulations in rounds of 32, 256 tree slots, a 6x96 bf16 net: 12,288 or
4,096 leaves a round).  Weights are random, made from ``--seed``.  The
expand/backup is timed on the arguments of the last round of the last
move played (the sixth at the bench point, the second at xl), captured
from the move step, by CUDA events around its calls: host time between
launches counts, as it does in the move step.  The bench point's move
step is timed over moves 3-6.  The train step (batch 256, the 6x96 bf16
net, seeded weights, a seeded replay of 8,192 rows) is timed three ways:
host ms a step as the pipeline runs it (sample, copy to the card, step),
the step alone on a batch already on the card (CUDA events), and the
device time and kernel launches of one step from ``torch.profiler``, with
the operations that take the most device time.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def events_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_net(blocks, filters, hidden, seed, dev):
    """A bf16 net with float32 parameters (the tree's own way of running
    bf16)."""
    import torch

    from sejonggo_torch.config import NetConfig
    from sejonggo_torch.nets import (AZNet, from_jax_variables,
                                     make_predict_fn, seeded_flax_variables)

    cfg = NetConfig(blocks=blocks, filters=filters, value_hidden=hidden,
                    compute_dtype="bfloat16")
    net = AZNet.from_config(9, cfg)
    net.load_state_dict(from_jax_variables(seeded_flax_variables(9, cfg, seed)))
    net = net.to(dev)
    if not hasattr(net, "compute_dtype"):
        net = net.to(torch.bfloat16)
    return make_predict_fn(net)


def boards(b, seed, dev):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = (rng.rand(b, 9, 9, 17) < 0.2).astype(np.float32)
    x[..., 16] = rng.choice([-1, 1], size=(b, 1, 1))
    return torch.from_numpy(x).to(dev)


def run_moves(predict, search, b, n, seed, dev):
    """``n`` self-play moves of B games; returns the seconds of each and
    the arguments of the last expand_backup call."""
    import torch

    from sejonggo_torch.actor import init_state, make_move_step
    from sejonggo_torch.search import mcts

    captured = {}
    inner = mcts.expand_backup

    def capture(*args, **kwargs):
        captured["call"] = (args, kwargs)
        return inner(*args, **kwargs)

    step = make_move_step(predict, search, 9, selfplay=True)
    state = init_state(b, 9, search, device=dev)
    gen = torch.Generator().manual_seed(seed)
    greedy = torch.zeros(b, dtype=torch.bool, device=dev)
    thr = torch.full((b,), float("nan"), device=dev)
    secs = []
    mcts.expand_backup = capture
    try:
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _, _ = step(state, greedy, thr, generator=gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
    finally:
        mcts.expand_backup = inner
    return secs, captured["call"]


def time_train(seed, dev, reps):
    """The xl train step: host ms as the pipeline runs it, event ms on a
    batch on the card, profiler device ms, launches and top operations."""
    import numpy as np
    import torch

    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.learn import (ReplayBuffer, init_train_state,
                                      make_optimizer, make_train_step)
    from sejonggo_torch.nets import (AZNet, from_jax_variables,
                                     seeded_flax_variables)

    cfg = strength_9x9_xl()
    net = AZNet.from_config(9, cfg.net)
    net.load_state_dict(from_jax_variables(
        seeded_flax_variables(9, cfg.net, seed)))
    state = init_train_state(net.to(dev))
    step = make_train_step(make_optimizer(
        cfg.train.lr, cfg.train.momentum, cfg.net.l2), cfg.train.loss_mode)
    rng = np.random.RandomState(seed)
    n, bs = 8192, cfg.train.batch_size
    replay = ReplayBuffer(n, 9, seed)
    replay.add_samples((rng.rand(n, 9, 9, 17) < 0.3).astype(np.int8),
                       rng.rand(n, 82).astype(np.float32),
                       rng.choice([-1.0, 1.0], size=n).astype(np.float32))
    on_card = [torch.from_numpy(x).to(dev) for x in replay.sample(bs)]

    def pipeline_step():
        nonlocal state
        state, _ = step(state, *(torch.from_numpy(x).to(dev)
                                 for x in replay.sample(bs)))

    def card_step():
        nonlocal state
        state, _ = step(state, *on_card)

    for _ in range(3):
        pipeline_step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        pipeline_step()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t) / reps
    event_ms = events_ms(card_step, reps)
    act = torch.profiler.ProfilerActivity
    steps = 5
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(steps):
            card_step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    # the device's own rows (kernels, copies): an operator's row repeats
    # the time of the kernels it launched
    kernels = [e for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / steps / 1e3

    top = sorted(kernels, key=dev_ms, reverse=True)[:8]
    return {
        "host_ms": host_ms, "event_ms": event_ms,
        "profiler_device_ms": sum(dev_ms(e) for e in kernels),
        "device_rows": sum(e.count for e in kernels) / steps,
        "launches": sum(e.count for e in rows
                        if e.key == "cudaLaunchKernel") / steps,
        "top_device_ms": {e.key[:80]: dev_ms(e) for e in top},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path[0] = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("time_parts: no CUDA device", file=sys.stderr)
        return 2
    from sejonggo_torch.config import SearchConfig
    from sejonggo_torch.search import mcts

    dev = torch.device("cuda", 0)
    out = {"label": args.label or args.root, "net_ms": {}, "backup_ms": {}}
    bench = SearchConfig(simulations=64, batch_size=32, use_symmetry=True,
                         max_nodes=82)
    # strength_9x9_xl's search (config.py:strength_9x9_xl)
    xl = SearchConfig(simulations=192, batch_size=32, use_symmetry=True,
                      max_nodes=256, dirichlet_alpha=0.15, negamax=True)
    cases = (("bench", bench, (4, 64, 64), 3072, (98304,)),
             ("xl", xl, (6, 96, 96), 384, (12288, 4096)))
    for name, search, shape, b, leaves in cases:
        predict = build_net(*shape, args.seed, dev)
        x = boards(max(leaves), args.seed, dev)
        for n in leaves:
            out["net_ms"][f"{name}_{n}"] = events_ms(
                lambda: predict(x[:n]), args.reps)
        del x
        secs, (bargs, bkw) = run_moves(predict, search, b, 6 if name == "bench"
                                       else 2, args.seed, dev)
        out["backup_ms"][f"{name}_B{b}"] = events_ms(
            lambda: mcts.expand_backup(*bargs, **bkw), 2 * args.reps)
        if name == "bench":
            timed = secs[2:]
            out["move_ms"] = [1e3 * s for s in timed]
            out["env_steps_per_s"] = (b * search.simulations * len(timed)
                                      / sum(timed))
        else:
            out["xl_move_ms"] = [1e3 * s for s in secs]
    # trees from before the training slice have no train step
    if importlib.util.find_spec("sejonggo_torch.learn.train") is not None:
        out["train"] = time_train(args.seed, dev, args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
