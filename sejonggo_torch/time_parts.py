"""Times of the move step's parts on one CUDA card: the net call, the
expand/backup of one search round, and the whole move step at the bench
point.

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
step is timed over moves 3-6.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
