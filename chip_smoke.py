#!/usr/bin/env python3
"""Smoke run of sejonggo_torch on one CUDA card.

Drives the port's 9x9 self-play move step (the path bench.py measures for
the JAX package: B=3072 games, 64 simulations in rounds of 32 leaves, 82
tree slots, a 4-block x 64-filter net with random weights made from
--seed) and holds each hand-written CUDA kernel against its plain PyTorch
version on the card.

    python3 chip_smoke.py [--seed 0]

Phases: 0 device, 1 build (nvcc + ctypes), 2 gostep kernel vs plain,
3 flood kernel vs plain (each bit-exact at the main path's batch, at
19x19 and at ragged batches, then timed on the device by CUDA-graph
replay at the main path's batch, at one block of boards and at 19x19),
4 the move step at the bench point (net parity, launch counts, legality,
env-steps/s), 5 the move step through the kernels vs through the plain
versions.  The kernels' error word is read after every kernel phase.
Every phase prints one line with its elapsed seconds; the line before
the last is the kernel table as JSON, the last line is
{"ok": true, "device": {...}}.  Any failure ends
the run with a nonzero exit code and no result line.  A watchdog ends a
hang with a traceback and a nonzero exit.  Without CUDA, or without the
sejonggo_torch package beside it, the script exits nonzero at once.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
import time

WATCHDOG_S = 1000          # the run must end within 1200 s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` calls enqueued back to back from
    Python, by CUDA events, after one warm-up call.  For a short kernel
    this is the host's enqueue rate, not the kernel: see ``graph_ms``."""
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


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time of one call of ``fn`` (a raw kernel launch): ``reps``
    calls captured in one CUDA graph, the graph replayed ``replays``
    times between CUDA events, the median replay over ``reps``.  No
    Python runs between the launches, so this is the kernels' time back
    to back on the device.  The inputs are the same in every call, so
    they are hot in L2 (as the leaf grids the search just wrote are)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[len(times) // 2]


def kernel_times(launch, block_launch, reps):
    """(device ms, device ms at one block of boards, loop-mean ms) of a
    raw launch, then the error word is read."""
    from sejonggo_torch import ops

    ms = graph_ms(launch, reps)
    floor_ms = graph_ms(block_launch, reps)
    loop_ms = time_ms(launch, reps)
    ops.check_kernel_errors()
    return ms, floor_ms, loop_ms


def positions(size, games, moves, seed, dev):
    """Half uniform, half contact-biased random legal games, played on
    ``dev`` by the port's engine with moves chosen by numpy."""
    import torch

    from sejonggo_torch.goenv.positions import random_positions

    half = games // 2
    parts = [random_positions(size, half, moves, seed, contact=0.0,
                              device=dev),
             random_positions(size, games - half, moves, seed + 1,
                              contact=0.9, device=dev)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def phase_gostep(seed, dev, shapes=((9, 1025, 96, 98304), (19, 32, 64, 2048))):
    """gostep kernel vs step_legal_plain on the card: bit-exact at the
    bench's leaf batch (98,304 of 1025 games x 96 moves, 9x9), at 19x19
    and at ragged batch sizes; device times at both sizes."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.ops import _build, gostep

    row = dict(name="gostep", route="cuda",
               source="sejonggo_torch/csrc/gostep.cu",
               replaces="sejonggo_tpu/ops/gostep.py:171", library_ms=None,
               bound_by="bytes", max_abs_err=0.0)
    for size, games, moves, b in shapes:
        stones, sides, actions = positions(size, games, moves, seed, dev)
        for nb in (b, 1, 31, 33, 3071, b + 1):
            got_s, got_i = gostep.step_legal(stones[:nb], sides[:nb],
                                             actions[:nb])
            exp_s, exp_i = gostep.step_legal_plain(stones[:nb], sides[:nb],
                                                   actions[:nb])
            ops.check_kernel_errors(dev)
            bad = int((got_s != exp_s).sum()) + int((got_i != exp_i).sum())
            err = max(float((got_s.int() - exp_s.int()).abs().max()),
                      float((got_i.int() - exp_i.int()).abs().max()))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if nb == b:
                log(f"gostep {size}x{size} B={b}: mismatches {bad}, "
                    f"max_abs_err {err}, launches so far "
                    f"{gostep.step_legal.launches}")
            check(bad == 0, f"gostep kernel differs from plain at "
                  f"{size}x{size} B={nb}")
        stones, sides, actions = stones[:b], sides[:b], actions[:b]
        out_s = torch.empty_like(stones)
        out_i = torch.empty((b, size * size + 1), dtype=torch.bool, device=dev)
        flag = ops.errors.error_word(dev)
        per_block = _build.load_library().sejonggo_step_legal_block(size)
        ms, floor_ms, loop_ms = kernel_times(
            lambda: gostep._launch(stones, sides, actions, out_s, out_i, flag),
            lambda: gostep._launch(stones[:per_block], sides[:per_block],
                                   actions[:per_block], out_s[:per_block],
                                   out_i[:per_block], flag),
            50)
        nbytes = (stones.numel() + sides.numel() + 4 * actions.numel()
                  + out_s.numel() + out_i.numel())
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"gostep {size}x{size} B={b}: device {ms:.5f} ms (graph replay, "
            f"hot L2), loop-mean {loop_ms:.5f} ms, one block of {per_block} "
            f"boards {floor_ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"({nbytes} bytes)")
        if size == 9:
            plain_ms = time_ms(
                lambda: gostep.step_legal_plain(stones, sides, actions), 3)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       loop_ms=loop_ms, floor_ms=floor_ms, batch=b)
        else:
            row.update({f"ms_{size}x{size}": ms,
                        f"bound_ms_{size}x{size}": bound_ms,
                        f"batch_{size}x{size}": b})
    return row


def phase_flood(seed, dev, shapes=((9, 64, 48), (19, 16, 32))):
    """flood kernel vs flood_plain on the card: bit-exact at the move
    step's batch (3072 = 64 games x 48 moves, 9x9), at 19x19 and at
    ragged batch sizes up to 98,305 (random regions); device times at
    both sizes."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.ops import _build, flood

    row = dict(name="flood", route="cuda",
               source="sejonggo_torch/csrc/flood.cu",
               replaces="sejonggo_tpu/ops/flood.py:70", library_ms=None,
               bound_by="bytes", max_abs_err=0.0)
    for size, games, moves in shapes:
        stones, sides, _ = positions(size, games, moves, seed + 7, dev)
        own = stones == sides[:, None, None]
        empty = stones == 0
        # the engine's capture floods: stones that reach a liberty, and
        # random regions
        g = torch.Generator(device=dev).manual_seed(seed)
        shape = (98305, size, size)
        allowed_r = torch.rand(shape, generator=g, device=dev) < 0.6
        seed_r = allowed_r & (torch.rand(shape, generator=g, device=dev) < 0.1)
        cases = [(own & flood.dilate(empty), own), (seed_r, allowed_r)]
        b = stones.shape[0]
        for s, a in cases:
            for nb in (s.shape[0], 1, 31, 33, 3071):
                got = flood.flood_fixpoint(s[:nb], a[:nb])
                exp = flood.flood_plain(s[:nb], a[:nb])
                ops.check_kernel_errors(dev)
                bad = int((got != exp).sum())
                row["max_abs_err"] = max(
                    row["max_abs_err"], float((got.int() - exp.int()).abs().max()))
                if nb == s.shape[0]:
                    log(f"flood {size}x{size} B={nb}: mismatches {bad}, "
                        f"launches so far {flood.flood_fixpoint.launches}")
                check(bad == 0, f"flood kernel differs from plain at "
                      f"{size}x{size} B={nb}")
        s, a = cases[0]
        out = torch.empty_like(s)
        flag = ops.errors.error_word(dev)
        per_block = _build.load_library().sejonggo_flood_block(size)
        ms, floor_ms, loop_ms = kernel_times(
            lambda: flood._launch(s, a, out, flag),
            lambda: flood._launch(s[:per_block], a[:per_block],
                                  out[:per_block], flag),
            200)
        nbytes = 3 * s.numel()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"flood {size}x{size} B={b}: device {ms:.5f} ms (graph replay, "
            f"hot L2), loop-mean {loop_ms:.5f} ms, one block of {per_block} "
            f"boards {floor_ms:.5f} ms, bound {bound_ms:.6f} ms "
            f"({nbytes} bytes)")
        if size == 9:
            plain_ms = time_ms(lambda: flood.flood_plain(s, a), 5)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       loop_ms=loop_ms, floor_ms=floor_ms, batch=b)
        else:
            row.update({f"ms_{size}x{size}": ms,
                        f"bound_ms_{size}x{size}": bound_ms,
                        f"batch_{size}x{size}": b})
    return row


def net_parity(net_cfg, variables, dev):
    """The net on the card (float32, TF32 off) vs on the CPU."""
    import numpy as np
    import torch

    from sejonggo_torch.nets import AZNet, from_jax_variables, make_predict_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    x = (rng.rand(256, 9, 9, 17) < 0.3).astype(np.int8)
    x[..., 16] = 1
    sd = from_jax_variables(variables)
    outs = []
    for d in ("cpu", dev):
        net = AZNet.from_config(9, net_cfg)
        net.load_state_dict(sd)
        p, v = make_predict_fn(net.to(d))(torch.from_numpy(x).to(d))
        outs.append((p.cpu(), v.cpu()))
    err = max(float((outs[0][0] - outs[1][0]).abs().max()),
              float((outs[0][1] - outs[1][1]).abs().max()))
    log(f"net float32 card vs CPU on 256 boards: max_abs_err {err:.3g} "
        f"(tolerance 1e-4, summation order)")
    check(err <= 1e-4, "net on the card disagrees with the CPU")


def legal_check(boards, actions, move_valid):
    from sejonggo_torch.goenv import engine

    illegal = engine.illegal_moves_mask_batch(boards)
    bad = illegal.gather(1, actions.long()[:, None])[:, 0] & move_valid
    check(not bool(bad.any()), "a chosen action was illegal")


def phase_bench(seed, dev, b=3072):
    """The move step at the bench point, through the kernels."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.actor import init_state, make_move_step
    from sejonggo_torch.config import NetConfig, SearchConfig
    from sejonggo_torch.nets import (AZNet, from_jax_variables,
                                     make_predict_fn, seeded_flax_variables)

    search = SearchConfig(simulations=64, batch_size=32, use_symmetry=True,
                          max_nodes=82)
    net_cfg = NetConfig(blocks=4, filters=64, value_hidden=64)
    variables = seeded_flax_variables(9, net_cfg, seed)
    net_parity(net_cfg, variables, dev)

    net = AZNet.from_config(9, net_cfg)
    net.load_state_dict(from_jax_variables(variables))
    net = net.to(dev, torch.bfloat16)     # bf16, as bench.py on the chip
    step = make_move_step(make_predict_fn(net), search, 9, selfplay=True)
    state = init_state(b, 9, search, device=dev)
    gen = torch.Generator().manual_seed(seed)
    greedy = torch.zeros(b, dtype=torch.bool, device=dev)
    thr = torch.full((b,), float("nan"), device=dev)

    def moves(n, label):
        nonlocal state
        ops.reset_kernel_launches()
        secs = []
        for _ in range(n):
            before = state.boards
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, rec, _ = step(state, greedy, thr, generator=gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            check(bool(torch.isfinite(rec["values"]).all()), "non-finite values")
            check(bool(torch.isfinite(rec["policy_targets"]).all()),
                  "non-finite policy targets")
            legal_check(before, rec["actions"], rec["move_valid"])
        counts = ops.kernel_launches()
        log(f"{label}: {n} moves in {sum(secs):.3f} s "
            f"({', '.join(f'{s * 1e3:.1f}' for s in secs)} ms), "
            f"launches {counts}")
        check(counts["gostep"] == 2 * n, f"gostep launched {counts['gostep']} "
              f"times in {n} moves, expected {2 * n}")
        check(counts["flood"] == 4 * n, f"flood launched {counts['flood']} "
              f"times in {n} moves, expected {4 * n}")
        return secs, counts

    moves(2, "warm moves")
    secs, counts = moves(4, "timed moves")
    rate = b * search.simulations * len(secs) / sum(secs)
    return rate, counts


def phase_kernel_vs_plain(dev, b=64):
    """The move step through the kernels on the card vs through the plain
    versions on the CPU: greedy, no noise, identity symmetry, dummy net."""
    import torch

    from sejonggo_torch.actor import init_state, make_move_step
    from sejonggo_torch.config import SearchConfig
    from sejonggo_torch.nets import dummy_predict_fn

    search = SearchConfig(simulations=64, batch_size=32, use_symmetry=True,
                          max_nodes=82)
    step = make_move_step(dummy_predict_fn, search, 9, selfplay=False)
    states = {d: init_state(b, 9, search, device=d) for d in (dev, "cpu")}
    for move in range(4):
        recs = {}
        for d in (dev, "cpu"):
            syms = [torch.zeros(b, dtype=torch.long)] * search.rounds
            states[d], recs[d], _ = step(
                states[d], torch.ones(b, dtype=torch.bool, device=d),
                torch.full((b,), float("nan"), device=d), syms=syms)
        same = (torch.equal(recs[dev]["actions"].cpu(), recs["cpu"]["actions"])
                and torch.equal(states[dev].boards.cpu(), states["cpu"].boards)
                and torch.equal(states[dev].trees.child_N.cpu(),
                                states["cpu"].trees.child_N))
        log(f"kernel path vs plain path, move {move}: "
            f"{'equal' if same else 'DIFFERENT'}")
        check(same, f"kernel and plain paths differ at move {move}")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 2
    try:
        from sejonggo_torch import ops
        from sejonggo_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: sejonggo_torch not importable ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "nvidia-smi gave nothing"
    log(f"phase 0 device: {kind}, count {count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    print(card, flush=True)

    t = time.perf_counter()
    _build.load_library()
    log(f"phase 1 build: {_build.build_info['command']}")
    log(f"phase 1 build: {_build.build_info['seconds']:.2f} s nvcc, "
        f"{time.perf_counter() - t:.2f} s with loading")

    t = time.perf_counter()
    gostep_row = phase_gostep(args.seed, dev)
    log(f"phase 2 gostep: ok in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    flood_row = phase_flood(args.seed, dev)
    log(f"phase 3 flood: ok in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    rate, counts = phase_bench(args.seed, dev)
    log(f"phase 4 move step: ok in {time.perf_counter() - t:.2f} s; "
        f"{rate:.1f} env-steps/s at B=3072, 64 sims, bf16 net on {card}")
    t = time.perf_counter()
    phase_kernel_vs_plain(dev)
    ops.check_kernel_errors(dev)
    log(f"phase 5 kernel vs plain path: ok in {time.perf_counter() - t:.2f} s")

    gostep_row["launches"] = counts["gostep"]
    flood_row["launches"] = counts["flood"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: v for k, v in r.items()
                                       if k not in keys}}
        for r in (gostep_row, flood_row)]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
