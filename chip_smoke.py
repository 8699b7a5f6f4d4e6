#!/usr/bin/env python3
"""Smoke run of sejonggo_torch on one CUDA card.

Drives the port's 9x9 self-play move step (the path bench.py measures for
the JAX package: B=3072 games, 64 simulations in rounds of 32 leaves, 82
tree slots, a 4-block x 64-filter bf16 net with random weights made from
--seed), then the strength_9x9_xl point from the committed model_291
checkpoint (6x96, bf16): continuous self-play, the gate, and one whole
generation of the closed loop (self-play, train, checkpoint, gate); then
the I/O entry points: GTP play at full_19x19 width and from model_291,
and KGS pretraining of the full_19x19 net on the committed SGF corpus;
then the model-free michi engine: its duel against model_291 and its
GTP play.  Holds each hand-written CUDA kernel against its
plain PyTorch version on the card.

    python3 chip_smoke.py [--seed 0]

Phases: 0 device, 1 build (nvcc + ctypes), 2 gostep kernel vs plain,
3 flood kernel vs plain (each bit-exact at the main path's batch, at
the xl self-play and gate batches, at 19x19 and at ragged batches, then
timed on the device by CUDA-graph replay at the main path's batch, at
the xl batches, at one block of boards and at 19x19), 4 the move step
at the bench point (net parity, launch counts, legality, env-steps/s),
5 the move step through the kernels vs through the plain versions, 6
model_291 read by the port's msgpack reader (finite predictions, net ms
per 12,288 boards), 7 the gate: 128 two-tree games of model_291 against
seeded random weights (promote must hold, launch counts, the games
replayed through the plain engine: moves, winners, value targets), whose
games warm the resign calibrator, 8 continuous self-play at xl (384
slots, 192 simulations, live resign thresholds) until 8 games finish,
one of them played out (legal moves, games replayed through the plain engine, winners, resign
winners, launch counts), 9 one xl step twice (bit-equal trees), 10 one
whole generation of ``sejonggo_torch.pipeline.Pipeline`` at xl from
model_291 with nothing cut (512 self-play games at 384 slots, 256 train
steps at batch 256, the 128-game gate of model_292 against model_291):
model_292 read back bit-equal to the trained state, the replay's moves,
each phase's launch counts, and one bf16 train step on the card held to
the CPU's, 11 GTP at full ``full_19x19`` width (20 x 256, 1600
simulations in rounds of 100 leaves, weights from --seed) through
``GTPFrontend``: genmove and play for 9 moves, sg_showtree, showboard,
final_score (launch counts, the kept tree reused, one genmove bit-equal
between the kernels and the plain versions on the card, the session
replayed through the plain engine), the kernels timed at the new shapes
(gostep at 100 leaves of 19x19, flood at one board), then a strength
game from model_291 through ``python -m sejonggo_torch.io.gtp``, 12 KGS
pretraining of the 20 x 256 net on the committed 19x19 corpus in a
temporary workdir (32 steps at batch 32; model_2 read back bit-equal,
the backup and the metric event, 4 floods a replayed move, one game
replayed on the card and on the CPU, the train step timed alone), 13
the model-free engines: one michi playout of 256 mid-game boards and one
michi@64 search of 16 games, each through the kernels and through the
plain versions on the card with the same draws (bit-equal), gostep timed
at 256 and 16 boards, the 32-game duel of model_291 at strength_9x9_xl
against michi@64 (launch counts, the games replayed through the plain
engine, net wins inside a plausibility band), then three michi genmoves
at 1400 simulations with the committed patterns through
``python -m sejonggo_torch.io.gtp --engine michi``, 14 multi-rank play
and training over a ``torch.distributed`` world started as processes
(``sejonggo_torch.parallel.launch``): one rank per card over NCCL where
there are two or more cards (four from four), else two ranks on cuda:0
over gloo; 14a three xl train steps from model_291 on the ranks' halves
of 256 replay rows against one process on all of them (float32 and bf16;
every rank's state bit-equal), 14b each rank's share of an 8-game
``play_games`` over the mesh bit-equal through the kernels and the plain
versions, then one strength_9x9_xl generation from model_291 shared by
the ranks (512 games, 256 steps of the split batch of 256, the 128-game
gate: model_292 written once and read back bit-equal by every rank, the
same promotion decision, each rank's launches exact and its games
replayed through the plain engine), 14c ``dryrun_multichip(2)`` on the
card, 15 bench.py's 19x19 point through the port (B=16, 1600
simulations in rounds of 100 leaves, 2218 slots, the 20 x 256 bf16 net
from --seed): ms a move, launches and the net's share.
The kernels' error word is read after every kernel phase.
Every phase prints one line with its elapsed seconds; the line before
the last is the kernel table as JSON, the last line is
{"ok": true, "device": {...}}.  Any failure ends
the run with a nonzero exit code and no result line.  A watchdog ends a
hang with a traceback and a nonzero exit.  Without CUDA, or without the
sejonggo_torch package beside it, the script exits nonzero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import json
import subprocess
import sys
import time

WATCHDOG_S = 1000          # the run must end within 1200 s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
MODELS = "runs/strength_r5b/sp_models"   # model_291, 6x96, 9x9 (in git)
XL_GAMES, GATE_GAMES = 384, 128          # strength_9x9_xl game_batch, gate
# a strength_9x9_xl generation: self-play games, train steps and batch
GEN_GAMES, GEN_STEPS, GEN_BATCH = 512, 256, 256
MODEL_291_STEP = 74240
XL_LEAVES = (XL_GAMES * 32, GATE_GAMES * 32)   # leaves per round, k = 32
XL_BOARDS = (XL_GAMES, GATE_GAMES)
GTP_MOVES = 9                 # phase 11: 5 genmoves and 4 replies, 19x19
STRENGTH_GENMOVES = 40        # phase 11: the model_291 game over GTP
CORPUS = "runs/full19_r5/corpus"          # 48 rollout SGFs, 19x19 (in git)
KGS_STEPS, KGS_BACKUP, KGS_TIMED_STEPS = 32, 16, 8    # phase 12
# phase 13: model_291 at strength_9x9_xl against michi@64 (the run of
# runs/strength_r5b/michi64_confirm.log), michi over GTP at 1400 sims
DUEL_GAMES, DUEL_SIMS = 32, 64
DUEL_NET_WINS = (6, 26)       # a plausibility band, not a strength claim
MICHI_GAMES, MICHI_BOARDS = 16, 256      # 16 games x k = 16 playouts
MICHI_GTP_GENMOVES = 3
PATTERNS = "runs/patterns_r5/patterns"   # .spat and .prob (in git)
# phase 14: the multi-rank world (its ranks' time limit, the xl train
# steps of 14a, the sharded play_games of 14b held to the plain versions)
MULTI_TIMEOUT_S = 420
MULTI_TRAIN_STEPS = 3
MULTI_PLAY_GAMES, MULTI_PLAY_MOVES = 8, 6
# phase 15: bench.py's 19x19 point (bench.py:242-273), timed moves
B19_GAMES, B19_MOVES = 16, 3

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
    bench's leaf batch (98,304 of 1025 games x 96 moves, 9x9), at the xl
    self-play and gate leaf batches (12,288 and 4,096), at 19x19 and at
    ragged batch sizes; device times at both sizes."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.ops import _build, gostep

    row = dict(name="gostep", route="cuda",
               source="sejonggo_torch/csrc/gostep.cu",
               replaces="sejonggo_tpu/ops/gostep.py:172", library_ms=None,
               bound_by="bytes", max_abs_err=0.0)
    for size, games, moves, b in shapes:
        stones, sides, actions = positions(size, games, moves, seed, dev)
        xl = XL_LEAVES if size == 9 else ()
        for nb in (b, *xl, 1, 31, 33, 3071, b + 1):
            got_s, got_i = gostep.step_legal(stones[:nb], sides[:nb],
                                             actions[:nb])
            exp_s, exp_i = gostep.step_legal_plain(stones[:nb], sides[:nb],
                                                   actions[:nb])
            ops.check_kernel_errors(dev)
            bad = int((got_s != exp_s).sum()) + int((got_i != exp_i).sum())
            err = max(float((got_s.int() - exp_s.int()).abs().max()),
                      float((got_i.int() - exp_i.int()).abs().max()))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if nb == b or nb in xl:
                log(f"gostep {size}x{size} B={nb}: mismatches {bad}, "
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
            # the leaf batches of the xl self-play and gate rounds
            for nb in XL_LEAVES:
                nms = graph_ms(lambda: gostep._launch(
                    stones[:nb], sides[:nb], actions[:nb], out_s[:nb],
                    out_i[:nb], flag), 50)
                ops.check_kernel_errors(dev)
                row[f"ms_b{nb}"] = nms
                row[f"bound_ms_b{nb}"] = nbytes * nb / b / HBM_BYTES_PER_S * 1e3
                log(f"gostep 9x9 B={nb}: device {nms:.5f} ms, bound "
                    f"{row[f'bound_ms_b{nb}']:.5f} ms")
        else:
            row.update({f"ms_{size}x{size}": ms,
                        f"bound_ms_{size}x{size}": bound_ms,
                        f"batch_{size}x{size}": b})
    return row


def phase_flood(seed, dev, shapes=((9, 64, 48), (19, 16, 32))):
    """flood kernel vs flood_plain on the card: bit-exact at the move
    step's batch (3072 = 64 games x 48 moves, 9x9), at the xl self-play
    and gate batches (384 and 128 boards), at 19x19 and at ragged batch
    sizes up to 98,305 (random regions); device times at both sizes."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.ops import _build, flood

    row = dict(name="flood", route="cuda",
               source="sejonggo_torch/csrc/flood.cu",
               replaces="sejonggo_tpu/ops/flood.py:71", library_ms=None,
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
        xl = XL_BOARDS if size == 9 else ()
        for s, a in cases:
            for nb in (s.shape[0], *xl, 1, 31, 33, 3071):
                got = flood.flood_fixpoint(s[:nb], a[:nb])
                exp = flood.flood_plain(s[:nb], a[:nb])
                ops.check_kernel_errors(dev)
                bad = int((got != exp).sum())
                row["max_abs_err"] = max(
                    row["max_abs_err"], float((got.int() - exp.int()).abs().max()))
                if nb == s.shape[0] or nb in xl:
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
            # the board batches of the xl self-play and gate steps
            for nb in XL_BOARDS:
                nms = graph_ms(lambda: flood._launch(
                    s[:nb], a[:nb], out[:nb], flag), 200)
                ops.check_kernel_errors(dev)
                row[f"ms_b{nb}"] = nms
                row[f"bound_ms_b{nb}"] = 3 * s[:nb].numel() / HBM_BYTES_PER_S * 1e3
                log(f"flood 9x9 B={nb}: device {nms:.5f} ms, bound "
                    f"{row[f'bound_ms_b{nb}']:.6f} ms")
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
    # bf16 compute with float32 parameters, as bench.py's net on the chip
    net_cfg = NetConfig(blocks=4, filters=64, value_hidden=64,
                        compute_dtype="bfloat16")
    variables = seeded_flax_variables(9, net_cfg, seed)
    net_parity(dataclasses.replace(net_cfg, compute_dtype="float32"),
               variables, dev)

    net = AZNet.from_config(9, net_cfg)
    net.load_state_dict(from_jax_variables(variables))
    step = make_move_step(make_predict_fn(net.to(dev)), search, 9,
                          selfplay=True)
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


def xl_net(variables, dev):
    """The strength_9x9_xl net (6x96, bf16 compute, float32 parameters)
    on ``dev`` with ``variables`` (numpy trees at the flax shapes)."""
    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.nets import AZNet, from_jax_variables

    net = AZNet.from_config(9, strength_9x9_xl().net)
    net.load_state_dict(from_jax_variables(variables))
    return net.to(dev)


def xl_calibrator(seed):
    """The resign calibrator of strength_9x9_xl self-play (cap -0.90)."""
    from sejonggo_torch.actor import ResignCalibrator
    from sejonggo_torch.config import strength_9x9_xl

    sp = strength_9x9_xl().selfplay
    return ResignCalibrator(holdout_percent=sp.resignation_percent,
                            allowed_error=sp.resignation_allowed_error,
                            seed=seed, cap=sp.resignation_cap)


def seeded_boards(b, seed, dev):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = (rng.rand(b, 9, 9, 17) < 0.2).astype(np.int8)
    x[..., 16] = rng.choice([-1, 1], size=(b, 1, 1))
    return torch.from_numpy(x).to(dev)


def phase_checkpoint(dev):
    """model_291 read with the port's own msgpack reader, the xl net in
    bf16 on the card: finite predictions, ms per 12,288-board call."""
    import torch

    from sejonggo_torch.learn import CheckpointStore
    from sejonggo_torch.nets import make_predict_fn

    store = CheckpointStore(MODELS)
    best = store.best_name()
    check(best == "model_291", f"index.json names {best!r}, not model_291")
    t = time.perf_counter()
    variables = store.load_variables(best)
    read_s = time.perf_counter() - t
    predict = make_predict_fn(xl_net(variables, dev))
    boards = seeded_boards(XL_LEAVES[0], 5, dev).float()
    p, v = predict(boards)
    check(bool(torch.isfinite(p).all()) and bool(torch.isfinite(v).all()),
          "model_291 predicts non-finite values")
    check(p.shape == (XL_LEAVES[0], 82) and v.shape == (XL_LEAVES[0], 1),
          f"model_291 predicts shapes {tuple(p.shape)}, {tuple(v.shape)}")
    ms = {n: time_ms(lambda: predict(boards[:n]), 10) for n in XL_LEAVES}
    log(f"checkpoint {best}: read in {read_s:.3f} s by the port's msgpack "
        f"reader; xl net bf16 "
        f"{', '.join(f'{t:.3f} ms per {n}-board call' for n, t in ms.items())}; "
        f"values in [{float(v.min()):.3f}, {float(v.max()):.3f}]")
    return variables


def replay(stones, actions, move_valid, komi, masked_grids=False):
    """Replay (T, B) recorded actions through the plain engine on the CPU
    from empty boards: every valid action legal, every recorded signed
    grid (T, B, N, N) reproduced (with ``masked_grids`` only at valid
    moves: padding rows hold no grid), masked moves leave the board as it
    is; returns the final boards' area-score winners and black points."""
    import torch

    from sejonggo_torch.goenv import engine

    stones, actions = torch.as_tensor(stones), torch.as_tensor(actions).long()
    move_valid = torch.as_tensor(move_valid)
    board = engine.init_board(9, batch=actions.shape[1], device="cpu")
    for t in range(actions.shape[0]):
        same = engine.signed_stones(board) == stones[t]
        if masked_grids:
            same |= ~move_valid[t][:, None, None]
        check(bool(same.all()),
              f"replayed boards differ from the record at move {t}")
        a, mv = actions[t], move_valid[t]
        illegal = engine.illegal_moves_mask_batch(board).gather(1, a[:, None])
        check(not bool((illegal[:, 0] & mv).any()),
              f"a recorded action at move {t} is illegal")
        board = torch.where(mv[:, None, None, None],
                            engine.step_batch(board, a), board)
    w, bp, _ = engine.score_batch(board, komi)
    return w.numpy(), bp.numpy()


def phase_gate(variables, dev, seed, calib, games=GATE_GAMES):
    """evaluate_models at the xl search: latest = model_291, best =
    seeded random weights at the same width, all games in one batch.
    A trained net that does not beat random weights was read wrong.  The
    batch is replayed through the plain engine (moves, grids, winners,
    value targets).  Its games run without resignation, as the
    calibrator's holdout games do, so ``calib`` observes them: the
    self-play phase then starts with live thresholds."""
    import numpy as np
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.config import EvalConfig, strength_9x9_xl
    from sejonggo_torch.goenv import engine
    from sejonggo_torch.learn import evaluate_models
    from sejonggo_torch.nets import make_predict_fn, seeded_flax_variables

    cfg = strength_9x9_xl()
    check(cfg.eval.num_games == games, "xl EvalConfig.num_games moved")
    latest = make_predict_fn(xl_net(variables, dev))
    best = make_predict_fn(xl_net(seeded_flax_variables(9, cfg.net, seed), dev))
    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = evaluate_models(latest, best, size=9, komi=cfg.go.komi,
                          search=cfg.search, eval_cfg=EvalConfig(num_games=games),
                          generator=torch.Generator().manual_seed(seed),
                          collect_games=True, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = ops.kernel_launches()
    (batch,) = out.pop("game_batches")
    moves = batch.actions.shape[0]
    rounds = cfg.search.simulations // cfg.search.batch_size
    check(counts["gostep"] == rounds * moves, f"gate: gostep launched "
          f"{counts['gostep']} times in {moves} moves, expected {rounds * moves}")
    check(counts["flood"] == 4 * moves + 2, f"gate: flood launched "
          f"{counts['flood']} times in {moves} moves, expected {4 * moves + 2}")
    winners, black = replay(
        engine.signed_stones(torch.from_numpy(batch.boards)), batch.actions,
        batch.move_valid, cfg.go.komi)
    check(np.array_equal(winners, batch.winners)
          and np.array_equal(black, batch.black_points),
          "gate winners differ from the replayed scores")
    expected = np.where(winners == 0, 0, np.where(batch.players == winners,
                                                  1, -1))
    check(np.array_equal(batch.value_targets(), expected),
          "gate value targets differ from the replayed winners")
    ms_move = 1e3 * secs / moves
    log(f"gate: model_291 vs seeded random weights, {out['games']} games in "
        f"one batch: win rate {out['winrate']:.4f} ({out['wins']} wins, "
        f"{out['draws']} draws), mean game {out['mean_moves']:.1f} moves, "
        f"{moves} lockstep moves in {secs:.2f} s = {ms_move:.1f} ms per move, "
        f"promote {out['promote']}, launches {counts}; moves, grids, "
        f"winners and value targets replayed")
    check(out["promote"], f"model_291 won only {out['winrate']:.3f} against "
          "random weights: the checkpoint was read wrong")
    calib.thresholds(games)          # cold: every game is a holdout game
    calib.observe(batch)
    check(calib.current is not None, "the gate's games did not calibrate "
          "the resign threshold")
    log(f"resign calibrator: threshold {calib.current:.4f} from "
        f"{len(calib.min_values)} gate games won without resigning")
    return counts, dict(moves=moves, secs=secs, ms_per_move=ms_move,
                        winrate=out["winrate"])


def phase_selfplay(variables, dev, seed, calib, min_games=8, max_steps=170):
    """ContinuousSelfPlay at strength_9x9_xl (384 slots, 192 simulations in
    rounds of 32, 256 slots a tree, bf16) from model_291 with resign
    thresholds from ``calib`` (capped at -0.90), until min_games games
    have finished and one of them was played out rather than resigned
    (every game ends by the 162-move cap at the latest, so max_steps is
    a bound, not a cut).  Each step's moves are checked
    legal on the card; the harvested games are replayed through the plain
    engine (grids, area winners); a resigned game's winner is the side
    that moved last."""
    import numpy as np
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.actor import ContinuousSelfPlay
    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.goenv import engine
    from sejonggo_torch.nets import make_predict_fn

    cfg = strength_9x9_xl()
    check(cfg.selfplay.game_batch == XL_GAMES, "xl game_batch moved")
    actor = ContinuousSelfPlay(
        make_predict_fn(xl_net(variables, dev)), size=9, komi=cfg.go.komi,
        search=cfg.search, game_batch=XL_GAMES,
        stop_exploration=cfg.selfplay.stop_exploration,
        generator=torch.Generator().manual_seed(seed),
        threshold_fn=calib.threshold_for_new_game, device=dev)
    live = int((~np.isnan(actor._thresholds)).sum())
    step = actor._step
    step_s = []

    def checked_step(state, thr, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        new_state, rec = step(state, thr, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        legal_check(state.boards, rec["actions"], rec["move_valid"])
        return new_state, rec

    actor._step = checked_step
    ops.reset_kernel_launches()
    t = time.perf_counter()
    games = actor.run(min_games, on_game=calib.observe_game,
                      max_steps=max_steps)
    # resigned games end first: play on until a game is played out too
    while all(g["resigned"] for g in games) and actor.steps < max_steps:
        games += actor.run(1, on_game=calib.observe_game,
                           max_steps=max_steps - actor.steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = ops.kernel_launches()
    steps = actor.steps
    resigned = sum(g["resigned"] for g in games)
    check(len(games) >= min_games, f"{len(games)} games finished in "
          f"{steps} steps, expected {min_games}")
    check(0 < resigned < len(games), f"{resigned} of {len(games)} games "
          "resigned: expected resigned and played-out games")
    rounds = cfg.search.simulations // cfg.search.batch_size
    check(counts["gostep"] == rounds * steps, f"gostep launched "
          f"{counts['gostep']} times in {steps} steps, expected {rounds * steps}")
    check(counts["flood"] == 6 * steps, f"flood launched {counts['flood']} "
          f"times in {steps} steps, expected {6 * steps} (4 in the env step, "
          "2 in the score)")
    for g in games:
        n = len(g["actions"])
        winner, black = replay(
            engine.signed_stones(torch.from_numpy(g["boards"]))[:, None],
            g["actions"][:, None], np.ones((n, 1), bool), cfg.go.komi)
        check(winner[0] == g["winner"] and black[0] == g["black_points"],
              f"game winner {g['winner']} differs from the replayed score "
              f"{winner[0]}")
        check(g["resign_winner"] == (g["players"][-1] if g["resigned"]
                                     else g["winner"]),
              f"resign winner {g['resign_winner']} of a game "
              f"{'resigned' if g['resigned'] else 'played out'}")
        check(bool(np.isfinite(g["values"]).all()), "non-finite game values")
    lengths = [len(g["actions"]) for g in games]
    played = [n for n, g in zip(lengths, games) if not g["resigned"]]
    ms_step = 1e3 * float(np.mean(step_s))
    log(f"self-play: {len(games)} games finished in {steps} steps "
        f"({secs:.2f} s), {ms_step:.1f} ms per step at B={XL_GAMES} "
        f"(median {1e3 * float(np.median(step_s)):.1f}), "
        f"{actor.moves_recorded / secs:.1f} moves/s, game lengths "
        f"{min(lengths)}-{max(lengths)} (median {np.median(lengths):.1f}), "
        f"black won {sum(g['winner'] == 1 for g in games)}, resigned "
        f"{resigned}, played out {len(played)} of lengths {played} "
        f"(resignation live in {live} of the first {XL_GAMES} games, "
        f"{actor.empty_games} empty games dropped), tree_fresh_rate "
        f"{actor.tree_fresh_rate:.3f}, launches {counts}")
    return actor, counts, dict(steps=steps, games=len(games), secs=secs,
                               ms_per_step=ms_step, resigned=resigned,
                               moves_per_s=actor.moves_recorded / secs)


def phase_determinism(actor, seed):
    """One xl self-play step twice from the same state with the same draws,
    through the kernels: trees and moves bit-equal (the backup's sums
    have a fixed order)."""
    import torch

    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.search import sample_dirichlet

    search = strength_9x9_xl().search
    g = torch.Generator().manual_seed(seed)
    b = actor.b
    u = torch.rand((b, 82), generator=g).clamp(1e-20, 1 - 1e-7)
    draws = dict(noise=sample_dirichlet(search.dirichlet_alpha, b, 82, g),
                 syms=torch.randint(0, 7, (search.rounds,), generator=g).tolist(),
                 gumbel=-torch.log(-torch.log(u)))
    thr = torch.full((b,), float("nan"), device=actor.state.boards.device)
    runs = [actor._step(actor.state, thr, **draws) for _ in range(2)]
    (s1, r1), (s2, r2) = runs
    same = {name: torch.equal(getattr(s1.trees, name), getattr(s2.trees, name))
            for name in ("child_W", "child_N", "root_W", "root_N")}
    same["actions"] = torch.equal(r1["actions"], r2["actions"])
    log(f"determinism: one xl step twice, bit-equal {same}")
    check(all(same.values()), f"one xl step repeated differs: {same}")


def forward_flops(net_cfg, size=9):
    """FLOPs (2 per multiply-add) of one forward of the net on one board,
    counted from its shapes: the convolutions at every point, the dense
    layers."""
    n, f = size * size, net_cfg.filters
    conv = (9 * 17 * f + 2 * net_cfg.blocks * 9 * f * f
            + f * (net_cfg.policy_filters + net_cfg.value_filters)) * n
    dense = (net_cfg.policy_filters * n * (n + 1)
             + net_cfg.value_filters * n * net_cfg.value_hidden
             + net_cfg.value_hidden)
    return 2 * (conv + dense)


def same_tree(a, b) -> bool:
    """Two checkpoint trees equal key for key, in order, arrays bit for
    bit with their dtypes and shapes."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_tree(a[k], b[k]) for k in a))
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def train_parity(replay, dev, seed):
    """One xl train step from model_291 on one fixed batch of 256 rows of
    the generation's replay: bf16 on the card against bf16 on the CPU,
    held to twice the CPU's own bf16-vs-float32 gap (loss and grad norm,
    the gap floored at one bf16 step, 2^-8 of the value; the updated
    parameters in L2)."""
    import numpy as np
    import torch

    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.learn import (CheckpointStore, make_optimizer,
                                      make_train_step)
    from sejonggo_torch.nets import AZNet

    cfg = strength_9x9_xl()
    idx = np.random.RandomState(seed).randint(0, len(replay),
                                              cfg.train.batch_size)
    batch = (replay.boards[idx].astype(np.float32), replay.policies[idx],
             replay.values[idx])
    out = {}
    for name, d, dtype in (("card", dev, "bfloat16"), ("cpu", "cpu", "bfloat16"),
                           ("cpu32", "cpu", "float32")):
        net = AZNet.from_config(9, dataclasses.replace(
            cfg.net, compute_dtype=dtype)).to(d)
        state = CheckpointStore(MODELS).load_state("model_291", net)
        step = make_train_step(make_optimizer(
            cfg.train.lr, cfg.train.momentum, cfg.net.l2), cfg.train.loss_mode)
        t = time.perf_counter()
        state, m = step(state, *(torch.from_numpy(x).to(d) for x in batch))
        params = torch.cat([p.detach().reshape(-1).double().cpu()
                            for p in net.parameters()])
        out[name] = (float(m["loss"]), float(m["grad_norm"]), params,
                     time.perf_counter() - t)
        check(float(m["nonfinite"]) == 0.0, f"{name} train step non-finite")
    card, cpu, cpu32 = out["card"], out["cpu"], out["cpu32"]
    errs = {}
    for i, k in enumerate(("loss", "grad_norm")):
        gap = max(abs(cpu[i] - cpu32[i]), 2.0 ** -8 * abs(cpu32[i]))
        errs[k] = (abs(card[i] - cpu[i]), 2 * gap)
    gap = float((cpu[2] - cpu32[2]).norm())
    errs["params_l2"] = (float((card[2] - cpu[2]).norm()), 2 * gap)
    log(f"train step card vs CPU (bf16, model_291, {len(idx)} rows of the "
        "new replay): " + ", ".join(f"{k} err {e:.4g} (tolerance {tol:.4g})"
                                for k, (e, tol) in errs.items())
        + f"; loss {card[0]:.6f} card, {cpu[0]:.6f} CPU, {cpu32[0]:.6f} "
        f"CPU float32; CPU steps {cpu[3]:.2f} s bf16, {cpu32[3]:.2f} s float32")
    for k, (e, tol) in errs.items():
        check(e <= tol, f"train step on the card differs from the CPU in {k}: "
              f"{e:.4g} > {tol:.4g}")
    return batch


@contextlib.contextmanager
def counted_phases(step_cap):
    """``sejonggo_torch.pipeline``'s self-play actor and gate replaced by
    counting wrappers while the block runs; yields a dict that gets
    "selfplay" (steps, slots, the harvested games, seconds, launches; at
    most ``step_cap`` steps) and "gate" (each batch's moves, its game
    batches, seconds, launches)."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch import pipeline as pl

    phases = {}

    def counted(key, fn, record):
        before = ops.kernel_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        after = ops.kernel_launches()
        phases[key] = dict(record(out), secs=time.perf_counter() - t,
                           launches={k: after[k] - before[k] for k in after})
        return out

    class CountedSelfPlay(pl.ContinuousSelfPlay):
        def run(self, num_games, **kw):
            run = super().run
            return counted(
                "selfplay", lambda: run(num_games, max_steps=step_cap, **kw),
                lambda games: dict(steps=self.steps, slots=self.b,
                                   games=games))

    def counted_eval(*args, **kw):
        return counted(
            "gate", lambda: real_eval(*args, **kw), lambda out: dict(
                moves=[gb.actions.shape[0] for gb in out["game_batches"]],
                batches=out["game_batches"]))

    real_actor, real_eval = pl.ContinuousSelfPlay, pl.evaluate_models
    pl.ContinuousSelfPlay, pl.evaluate_models = CountedSelfPlay, counted_eval
    try:
        yield phases
    finally:
        pl.ContinuousSelfPlay, pl.evaluate_models = real_actor, real_eval


def check_generation_launches(phases, counts, rounds):
    """Each phase of a generation launched the kernels its steps and moves
    need (self-play: a gostep a round and 6 floods a step; the gate: a
    gostep a round and 4 floods a move, 2 a batch's score; training
    none); returns (self-play steps, gate moves)."""
    sp, gate = phases["selfplay"], phases["gate"]
    steps, lock = sp["steps"], sum(gate["moves"])
    check(sp["launches"] == {"gostep": rounds * steps, "flood": 6 * steps},
          f"self-play launches {sp['launches']} in {steps} steps")
    check(gate["launches"] == {
        "gostep": rounds * lock, "flood": 4 * lock + 2 * len(gate["moves"])},
        f"gate launches {gate['launches']} in {gate['moves']} moves")
    check(counts == {k: sp["launches"][k] + gate["launches"][k]
                     for k in counts}, f"generation launches {counts}: the "
          "train phase launched a Go kernel")
    return steps, lock


def phase_generation(dev, seed, card):
    """One whole generation of Pipeline.run at strength_9x9_xl from
    model_291, nothing cut: 512 self-play games at 384 slots, 256 train
    steps at batch 256, 128 gate games of model_292 against model_291.
    Then model_292 is read back bit-equal to the trained state, the
    replay holds the self-play and gate moves, each phase's kernel
    launches match its steps and moves, and one train step on the card
    is held to the CPU."""
    import os
    import shutil
    import tempfile

    import torch

    from sejonggo_torch import ops
    from sejonggo_torch import pipeline as pl
    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.learn import restore
    from sejonggo_torch.learn.checkpoint import state_tree

    cfg = strength_9x9_xl()
    check((cfg.selfplay.num_games, cfg.selfplay.game_batch,
           cfg.train.epochs_per_save * cfg.train.iters_per_epoch,
           cfg.train.batch_size, cfg.eval.num_games)
          == (GEN_GAMES, XL_GAMES, GEN_STEPS, GEN_BATCH, GATE_GAMES),
          "the strength_9x9_xl generation moved")
    rounds = cfg.search.simulations // cfg.search.batch_size
    step_cap = 2 * (cfg.go.max_moves + 1)   # every game ends by the cap
    workdir = tempfile.mkdtemp(prefix="sejonggo_generation_")
    try:
        models = os.path.join(workdir, cfg.model_dir)
        os.makedirs(models)
        for f in ("model_291.msgpack", "index.json"):
            shutil.copy(os.path.join(MODELS, f), models)
        pipe = pl.Pipeline(cfg, workdir, seed, device=dev)
        saved = {}
        real_save = pipe.store.save_state

        def save_state(name, state):
            saved[name] = state_tree(state)
            real_save(name, state)

        pipe.store.save_state = save_state
        with counted_phases(step_cap) as phases:
            ops.reset_kernel_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            (res,) = pipe.run(generations=1)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            counts = ops.kernel_launches()
        ops.check_kernel_errors(dev)
        sp, tr, ev = res["selfplay"], res["train"], res["evaluate"]
        check(pipe.store.latest_name() == "model_292",
              f"latest is {pipe.store.latest_name()!r}, not model_292")
        want_best = "model_292" if ev["promote"] else "model_291"
        check(pipe.store.best_name() == res["best"] == want_best,
              f"best is {pipe.store.best_name()!r} with promote "
              f"{ev['promote']}")
        check(tr["nonfinite_windows"] == 0,
              f"{tr['nonfinite_windows']} non-finite train windows")
        written = restore(os.path.join(models, "model_292.msgpack"))
        check(same_tree(written, saved["model_292"]),
              "model_292.msgpack differs from the trained state")
        check(int(written["step"]) == MODEL_291_STEP + GEN_STEPS,
              f"model_292 step {int(written['step'])}, expected model_291's "
              f"{MODEL_291_STEP} + {GEN_STEPS} (no step skipped)")
        moves = sp["moves"] + ev["eval_moves_to_replay"]
        check(pipe.replay.total_moves == moves and len(pipe.replay)
              == min(moves, pipe.replay.capacity),
              f"replay holds {len(pipe.replay)} rows of "
              f"{pipe.replay.total_moves} moves, expected {moves}")
        sp_p, gate_p = phases["selfplay"], phases["gate"]
        check(sp["games"] >= cfg.selfplay.num_games,
              f"{sp['games']} self-play games in {sp_p['steps']} steps")
        steps, lock = check_generation_launches(phases, counts, rounds)
        batch = train_parity(pipe.replay, dev, seed)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    flops = 3 * forward_flops(cfg.net) * cfg.train.batch_size
    train_ms = 1e3 * tr["seconds"] / tr["steps"]
    tflops = flops / (train_ms * 1e-3) / 1e12
    gate_ms = 1e3 * gate_p["secs"] / lock
    log(f"generation on {card}: {secs:.2f} s in all")
    log(f"generation self-play: {sp['games']} games, {sp['moves']} moves in "
        f"{steps} steps, {sp['seconds']:.2f} s, {sp['moves_per_s']:.1f} "
        f"moves/s, {sp['env_steps_per_s']:.1f} env-steps/s, "
        f"{1e3 * sp_p['secs'] / steps:.1f} ms per step at B={XL_GAMES}; "
        f"resign threshold {sp['resign_threshold']}, resigned "
        f"{sp['resigned_games']}, holdout {sp['holdout_games']} "
        f"(winner dip rate {sp['winner_dip_rate']:.3f}); launches "
        f"{sp_p['launches']}")
    log(f"generation train: {tr['steps']} steps at batch "
        f"{cfg.train.batch_size} in {tr['seconds']:.2f} s, {train_ms:.2f} ms "
        f"per step (sampling, copy and the checkpoint write included), "
        f"{tr['samples_per_s']:.1f} samples/s, {flops / 1e9:.1f} GFLOP a step "
        f"from the shapes = {tflops:.2f} TFLOP/s, "
        f"{100 * tflops / 989:.2f}% of the 989 TFLOP/s bf16 peak; loss "
        f"{tr['loss']:.4f}, policy_ce {tr['policy_ce']:.4f}, value_mse "
        f"{tr['value_mse']:.4f}, grad_norm {tr['grad_norm']:.4f}")
    log(f"generation gate: model_292 vs model_291, {ev['games']} games, "
        f"{lock} lockstep moves in {gate_p['secs']:.2f} s = {gate_ms:.1f} ms "
        f"per move, win rate {ev['winrate']:.4f} ({ev['wins']} wins, "
        f"{ev['draws']} draws), promote {ev['promote']}, best "
        f"{res['best']}; launches {gate_p['launches']}; replay "
        f"{moves} moves")
    return counts, dict(secs=secs, selfplay_steps=steps, gate_moves=lock,
                        train_ms=train_ms, gate_ms=gate_ms, batch=batch)


@contextlib.contextmanager
def plain_kernels():
    """The engine's and the heuristics' floods and every gostep call
    through the plain PyTorch versions, on whatever device the tensors
    lie (the card here), while the block runs."""
    from sejonggo_torch.goenv import engine
    from sejonggo_torch.ops import flood, gostep
    from sejonggo_torch.search import heuristics

    saved = engine.flood_fixpoint, heuristics.flood_fixpoint, gostep.step_legal
    engine.flood_fixpoint = heuristics.flood_fixpoint = flood.flood_plain
    gostep.step_legal = gostep.step_legal_plain
    try:
        yield
    finally:
        engine.flood_fixpoint, heuristics.flood_fixpoint, gostep.step_legal = \
            saved


def gtp_ok(resp: str) -> str:
    """The text of a successful GTP response ('= ...' and a blank line)."""
    check(resp.startswith("=") and resp.endswith("\n\n"),
          f"malformed GTP response {resp!r}")
    return resp[1:].strip()


def full_net(seed, dev):
    """The full_19x19 net (20 x 256, bf16 compute) with weights drawn on
    the host from --seed; returns (predict, host draw seconds)."""
    import torch

    from sejonggo_torch.config import full_19x19
    from sejonggo_torch.nets import (AZNet, from_jax_variables,
                                     init_variables, make_predict_fn)

    cfg = full_19x19()
    t = time.perf_counter()
    variables = init_variables(19, cfg.net, torch.Generator().manual_seed(seed))
    draw_s = time.perf_counter() - t
    net = AZNet.from_config(19, cfg.net)
    net.load_state_dict(from_jax_variables(variables))
    return make_predict_fn(net.to(dev)), draw_s


def kernel_vs_plain_genmove(predict, board, dev, seed):
    """One full_19x19 genmove from ``board`` twice with the same draws:
    through the kernels and through the plain versions, both on the card.
    The vertex, the visit counts and the value sums must be bit-equal."""
    import torch

    from sejonggo_torch.config import full_19x19
    from sejonggo_torch.io.gtp import GoEngine

    cfg = full_19x19()
    g = torch.Generator().manual_seed(seed)
    syms = [int(s) for s in torch.randint(0, 7, (cfg.search.rounds,),
                                          generator=g)]
    out, ms = {}, {}
    for name in ("kernels", "plain"):
        eng = GoEngine(predict, size=19, komi=7.5, search=cfg.search,
                       device=dev, draws=lambda noise: {"syms": syms})
        eng.board = board.clone()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if name == "plain":
            with plain_kernels():
                x, y, _ = eng.genmove(eng.player)
        else:
            x, y, _ = eng.genmove(eng.player)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t)
        out[name] = (x, y, eng.tree.child_N.clone(), eng.tree.child_W.clone(),
                     eng.board.clone())
    (kx, ky, kn, kw, kb), (px, py, pn, pw, pb) = out["kernels"], out["plain"]
    same = ((kx, ky) == (px, py) and torch.equal(kn, pn)
            and torch.equal(kw, pw) and torch.equal(kb, pb))
    log(f"gtp 19x19 genmove kernels vs plain (both on the card, same draws): "
        f"vertex {(kx, ky)} vs {(px, py)}, visits and value sums "
        f"{'bit-equal' if same else 'DIFFERENT'}; {ms['kernels']:.1f} ms "
        f"with the kernels, {ms['plain']:.1f} ms plain")
    check(same, "the 19x19 genmove differs between the kernel and plain paths")
    return ms


def new_shape_times(seed, dev, row_gostep, row_flood):
    """Device times of the shapes this phase gives the kernels: gostep at
    100 leaves of 19x19 (one full_19x19 search round) and flood at one
    board (a GTP move or a replayed SGF move), 9x9 and 19x19."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.ops import flood, gostep

    stones, sides, actions = positions(19, 4, 25, seed + 11, dev)
    b = stones.shape[0]
    out_s = torch.empty_like(stones)
    out_i = torch.empty((b, 362), dtype=torch.bool, device=dev)
    flag = ops.errors.error_word(dev)
    got = gostep.step_legal(stones, sides, actions)
    exp = gostep.step_legal_plain(stones, sides, actions)
    check(torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1]),
          "gostep differs from plain at 100 leaves of 19x19")
    ms = graph_ms(lambda: gostep._launch(stones, sides, actions, out_s, out_i,
                                         flag), 200)
    nbytes = (stones.numel() + sides.numel() + 4 * actions.numel()
              + out_s.numel() + out_i.numel())
    row_gostep.update(ms_19x19_b100=ms,
                      bound_ms_19x19_b100=nbytes / HBM_BYTES_PER_S * 1e3)
    log(f"gostep 19x19 B={b} (one full_19x19 round): device {ms:.5f} ms, "
        f"bound {row_gostep['bound_ms_19x19_b100']:.6f} ms ({nbytes} bytes)")
    for size in (9, 19):
        st, sd, _ = positions(size, 2, 30, seed + 12, dev)
        own, empty = st[:1] == sd[:1, None, None], st[:1] == 0
        s, a = own & flood.dilate(empty), own
        check(torch.equal(flood.flood_fixpoint(s, a), flood.flood_plain(s, a)),
              f"flood differs from plain at one {size}x{size} board")
        out = torch.empty_like(s)
        fms = graph_ms(lambda: flood._launch(s, a, out, flag), 500)
        row_flood[f"ms_{size}x{size}_b1"] = fms
        row_flood[f"bound_ms_{size}x{size}_b1"] = \
            3 * s.numel() / HBM_BYTES_PER_S * 1e3
        log(f"flood {size}x{size} B=1: device {fms:.5f} ms, bound "
            f"{row_flood[f'bound_ms_{size}x{size}_b1']:.8f} ms")
    ops.check_kernel_errors(dev)


def gtp_process(cmd):
    """Start ``cmd`` (a GTP engine) with its stderr in a temporary file;
    returns (process, ask, stderr file).  ask(line) sends one command and
    returns its response; a closed output is a failure, with the end of
    the engine's stderr."""
    import os
    import tempfile

    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=err, text=True, bufsize=1,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))

    def ask(line):
        proc.stdin.write(line + "\n")
        proc.stdin.flush()
        lines = []
        while True:
            out = proc.stdout.readline()
            if out == "":
                err.seek(0)
                raise SmokeFailure(f"the GTP process closed its output after "
                                   f"{line!r}:\n{err.read()[-3000:]}")
            if out == "\n":
                if lines:
                    return "".join(lines) + "\n"
                continue
            lines.append(out)

    return proc, ask, err


def strength_gtp_game(card):
    """The real entry point as a subprocess from model_291 at --preset
    strength: a self-play game of up to STRENGTH_GENMOVES genmoves (both
    colours, until two passes in a row or a resign), final_score and
    quit.  Every command must be answered and the process must exit 0.
    The first genmove also builds the kernels in that process."""
    from sejonggo_torch.goenv import gtp_to_xy

    proc, ask, err = gtp_process(
        [sys.executable, "-m", "sejonggo_torch.io.gtp", "--preset",
         "strength", "--model-dir", MODELS, "--checkpoint", "model_291"])
    try:
        for line in ("protocol_version", "boardsize 9", "komi 5.5",
                     "clear_board"):
            gtp_ok(ask(line))
        secs, moves, passes = [], [], 0
        for i in range(STRENGTH_GENMOVES):
            color = "BW"[i % 2]
            t = time.perf_counter()
            vertex = gtp_ok(ask(f"genmove {color}"))
            secs.append(time.perf_counter() - t)
            moves.append(vertex)
            if vertex == "resign":
                break
            x, y = gtp_to_xy(vertex, 9)
            check(0 <= x < 9 and 0 <= y <= 9, f"genmove gave {vertex!r}")
            passes = passes + 1 if vertex == "pass" else 0
            if passes == 2:
                break
        board = gtp_ok(ask("showboard"))
        score = gtp_ok(ask("final_score"))
        check(score == "0" or score[:2] in ("B+", "W+"),
              f"final_score gave {score!r}")
        gtp_ok(ask("quit"))
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    check(code == 0, f"the GTP process exited {code}")
    check(len(board.splitlines()) == 9, "showboard is not a 9x9 board")
    rest = secs[1:] or secs
    ms = 1e3 * sum(rest) / len(rest)
    log(f"gtp strength from model_291 (python -m sejonggo_torch.io.gtp): "
        f"{len(moves)} genmoves ({' '.join(moves)}), final_score {score}, "
        f"exit 0; first genmove {secs[0]:.2f} s (the process builds the "
        f"kernels), then {ms:.1f} ms per genmove (round trip) on {card}")
    return dict(genmoves=len(moves), ms_per_genmove=ms, score=score)


def phase_gtp(seed, dev, card, gostep_row, flood_row):
    """GTP at full full_19x19 width (20 x 256, 1600 simulations in 16
    rounds of 100 leaves, 3302 tree slots, weights seeded from --seed)
    through GTPFrontend.parse_command: alternate genmove (black) and play
    (white replies with the most visited move of the kept tree) for
    GTP_MOVES moves, then sg_showtree, showboard and final_score.  Every
    response well-formed, sg_showtree consistent, the kept tree reused,
    launches 16 gostep a genmove, 4 flood a move and 2 a score.  Then one
    genmove kernels vs plain on the card, the session replayed through
    the plain engine on the CPU, and the strength game from model_291
    through the command line."""
    import numpy as np
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.config import full_19x19
    from sejonggo_torch.goenv import engine, gtp_to_xy, xy_to_gtp
    from sejonggo_torch.io.gtp import GoEngine, GTPFrontend
    from sejonggo_torch.search import tree_debug

    cfg = full_19x19()
    check((cfg.net.blocks, cfg.net.filters, cfg.search.simulations,
           cfg.search.batch_size, cfg.search.capacity()) ==
          (20, 256, 1600, 100, 3302), "full_19x19 moved")
    rounds = cfg.search.rounds
    predict, draw_s = full_net(seed, dev)
    rng = np.random.RandomState(seed)
    eng = GoEngine(predict, size=19, komi=cfg.go.komi, search=cfg.search,
                   seed=seed, device=dev)
    gtp = GTPFrontend(eng)
    for line in ("boardsize 19", "komi 7.5", "clear_board"):
        gtp_ok(gtp.parse_command(line))
    played, boards, genmove_ms, kept = [], [], [], 0
    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    for i in range(GTP_MOVES):
        if i % 2 == 0:
            kept += int(eng.tree_valid)
            legal = engine.legal_moves_mask(eng.board).cpu()
            t = time.perf_counter()
            vertex = gtp_ok(gtp.parse_command("genmove B"))
            torch.cuda.synchronize()
            genmove_ms.append(1e3 * (time.perf_counter() - t))
            check(vertex != "resign", "the engine resigned (resign is off)")
            x, y = gtp_to_xy(vertex, 19)
            check(bool(legal[19 * 19 if y == 19 else y * 19 + x]),
                  f"genmove gave the illegal {vertex}")
            check(eng.tree_valid and int(eng.tree.root_N[0]) > 0,
                  "the kept tree was dropped after the engine's own move")
            played.append((1, x, y))
        else:
            # the most visited reply of the kept tree (a legal random
            # point if the tree has no visits there)
            counts = eng.tree.child_N[0, 0].cpu()
            legal = engine.legal_moves_mask(eng.board).cpu()
            a = int(counts.argmax()) if int(counts.max()) > 0 else \
                int(rng.choice(np.nonzero(legal[:361].numpy())[0]))
            x, y = (a % 19, a // 19) if a < 361 else (0, 19)
            gtp_ok(gtp.parse_command(f"play W {xy_to_gtp(x, y, 19)}"))
            played.append((-1, x, y))
        boards.append(eng.board.cpu())
    tree = gtp_ok(gtp.parse_command("sg_showtree 2 3"))
    check("root: N=" in tree and "pv:" in tree and "INCONSISTENT" not in tree,
          f"sg_showtree: {tree[:300]!r}")
    shown = gtp_ok(gtp.parse_command("showboard"))
    check(len(shown.splitlines()) == 19, "showboard is not a 19x19 board")
    score = gtp_ok(gtp.parse_command("final_score"))
    check(score == "0" or score[:2] in ("B+", "W+"), f"final_score {score!r}")
    torch.cuda.synchronize()
    counts = ops.kernel_launches()
    ops.check_kernel_errors(dev)
    n_gen = len(genmove_ms)
    want = {"gostep": rounds * n_gen, "flood": 4 * GTP_MOVES + 2}
    check(counts == want, f"gtp launches {counts}, expected {want}")
    check(kept >= 1, f"none of {n_gen} genmoves started from a kept tree")
    problems = tree_debug.check_consistency(tree_debug.extract_tree(eng.tree, 0))
    check(not problems, f"tree inconsistent: {problems[:3]}")
    log(f"gtp full_19x19 ({cfg.net.blocks}x{cfg.net.filters} "
        f"{cfg.net.compute_dtype}, {cfg.search.simulations} sims, "
        f"k={cfg.search.batch_size}, {cfg.search.capacity()} slots, weights "
        f"drawn on the host in {draw_s:.2f} s): {GTP_MOVES} moves, "
        f"genmove ms {', '.join(f'{m:.1f}' for m in genmove_ms)} (the first "
        f"builds the tree), {kept} of {n_gen} genmoves on a kept tree, "
        f"final_score {score}, launches {counts} on {card}")
    # the session through the plain engine on the CPU
    board = engine.init_board(19, device="cpu")
    for (player, x, y), want_b in zip(played, boards):
        board, _ = engine.play_at(board, x, y, player)
        check(torch.equal(board, want_b), "the replayed session differs")
    torch.backends.cudnn.deterministic = True
    cmp_ms = kernel_vs_plain_genmove(predict, eng.board, dev, seed)
    torch.backends.cudnn.deterministic = False
    new_shape_times(seed, dev, gostep_row, flood_row)
    strength = strength_gtp_game(card)
    return counts, dict(moves=GTP_MOVES, genmoves=n_gen,
                        genmove_ms=float(np.mean(genmove_ms[1:])),
                        first_genmove_ms=genmove_ms[0], plain_ms=cmp_ms,
                        strength=strength)


def phase_kgs(seed, dev, card):
    """KGS pretraining at full full_19x19 width in a temporary workdir:
    Pipeline(full_19x19(), workdir, seed, device="cuda"), init_models, then
    kgs_pretrain_phase on the committed corpus for KGS_STEPS steps at the
    preset's batch of 32 with a backup every KGS_BACKUP steps.  model_2,
    backup and the metrics event are written, model_2 reads back
    bit-equal to the trained state, the loss is finite, the replay's
    floods are 4 a replayed move and gostep never runs.  Then one corpus
    game replayed on the card and on the CPU (equal samples, 4 floods a
    move) and the train step timed on one batch."""
    import json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.config import full_19x19
    from sejonggo_torch.io import kgs
    from sejonggo_torch.io.sgf import parse_sgf
    from sejonggo_torch.learn import restore
    from sejonggo_torch.learn.checkpoint import state_tree
    from sejonggo_torch.pipeline import Pipeline

    cfg = full_19x19()
    check(cfg.train.batch_size == 32, "full_19x19's batch moved")
    replayed = {"moves": 0, "secs": 0.0}
    real_replay = kgs.replay_sgf

    def counted_replay(text, size, device=None):
        t = time.perf_counter()
        out = real_replay(text, size, device)
        replayed["secs"] += time.perf_counter() - t
        p = parse_sgf(text)
        if p["size"] == size:
            replayed["moves"] += (len(p["moves"]) + len(p["setup_black"])
                                  + len(p["setup_white"]))
        return out

    workdir = tempfile.mkdtemp(prefix="sejonggo_kgs_")
    try:
        pipe = Pipeline(cfg, workdir, seed, device=dev)
        t = time.perf_counter()
        pipe.init_models()
        init_s = time.perf_counter() - t
        saved = {}
        real_save = pipe.store.save_state

        def save_state(name, state):
            saved[name] = state_tree(state)
            real_save(name, state)

        pipe.store.save_state = save_state
        kgs.replay_sgf = counted_replay
        ops.reset_kernel_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = pipe.kgs_pretrain_phase(CORPUS, steps=KGS_STEPS,
                                        backup_every=KGS_BACKUP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = ops.kernel_launches()
        ops.check_kernel_errors(dev)
        kgs.replay_sgf = real_replay
        models = os.path.join(workdir, cfg.model_dir)
        check(stats["steps"] == KGS_STEPS and stats["to"] == "model_2",
              f"kgs_pretrain stats {stats}")
        check(sorted(os.listdir(models)) == ["backup.msgpack", "index.json",
                                             "model_1.msgpack",
                                             "model_2.msgpack"],
              f"model dir holds {sorted(os.listdir(models))}")
        check(np.isfinite(stats["loss"]), f"loss {stats['loss']}")
        written = restore(os.path.join(models, "model_2.msgpack"))
        check(same_tree(written, saved["model_2"]),
              "model_2.msgpack differs from the trained state")
        check(int(written["step"]) == KGS_STEPS, f"model_2 step "
              f"{int(written['step'])}")
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            events = [json.loads(line)["event"] for line in f]
        check(events == ["kgs_pretrain"], f"metric events {events}")
        check(counts == {"gostep": 0, "flood": 4 * replayed["moves"]},
              f"kgs launches {counts} for {replayed['moves']} replayed moves")
        # one game on the card and on the CPU
        text = open(os.path.join(CORPUS, "rollout_00_005.sgf")).read()
        ops.reset_kernel_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        on_card = kgs.replay_sgf(text, 19, dev)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t
        game_counts = ops.kernel_launches()
        on_cpu = kgs.replay_sgf(text, 19, "cpu")
        check(len(on_card) == len(on_cpu) == len(parse_sgf(text)["moves"]),
              "replayed sample counts differ")
        for a, b in zip(on_card, on_cpu):
            check(all(np.array_equal(a[k], b[k])
                      for k in ("board", "policy", "value")),
                  "a replayed sample differs between the card and the CPU")
        check(game_counts == {"gostep": 0, "flood": 4 * len(on_cpu)},
              f"replay launches {game_counts} for {len(on_cpu)} moves")
        # the train step alone on one batch of the corpus
        boards, policies, values = next(kgs.kgs_sample_stream(
            CORPUS, 19, batch_size=32, device=dev))
        state = pipe.load("model_2")
        batch = [torch.from_numpy(x).to(dev)
                 for x in (boards, policies, values)]
        state, _ = pipe.train_step(state, *batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(KGS_TIMED_STEPS):
            state, m = pipe.train_step(state, *batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t) / KGS_TIMED_STEPS
        check(float(m["nonfinite"]) == 0.0, "timed train step non-finite")
    finally:
        kgs.replay_sgf = real_replay
        shutil.rmtree(workdir, ignore_errors=True)
    flops = 3 * forward_flops(cfg.net, size=19) * 32
    tflops = flops / (step_ms * 1e-3) / 1e12
    phase_ms = 1e3 * stats["seconds"] / KGS_STEPS
    log(f"kgs full_19x19 pretrain on {card}: model_1 made in {init_s:.2f} s; "
        f"{KGS_STEPS} steps at batch 32 in {stats['seconds']:.2f} s = "
        f"{phase_ms:.1f} ms per step with the replay and the backups "
        f"({32 * KGS_STEPS / stats['seconds']:.1f} samples/s); "
        f"{replayed['moves']} moves replayed in {replayed['secs']:.2f} s = "
        f"{replayed['moves'] / max(replayed['secs'], 1e-9):.1f} moves/s; "
        f"loss {stats['loss']:.4f}; launches {counts}; {secs:.2f} s in all")
    log(f"kgs train step alone: {step_ms:.2f} ms at batch 32, "
        f"{32e3 / step_ms:.1f} samples/s, {flops / 1e9:.1f} GFLOP a step from "
        f"the shapes = {tflops:.2f} TFLOP/s, {100 * tflops / 989:.2f}% of the "
        f"989 TFLOP/s bf16 peak; one corpus game ({len(on_cpu)} moves) "
        f"replayed on the card in {replay_s:.3f} s = "
        f"{len(on_cpu) / replay_s:.1f} moves/s, equal to the CPU's, "
        f"launches {game_counts}")
    return counts, dict(step_ms=step_ms, phase_ms=phase_ms, tflops=tflops,
                        replayed_moves=replayed["moves"],
                        replay_moves_per_s=len(on_cpu) / replay_s)


def midgame_boards(games, moves, seed, dev):
    """(plane boards (games, 9, 9, 17), last moves (games,)) after
    ``moves`` contact-biased random legal moves, played on ``dev``."""
    import numpy as np
    import torch

    from sejonggo_torch.goenv import engine
    from sejonggo_torch.goenv.positions import choose_actions

    rng = np.random.RandomState(seed)
    boards = engine.init_board(9, batch=games, device=dev)
    act = torch.full((games,), -1, dtype=torch.int32)
    for _ in range(moves):
        illegal = engine.illegal_moves_mask_batch(boards).cpu().numpy()
        occ = ((boards[..., 0] == 1) | (boards[..., 1] == 1)).cpu().numpy()
        act = torch.as_tensor(choose_actions(rng, illegal, occ, 0.8, 0.0))
        boards = engine.step_batch(boards, act.to(dev))
    return boards, act.to(dev)


def michi_launches(c, net_rounds=0):
    """The gostep and flood launches the michi code implies from its
    counts ``c`` (michi_search_batch's, prefixed ``michi_`` in a duel's):
    a gostep per playout step, per ladder read batch and two per ladder
    iteration; four floods per env step, two per score, one per ladder
    iteration; and, in a duel, per net move ``net_rounds`` gosteps and
    four floods, per michi move four floods, two for the final score."""
    p = "michi_" if "michi_moves" in c else ""
    li = c.get(p + "ladder_iters", 0)
    gostep = (c[p + "playout_steps"] + c.get(p + "ladder_calls", 0) + 2 * li
              + c.get("net_moves", 0) * net_rounds)
    flood = (4 * c[p + "env_steps"] + 2 * c[p + "scores"] + li
             + 4 * (c.get("net_moves", 0) + c.get("michi_moves", 0))
             + (2 if p else 0))
    return {"gostep": gostep, "flood": flood}


def michi_kernels_vs_plain(seed, dev, card, gostep_row):
    """One mc_playout_batch of MICHI_BOARDS mid-game boards and one whole
    michi_search_batch of MICHI_GAMES games at DUEL_SIMS simulations,
    each through the kernels and through the plain versions on the card
    with the same draws: scores, AMAF rows, final grids and every tree
    field bit-equal; the launches those counts imply.  Then gostep timed
    by graph replay at the two batches the michi path gives it."""
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.config import MichiConfig
    from sejonggo_torch.ops import gostep
    from sejonggo_torch.search import michi

    cfg = MichiConfig(komi=5.5, n_sims=DUEL_SIMS)
    check(cfg.playout_parallel * MICHI_GAMES == MICHI_BOARDS
          and cfg.playout_cap(9) == 162, "MichiConfig moved")
    boards, last = midgame_boards(MICHI_BOARDS, 24, seed + 30, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((162, MICHI_BOARDS, 81), generator=g, device=dev)
    draws = {"gates": torch.rand((162, MICHI_BOARDS, 5), generator=g,
                                 device=dev),
             "gumbel": -torch.log(-torch.log(u.clamp(min=1e-30)))}
    amaf = torch.zeros((MICHI_BOARDS, 82), dtype=torch.int8, device=dev)
    out, ms = {}, {}
    for name in ("kernels", "plain"):
        ops.reset_kernel_launches()
        stats = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            out[name] = michi.mc_playout_batch(
                boards, amaf, cfg, last, draws=draws, stats=stats,
                return_final=True)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t)
        if name == "kernels":
            launches = ops.kernel_launches()
            check(launches == {"gostep": stats["playout_steps"], "flood": 2},
                  f"playout launches {launches}, counts {stats}")
    same = all(torch.equal(a, b) for a, b in zip(out["kernels"], out["plain"]))
    log(f"michi playout B={MICHI_BOARDS} 9x9 kernels vs plain (both on the "
        f"card, same draws): scores, AMAF, final grids "
        f"{'bit-equal' if same else 'DIFFERENT'}; {stats['playout_steps']} "
        f"steps, {ms['kernels']:.1f} ms with the kernels, {ms['plain']:.1f} "
        f"ms plain on {card}")
    check(same, "the michi playout differs between the kernel and plain paths")
    ops.check_kernel_errors(dev)

    b16, l16 = boards[:MICHI_GAMES], last[:MICHI_GAMES]
    trees, sms = {}, {}
    for name in ("kernels", "plain"):
        ops.reset_kernel_launches()
        stats = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            t0 = michi.new_michi_tree_batch(b16, cfg, l16, stats=stats)
            tr, active = michi.michi_search_batch(
                t0, cfg, generator=torch.Generator(device=dev).manual_seed(
                    seed + 1), stats=stats)
        torch.cuda.synchronize()
        sms[name] = 1e3 * (time.perf_counter() - t)
        trees[name] = (tr, active)
        if name == "kernels":
            launches, want = ops.kernel_launches(), michi_launches(stats)
            check(launches == want, f"search launches {launches}, the counts "
                  f"{stats} imply {want}")
    (tk, ak), (tp, ap) = trees["kernels"], trees["plain"]
    same = torch.equal(ak, ap) and all(
        torch.equal(x, tp.fields()[k]) for k, x in tk.fields().items())
    log(f"michi search {MICHI_GAMES} games x {DUEL_SIMS} sims (k="
        f"{cfg.playout_parallel}, {cfg.node_capacity()} slots) kernels vs "
        f"plain: trees {'bit-equal' if same else 'DIFFERENT'}; "
        f"{int(tk.n_nodes.sum())} nodes, counts {stats}; "
        f"{sms['kernels']:.1f} ms with the kernels, {sms['plain']:.1f} ms "
        f"plain on {card}")
    check(same, "the michi search differs between the kernel and plain paths")
    ops.check_kernel_errors(dev)

    flag = ops.errors.error_word(dev)
    for b in (MICHI_BOARDS, MICHI_GAMES):
        stones, sides, actions = positions(9, b // 8, 8, seed + 31, dev)
        out_s = torch.empty_like(stones)
        out_i = torch.empty((b, 82), dtype=torch.bool, device=dev)
        gms = graph_ms(lambda: gostep._launch(stones, sides, actions, out_s,
                                              out_i, flag), 500)
        nbytes = (stones.numel() + sides.numel() + 4 * actions.numel()
                  + out_s.numel() + out_i.numel())
        gostep_row[f"ms_9x9_b{b}"] = gms
        gostep_row[f"bound_ms_9x9_b{b}"] = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"gostep 9x9 B={b} (michi playout step): device {gms:.5f} ms, "
            f"bound {gostep_row[f'bound_ms_9x9_b{b}']:.7f} ms ({nbytes} bytes)")
    ops.check_kernel_errors(dev)
    return dict(playout_ms=ms, search_ms=sms)


def replay_duel(res, komi):
    """Replay a duel through the plain engine on the CPU: every valid move
    legal for the side to move, finished games frozen, the final grids
    and area winners reproduced, resignations consistent."""
    import numpy as np
    import torch

    from sejonggo_torch.goenv import engine

    actions = torch.as_tensor(res["actions"]).long()
    valid = torch.as_tensor(res["move_valid"])
    board = engine.init_board(9, batch=actions.shape[1], device="cpu")
    for t in range(actions.shape[0]):
        a, mv = actions[t], valid[t]
        side = board[:, 0, 0, 16].numpy()
        check(bool((side[mv.numpy()] == res["players"][t][mv.numpy()]).all()),
              f"duel move {t}: a recorded player is not the side to move")
        illegal = engine.illegal_moves_mask_batch(board).gather(1, a[:, None])
        check(not bool((illegal[:, 0] & mv).any()),
              f"duel move {t}: a recorded move is illegal")
        board = torch.where(mv[:, None, None, None],
                            engine.step_batch(board, a), board)
    check(torch.equal(engine.signed_stones(board),
                      engine.signed_stones(res["final_boards"])),
          "the replayed duel ends on other boards")
    w, _, _ = engine.score_batch(board, komi)
    check(np.array_equal(w.numpy(), res["area_winners"]),
          "the replayed duel's area winners differ")
    resigned = res["winners"] != res["area_winners"]
    check(int(resigned.sum()) <= res["michi_resigns"],
          "a winner differs from the area score without a michi resign")
    return int(res["move_valid"].sum())


def michi_gtp_session(seed, card):
    """python -m sejonggo_torch.io.gtp --preset strength --engine michi
    with the committed pattern files, at the default 1400 simulations:
    genmove B, play W (a legal reply), genmove B, genmove W, final_score,
    quit.  Each genmove's simulations come from the engine's stderr, its
    launches from the line it prints at exit; the session is replayed
    through the plain engine on the CPU (each genmove legal, the same
    final_score)."""
    import json

    import numpy as np

    from sejonggo_torch.goenv import engine, gtp_to_xy, xy_to_gtp

    proc, ask, err = gtp_process(
        [sys.executable, "-m", "sejonggo_torch.io.gtp", "--preset",
         "strength", "--engine", "michi", "--spat", PATTERNS + ".spat",
         "--prob", PATTERNS + ".prob"])
    rng = np.random.RandomState(seed)
    board = engine.init_board(9, device="cpu")
    secs, moves = [], []
    try:
        for line in ("boardsize 9", "komi 5.5", "clear_board"):
            gtp_ok(ask(line))
        for cmd in ("genmove B", "play W", "genmove B", "genmove W"):
            color = 1 if cmd.endswith("B") else -1
            if cmd == "play W":
                legal = engine.legal_moves_mask(board)[:81].numpy()
                a = int(rng.choice(np.nonzero(legal)[0]))
                vertex = xy_to_gtp(a % 9, a // 9, 9)
                gtp_ok(ask(f"play W {vertex}"))
            else:
                t = time.perf_counter()
                vertex = gtp_ok(ask(cmd))
                secs.append(time.perf_counter() - t)
                check(vertex != "resign", f"michi resigned at {cmd}")
            x, y = gtp_to_xy(vertex, 9)
            if cmd != "play W":
                mask = engine.legal_moves_mask(
                    board if int(board[0, 0, 16]) == color
                    else engine._swap_sides(board))
                check(bool(mask[81 if y == 9 else y * 9 + x]),
                      f"{cmd} gave the illegal {vertex}")
            board, _ = engine.play_at(board, x, y, color)
            moves.append(vertex)
        score = gtp_ok(ask("final_score"))
        gtp_ok(ask("quit"))
        code = proc.wait(timeout=120)
        err.seek(0)
        log_text = err.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    check(code == 0, f"the michi GTP process exited {code}")
    w, bp, wp = engine.score(board, 5.5)
    want = "0" if int(w) == 0 else \
        ("B+" if int(w) == 1 else "W+") + str(abs(float(bp) - float(wp)))
    check(score == want, f"final_score {score!r}, the replay gives {want!r}")
    sims = [int(ln.split()[2]) for ln in log_text.splitlines()
            if ln.startswith("michi genmove:")]
    lines = [ln for ln in log_text.splitlines()
             if ln.startswith("kernel launches:")]
    check(len(sims) == MICHI_GTP_GENMOVES and lines,
          f"the engine's stderr lacks its genmove or launch lines:\n"
          f"{log_text[-2000:]}")
    launches = json.loads(lines[-1].split(":", 1)[1])
    check(all(s >= 16 for s in sims) and launches["gostep"] > 0,
          f"genmove simulations {sims}, launches {launches}")
    ms = [1e3 * x for x in secs]
    log(f"gtp michi (python -m sejonggo_torch.io.gtp --engine michi, 1400 "
        f"sims, patterns): moves {' '.join(moves)}, final_score {score}, "
        f"genmove ms {', '.join(f'{m:.0f}' for m in ms)} (round trip; the "
        f"first builds the kernels), simulations before the fastplay stop "
        f"{sims}, launches {launches} on {card}")
    return dict(genmove_ms=ms, sims=sims, launches=launches, score=score)


def phase_michi(seed, dev, card, variables, gostep_row):
    """The model-free engines: the kernels against their plain versions
    at the michi shapes, the DUEL_GAMES-game duel of model_291 at
    strength_9x9_xl against michi@DUEL_SIMS (replayed on the CPU, launch
    counts, net wins inside DUEL_NET_WINS), and michi over GTP."""
    import numpy as np
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.config import MichiConfig, strength_9x9_xl
    from sejonggo_torch.learn.duel_michi import play_vs_michi
    from sejonggo_torch.nets import make_predict_fn

    cmp = michi_kernels_vs_plain(seed, dev, card, gostep_row)
    search = strength_9x9_xl().search
    predict = make_predict_fn(xl_net(variables, dev))
    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = play_vs_michi(predict, size=9, komi=5.5, search=search,
                        michi=MichiConfig(komi=5.5, n_sims=DUEL_SIMS),
                        game_batch=DUEL_GAMES, device=dev, seed=seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = ops.kernel_launches()
    ops.check_kernel_errors(dev)
    c = res["counts"]
    want = michi_launches(c, net_rounds=search.rounds)
    check(launches == want, f"duel launches {launches}, the counts {c} "
          f"imply {want}")
    moves = replay_duel(res, 5.5)
    lo, hi = DUEL_NET_WINS
    check(lo <= res["net_wins"] <= hi,
          f"the net won {res['net_wins']} of {DUEL_GAMES}, outside {lo}-{hi}")
    net_ms = 1e3 * c["net_seconds"] / c["net_moves"]
    michi_ms = 1e3 * c["michi_seconds"] / c["michi_moves"]
    log(f"duel model_291 (xl search, bf16) vs michi@{DUEL_SIMS}: "
        f"{res['net_wins']}/{DUEL_GAMES} net wins (win rate "
        f"{res['winrate']:.5f}), {res['michi_resigns']} michi resigns, mean "
        f"{float(np.mean(res['num_moves'])):.3f} moves, {moves} moves replayed "
        f"on the CPU; {c['michi_moves']} michi and {c['net_moves']} net "
        f"half-batch moves of {DUEL_GAMES // 2} games, {michi_ms:.1f} ms per "
        f"michi move, {net_ms:.1f} ms per net move, {secs:.1f} s in all; "
        f"michi rounds {c['michi_rounds']}, playout steps "
        f"{c['michi_playout_steps']}, ladder iterations "
        f"{c.get('michi_ladder_iters', 0)}; launches {launches} on {card}")
    gtp = michi_gtp_session(seed, card)
    return launches, dict(
        duel=dict(net_wins=res["net_wins"], winrate=res["winrate"],
                  michi_resigns=res["michi_resigns"],
                  mean_moves=float(np.mean(res["num_moves"])),
                  michi_moves=c["michi_moves"], net_moves=c["net_moves"],
                  michi_ms=michi_ms, net_ms=net_ms, seconds=secs),
        gtp=gtp, **cmp)


# --- phase 14: multi-rank play and training ----------------------------

def multi_world():
    """(ranks, backend) of phase 14: one rank per card over NCCL where the
    machine has two or more (4 ranks from 4 cards), else two ranks on
    cuda:0 over gloo (NCCL refuses two ranks on one card)."""
    import torch

    count = torch.cuda.device_count()
    return (4 if count >= 4 else 2), ("nccl" if count >= 2 else "gloo")


def flat_state(state):
    """Parameters, running statistics and momentum of a train state as one
    float32 host vector."""
    import torch

    net = state.net
    return torch.cat([t.detach().reshape(-1).float().cpu() for t in
                      list(net.parameters()) + list(net.buffers())
                      + [state.opt_state]]).numpy()


def per_rank_bn_step(step, state, rows, shards):
    """One train step as a world of ``shards`` ranks WITHOUT global
    BatchNorm statistics would take it, in one process: each shard's step
    from the same state with its own batch statistics, then the mean of
    the states.  The SGD update and the running-statistics fold are linear,
    so the mean is the step with the shards' gradients all-reduced as a
    mean and their running statistics averaged: the fault 14a exists to
    catch."""
    import torch

    from sejonggo_torch.learn import TrainState

    tensors = list(state.net.parameters()) + list(state.net.buffers())
    start = [t.detach().clone() for t in tensors]
    per = rows[0].shape[0] // shards
    ends, outs = [], []
    for i in range(shards):
        with torch.no_grad():
            for t, s0 in zip(tensors, start):
                t.copy_(s0)
        out = step(TrainState(state.net, state.opt_state.clone(), state.step),
                   *(x[i * per:(i + 1) * per] for x in rows))
        ends.append([t.detach().clone() for t in tensors])
        outs.append(out)
    with torch.no_grad():
        for j, t in enumerate(tensors):
            t.copy_(sum(e[j] for e in ends) / shards
                    if t.is_floating_point() else ends[-1][j])
    trace = sum(o[0].opt_state for o in outs) / shards
    return TrainState(state.net, trace, outs[-1][0].step), outs[-1][1]


def xl_train_steps(batch, dev, dtype, mesh=None, per_rank_bn=0):
    """MULTI_TRAIN_STEPS xl train steps from model_291 on ``batch`` (this
    rank's rows when ``mesh`` is given; ``per_rank_bn`` shards with their
    own BatchNorm statistics, ``per_rank_bn_step``) in ``dtype``: (flat
    state before, after, losses, ms per step)."""
    import numpy as np
    import torch

    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.learn import (CheckpointStore, make_optimizer,
                                      make_train_step)
    from sejonggo_torch.nets import AZNet
    from sejonggo_torch.parallel import shard_batch

    cfg = strength_9x9_xl()
    net = AZNet.from_config(9, dataclasses.replace(
        cfg.net, compute_dtype=dtype)).to(dev)
    state = CheckpointStore(MODELS).load_state("model_291", net)
    before = flat_state(state)
    step = make_train_step(make_optimizer(
        cfg.train.lr, cfg.train.momentum, cfg.net.l2), cfg.train.loss_mode,
        mesh=mesh)
    rows = [x if mesh is None else shard_batch(x, mesh) for x in batch]
    local = [torch.from_numpy(x).to(dev) for x in rows]
    losses, secs = [], []
    for _ in range(MULTI_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if per_rank_bn:
            state, m = per_rank_bn_step(step, state, local, per_rank_bn)
        else:
            state, m = step(state, *local)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t)
        check(float(m["nonfinite"]) == 0.0, f"{dtype} train step non-finite")
    return before, flat_state(state), losses, 1e3 * float(np.median(secs[1:]))


def rank_train(batch, mesh):
    """Phase 14a on one rank: the xl steps on its share of the batch in
    float32 and bf16; every rank's state bit-equal to every other's,
    checked by the all-reduced max and min of two checksums."""
    import torch
    import torch.distributed as dist

    out = {}
    for dtype in ("float32", "bfloat16"):
        _, after, losses, ms = xl_train_steps(batch, mesh.device, dtype, mesh)
        x = torch.from_numpy(after).double()
        w = (torch.arange(x.numel(), dtype=torch.float64) % 7) + 1
        c = torch.stack([x.sum(), (x * w).sum()]).to(mesh.device)
        hi, lo = c.clone(), c.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        check(torch.equal(hi, lo), f"{dtype}: the ranks' states differ "
              f"after {MULTI_TRAIN_STEPS} steps (checksums {hi.tolist()} "
              f"against {lo.tolist()})")
        out[dtype] = dict(flat=after, losses=losses, ms=ms)
        log(f"rank {mesh.rank}: {MULTI_TRAIN_STEPS} {dtype} xl steps on "
            f"{len(batch[0]) // mesh.size} of {len(batch[0])} rows, "
            f"{ms:.2f} ms a step, losses {losses}; state bit-equal on every "
            "rank (all-reduced max == min)")
    return out


def rank_play_vs_plain(variables, mesh, seed):
    """Phase 14b on one rank: its share of a MULTI_PLAY_GAMES-game
    ``play_games`` over the mesh at the xl search from model_291, through
    the kernels and through the plain versions on the card with the same
    draws: every record bit-equal."""
    import numpy as np
    import torch

    from sejonggo_torch.actor import play_games
    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.nets import make_predict_fn
    from sejonggo_torch.search import sample_dirichlet

    cfg = strength_9x9_xl()
    search, g = cfg.search, torch.Generator().manual_seed(seed)
    draws = []
    for _ in range(MULTI_PLAY_MOVES):
        u = torch.rand((MULTI_PLAY_GAMES, 82),
                       generator=g).clamp(1e-20, 1 - 1e-7)
        draws.append(dict(
            noise=sample_dirichlet(search.dirichlet_alpha, MULTI_PLAY_GAMES,
                                   82, g),
            syms=torch.randint(0, 7, (search.rounds,), generator=g).tolist(),
            gumbel=-torch.log(-torch.log(u))))
    predict = make_predict_fn(xl_net(variables, mesh.device))

    def play():
        return play_games(predict, size=9, komi=cfg.go.komi, search=search,
                          game_batch=MULTI_PLAY_GAMES,
                          max_moves=MULTI_PLAY_MOVES,
                          stop_exploration=cfg.selfplay.stop_exploration,
                          device=mesh.device, mesh=mesh,
                          draws=lambda m: draws[m])

    kernels = play()
    with plain_kernels():
        plain = play()
    same = {f.name: np.array_equal(getattr(kernels, f.name),
                                   getattr(plain, f.name))
            for f in dataclasses.fields(kernels)}
    check(kernels.actions.shape[1] == MULTI_PLAY_GAMES // mesh.size,
          f"rank {mesh.rank} played {kernels.actions.shape[1]} games")
    check(all(same.values()), f"rank {mesh.rank}: sharded play_games differs "
          f"between kernels and plain versions: {same}")
    log(f"rank {mesh.rank}: its {MULTI_PLAY_GAMES // mesh.size} of "
        f"{MULTI_PLAY_GAMES} games, {MULTI_PLAY_MOVES} moves at the xl "
        "search, "
        "bit-equal through the kernels and the plain versions on the card")


def replay_games(games, komi):
    """Self-play game dicts replayed in one lockstep batch through the
    plain engine on the CPU (shorter games padded with masked moves):
    every move legal, the recorded grids reproduced; returns the winners
    and black points."""
    import numpy as np
    import torch

    from sejonggo_torch.goenv import engine

    t_max = max(len(g["actions"]) for g in games)
    n = games[0]["boards"].shape[1]
    stones = np.zeros((t_max, len(games), n, n), np.int8)
    actions = np.full((t_max, len(games)), n * n, np.int32)
    valid = np.zeros((t_max, len(games)), bool)
    for i, g in enumerate(games):
        t = len(g["actions"])
        stones[:t, i] = engine.signed_stones(torch.from_numpy(g["boards"]))
        actions[:t, i], valid[:t, i] = g["actions"], True
    return replay(stones, actions, valid, komi, masked_grids=True)


def rank_generation(workdir, seed, mesh):
    """Phase 14b on one rank: ``Pipeline.run(1)`` at strength_9x9_xl from
    model_291 in the shared workdir (this rank's share of the 512 games at
    384 slots, 256 steps of its 128 rows, its 64 gate games).  Returns
    what the launcher compares across ranks."""
    import numpy as np
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch import pipeline as pl
    from sejonggo_torch.config import strength_9x9_xl
    from sejonggo_torch.parallel.dryrun import state_digest

    cfg = strength_9x9_xl()
    rounds = cfg.search.simulations // cfg.search.batch_size
    pipe = pl.Pipeline(cfg, workdir, seed, device=mesh.device)
    check((pipe.mesh.size, pipe.mesh.rank) == (mesh.size, mesh.rank),
          f"the pipeline's mesh {pipe.mesh} on the world's {mesh}")
    saved, trained = [], []
    real_save, real_step = pipe.store.save_state, pipe.train_step

    def save_state(name, state):
        saved.append(name)
        real_save(name, state)

    def train_step(*args):
        out = real_step(*args)
        trained[:] = [out[0]]
        return out

    pipe.store.save_state, pipe.train_step = save_state, train_step
    with counted_phases(2 * (cfg.go.max_moves + 1)) as phases:
        ops.reset_kernel_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        (res,) = pipe.run(generations=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = ops.kernel_launches()
    ops.check_kernel_errors(mesh.device)
    sp, tr, ev = res["selfplay"], res["train"], res["evaluate"]
    sp_p, gate_p = phases["selfplay"], phases["gate"]
    games, batches = sp_p["games"], gate_p["batches"]
    check(pipe.store.latest_name() == "model_292",
          f"latest is {pipe.store.latest_name()!r}")
    check(saved == (["model_292"] if mesh.rank == 0 else []),
          f"rank {mesh.rank} wrote {saved}")
    check(tr["nonfinite_windows"] == 0, "non-finite train windows")
    written = state_digest(pipe.store.load_state("model_292", pipe._net()))
    check(written == state_digest(trained[0]),
          f"rank {mesh.rank}: model_292 read back differs from its state")
    share = len(mesh.game_slice(GEN_GAMES))
    check(sp["games"] >= share and len(games) == sp["games"],
          f"{sp['games']} self-play games, share {share}")
    steps, lock = check_generation_launches(phases, counts, rounds)
    gate_games = sum(gb.actions.shape[1] for gb in batches)
    check(gate_games == len(mesh.game_slice(GATE_GAMES)),
          f"rank {mesh.rank} played {gate_games} gate games")
    t = time.perf_counter()
    winners, black = replay_games(games, cfg.go.komi)
    check(np.array_equal(winners, [g["winner"] for g in games])
          and np.array_equal(black, [g["black_points"] for g in games]),
          "self-play winners differ from the replayed scores")
    for gb in batches:
        winners, black = replay(
            engine_stones(gb.boards), gb.actions, gb.move_valid, cfg.go.komi)
        check(np.array_equal(winners, gb.winners)
              and np.array_equal(black, gb.black_points),
              "gate winners differ from the replayed scores")
    replay_s = time.perf_counter() - t
    log(f"rank {mesh.rank}: generation {secs:.2f} s; self-play "
        f"{sp['games']} games (share {share}) in {steps} steps at "
        f"{sp_p['slots']} slots, {sp_p['secs']:.2f} s, "
        f"{1e3 * sp_p['secs'] / steps:.1f} ms a step; train "
        f"{tr['steps']} steps of {cfg.train.batch_size // mesh.size} rows in "
        f"{tr['seconds']:.2f} s, {1e3 * tr['seconds'] / tr['steps']:.2f} ms "
        f"a step, loss {tr['loss']:.4f}; gate {gate_games} games, "
        f"{lock} moves in {gate_p['secs']:.2f} s, "
        f"{1e3 * gate_p['secs'] / lock:.1f} ms a move, win rate "
        f"{ev['winrate']:.4f} of {ev['games']}, promote {ev['promote']}; "
        f"launches {counts}; {len(games)} self-play games and {gate_games} "
        f"gate games replayed through the plain engine in {replay_s:.1f} s")
    return dict(
        secs=secs, counts=counts, digest=written, saved=saved,
        promote=ev["promote"], best=res["best"], winrate=ev["winrate"],
        eval_games=ev["games"], selfplay_games=sp["games"],
        selfplay_steps=steps, selfplay_secs=sp_p["secs"], gate_moves=lock,
        gate_secs=gate_p["secs"], train_secs=tr["seconds"],
        train_steps=tr["steps"], loss=tr["loss"])


def engine_stones(boards):
    import torch

    from sejonggo_torch.goenv import engine

    return engine.signed_stones(torch.from_numpy(boards))


def rank_phase14(workdir, batch, seed, variables, timeout_s):
    """Phase 14 on one rank of the world (``parallel.launch``): 14a the
    xl train steps, 14b the sharded play_games kernels vs plain, then the
    generation.  A hang ends the rank with a traceback."""
    import torch

    from sejonggo_torch.parallel import backend, make_mesh

    faulthandler.dump_traceback_later(timeout_s - 30, exit=True)
    # the smoke's own precision settings (phase 4): no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh()
    log(f"rank {mesh.rank} of {mesh.size} on {mesh.device} over {backend()}")
    train = rank_train(batch, mesh)
    rank_play_vs_plain(variables, mesh, seed)
    gen = rank_generation(workdir, seed, mesh)
    return dict(rank=mesh.rank, world=mesh.size, backend=backend(),
                device=str(mesh.device), train=train, generation=gen)


def phase_multirank(seed, dev, card, batch, variables):
    """Phase 14: the world of ``multi_world()`` ranks started as processes
    (``sejonggo_torch.parallel.launch``, a time limit, exit codes
    checked): 14a the xl train step on the ranks against one process on
    the same 256 rows, sorted by stone count so that the ranks' halves
    differ (float32 within 5% of one process's update, bf16 within twice
    its bf16-vs-float32 gap, both in L2 over the parameters, statistics
    and momentum, each limit above this run's noise floor and at most
    half its per-rank BatchNorm fault; every rank's state bit-equal), 14b each rank's share of
    a sharded play_games bit-equal through the kernels and the plain
    versions, then one strength_9x9_xl generation from model_291 shared
    by the ranks (model_292 written once, by rank 0, and read back
    bit-equal by every rank; the same promotion decision everywhere; each
    rank's launches exact and its games replayed), then 14c
    ``dryrun_multichip(2)`` on the card."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sejonggo_torch.parallel.dryrun import dryrun_multichip
    from sejonggo_torch.parallel.launch import launch

    # emptier boards to rank 0: per-rank BatchNorm statistics would differ
    order = np.argsort(batch[0][..., :2].sum((1, 2, 3)), kind="stable")
    batch = tuple(x[order] for x in batch)
    world, backend = multi_world()
    log(f"phase 14 world: {world} ranks over {backend} "
        f"({torch.cuda.device_count()} card(s))")
    workdir = tempfile.mkdtemp(prefix="sejonggo_multirank_")
    try:
        models = os.path.join(workdir, "sp_models")
        os.makedirs(models)
        for f in ("model_291.msgpack", "index.json"):
            shutil.copy(os.path.join(MODELS, f), models)
        t = time.perf_counter()
        ranks = launch(world, f"{os.path.abspath(__file__)}:rank_phase14",
                       (workdir, batch, seed, variables, MULTI_TIMEOUT_S),
                       timeout_s=MULTI_TIMEOUT_S, echo=True)
        launch_s = time.perf_counter() - t
        files = set(os.listdir(workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check([r["backend"] for r in ranks] == [backend] * world,
          f"backends {[r['backend'] for r in ranks]}")
    gens = [r["generation"] for r in ranks]
    for k in ("promote", "best", "winrate", "eval_games", "digest", "loss"):
        check(len({repr(g[k]) for g in gens}) == 1,
              f"the ranks differ in {k}: {[g[k] for g in gens]}")
    check(gens[0]["eval_games"] == GATE_GAMES,
          f"{gens[0]['eval_games']} gate games in all")
    check(sum(g["selfplay_games"] for g in gens) >= GEN_GAMES,
          "fewer self-play games than the generation's")
    for i in range(world):
        check({f"run_state_p{i}.json", f"replay_p{i}.npz"} <= files,
              f"rank {i}'s run state is missing: {sorted(files)}")
    # 14a: the ranks against one process on the same rows, beside two
    # readings of this run: the noise floor (one process on the same rows
    # in three other orders: float32 sums in another order, which
    # BatchNorm's fast variance amplifies on near-constant channels) and
    # the fault (per-rank BatchNorm statistics on the ranks' halves,
    # per_rank_bn_step).  The limits, float32 5% of one process's update
    # and bf16 twice its bf16-vs-float32 gap, must lie above the noise
    # floor and at most half the fault, so that 14a fails the fault
    one = {d: xl_train_steps(batch, dev, d) for d in ("float32", "bfloat16")}
    update = float(np.linalg.norm(one["float32"][1] - one["float32"][0]))
    rng = np.random.RandomState(seed)
    perms = [rng.permutation(len(batch[0])) for _ in range(3)]
    noise, fault = {}, {}
    for d in ("float32", "bfloat16"):
        noise[d] = max(float(np.linalg.norm(
            xl_train_steps(tuple(x[p] for x in batch), dev, d)[1]
            - one[d][1])) for p in perms)
        fault[d] = float(np.linalg.norm(
            xl_train_steps(batch, dev, d, per_rank_bn=world)[1] - one[d][1]))
    tols = {"float32": 5e-2 * update,
            "bfloat16": 2 * float(np.linalg.norm(one["bfloat16"][1]
                                                 - one["float32"][1]))}
    errs = {}
    for d in ("float32", "bfloat16"):
        check(all(np.array_equal(r["train"][d]["flat"],
                                 ranks[0]["train"][d]["flat"]) for r in ranks),
              f"{d}: the ranks' states differ")
        err = float(np.linalg.norm(ranks[0]["train"][d]["flat"] - one[d][1]))
        errs[d] = (err, tols[d])
    log(f"phase 14a: {MULTI_TRAIN_STEPS} xl steps on {world} ranks vs one "
        f"process, {len(batch[0])} rows of the generation's replay: "
        + ", ".join(f"{d} L2 err {e:.6g} (tolerance {t:.6g}; noise floor "
                    f"{noise[d]:.6g}, per-rank BatchNorm fault "
                    f"{fault[d]:.6g})" for d, (e, t) in errs.items())
        + f" (float32 update {update:.6g}); losses ranks "
        f"{ranks[0]['train']['float32']['losses']}, one process "
        f"{one['float32'][2]}; ms a step: ranks "
        f"{ranks[0]['train']['float32']['ms']:.2f} "
        f"float32, {ranks[0]['train']['bfloat16']['ms']:.2f} bf16, one "
        f"process {one['float32'][3]:.2f} float32, "
        f"{one['bfloat16'][3]:.2f} bf16 on {card}")
    for d, (e, tol) in errs.items():
        check(noise[d] < tol <= fault[d] / 2,
              f"{d}: the limit {tol:.4g} does not separate the noise floor "
              f"{noise[d]:.4g} from the per-rank BatchNorm fault "
              f"{fault[d]:.4g}")
        check(e <= tol, f"{d}: the ranks' step differs from one process's: "
              f"{e:.4g} > {tol:.4g}")
    g0 = gens[0]
    log(f"phase 14b: one strength_9x9_xl generation on {world} ranks in "
        f"{launch_s:.2f} s with start-up and checks, "
        f"{max(g['secs'] for g in gens):.2f} s of Pipeline.run on the "
        f"slowest rank; self-play steps {[g['selfplay_steps'] for g in gens]},"
        f" train {g0['train_steps']} steps in "
        f"{[round(g['train_secs'], 2) for g in gens]} s, gate moves "
        f"{[g['gate_moves'] for g in gens]}; win rate {g0['winrate']:.4f}, "
        f"promote {g0['promote']} on every rank; model_292 written once and "
        f"read back bit-equal by every rank; launches "
        f"{[g['counts'] for g in gens]} on {card}")
    t = time.perf_counter()
    dryrun_multichip(2, timeout_s=300)
    log(f"phase 14c: dryrun_multichip(2) on the card in "
        f"{time.perf_counter() - t:.2f} s")
    return ranks, dict(world=world, backend=backend, launch_s=launch_s)


def phase_bench19(seed, dev, card):
    """bench.py's 19x19 point through the port (bench.py:242-273): the
    self-play move step at B=16, 1600 simulations in rounds of 100
    leaves, 2218 tree slots, the full_19x19 net (20 x 256, bf16) with
    weights from --seed; one warm move and B19_MOVES timed ones, the net
    timed alone at one round's 1600 boards."""
    import numpy as np
    import torch

    from sejonggo_torch import ops
    from sejonggo_torch.actor import init_state, make_move_step
    from sejonggo_torch.config import SearchConfig, full_19x19

    search = SearchConfig(simulations=1600, batch_size=100, use_symmetry=True,
                          max_nodes=2218)
    b = B19_GAMES
    predict, _ = full_net(seed, dev)
    step = make_move_step(predict, search, 19, selfplay=True)
    state = init_state(b, 19, search, device=dev)
    gen = torch.Generator().manual_seed(seed)
    greedy = torch.zeros(b, dtype=torch.bool, device=dev)
    thr = torch.full((b,), float("nan"), device=dev)
    secs = []
    for i in range(1 + B19_MOVES):
        if i == 1:
            ops.reset_kernel_launches()
        before = state.boards
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, rec, _ = step(state, greedy, thr, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        check(bool(torch.isfinite(rec["values"]).all()), "non-finite values")
        legal_check(before, rec["actions"], rec["move_valid"])
    counts = ops.kernel_launches()
    rounds = search.rounds
    check(counts == {"gostep": rounds * B19_MOVES, "flood": 4 * B19_MOVES},
          f"19x19 launches {counts} in {B19_MOVES} moves")
    rng = np.random.RandomState(seed)
    leaves = torch.from_numpy(
        (rng.rand(b * search.batch_size, 19, 19, 17) < 0.2).astype(np.float32)
    ).to(dev)
    net_ms = time_ms(lambda: predict(leaves), 3)
    tflops = (forward_flops(full_19x19().net, 19) * len(leaves)
              / (net_ms * 1e-3) / 1e12)
    move_ms = 1e3 * float(np.mean(secs[1:]))
    share = rounds * net_ms / move_ms
    log(f"phase 15 19x19 bench point: B={b}, 1600 sims in {rounds} rounds of "
        f"100, 2218 slots, 20x256 bf16: warm move {1e3 * secs[0]:.1f} ms, "
        f"then {', '.join(f'{1e3 * s:.1f}' for s in secs[1:])} ms a move "
        f"(mean {move_ms:.1f}), "
        f"{b * search.simulations / (move_ms * 1e-3):.1f} env-steps/s; the net {net_ms:.2f} ms per {b * search.batch_size} "
        f"boards ({tflops:.1f} TFLOP/s from the shapes, "
        f"{100 * tflops / 989:.1f}% of the 989 TFLOP/s bf16 peak), "
        f"{rounds} calls = {100 * share:.1f}% of a move; launches "
        f"{counts} on {card}")
    return counts, dict(moves=B19_MOVES, move_ms=move_ms, net_ms=net_ms,
                        net_share=share)


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
    t = time.perf_counter()
    variables = phase_checkpoint(dev)
    log(f"phase 6 checkpoint: ok in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    calib = xl_calibrator(args.seed)
    gate_counts, gate = phase_gate(variables, dev, args.seed, calib)
    ops.check_kernel_errors(dev)
    log(f"phase 7 gate: ok in {time.perf_counter() - t:.2f} s; win rate "
        f"{gate['winrate']:.4f}, {gate['ms_per_move']:.1f} ms per move at "
        f"B={GATE_GAMES} on {card}")
    t = time.perf_counter()
    actor, sp_counts, sp = phase_selfplay(variables, dev, args.seed, calib)
    ops.check_kernel_errors(dev)
    log(f"phase 8 self-play: ok in {time.perf_counter() - t:.2f} s; "
        f"{sp['ms_per_step']:.1f} ms per step, {sp['moves_per_s']:.1f} "
        f"moves/s at B={XL_GAMES}, xl, model_291 on {card}")
    t = time.perf_counter()
    phase_determinism(actor, args.seed)
    ops.check_kernel_errors(dev)
    log(f"phase 9 determinism: ok in {time.perf_counter() - t:.2f} s")
    del actor
    t = time.perf_counter()
    gen_counts, gen = phase_generation(dev, args.seed, card)
    log(f"phase 10 generation: ok in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    gtp_counts, gtp = phase_gtp(args.seed, dev, card, gostep_row, flood_row)
    log(f"phase 11 gtp: ok in {time.perf_counter() - t:.2f} s; "
        f"{gtp['genmove_ms']:.1f} ms per kept-tree genmove at full_19x19, "
        f"{gtp['strength']['ms_per_genmove']:.1f} ms per genmove at strength "
        f"from model_291 on {card}")
    t = time.perf_counter()
    kgs_counts, kgs = phase_kgs(args.seed, dev, card)
    log(f"phase 12 kgs: ok in {time.perf_counter() - t:.2f} s; "
        f"{kgs['step_ms']:.2f} ms per train step at batch 32, full_19x19, "
        f"on {card}")

    t = time.perf_counter()
    michi_counts, mi = phase_michi(args.seed, dev, card, variables, gostep_row)
    ops.check_kernel_errors(dev)
    log(f"phase 13 michi: ok in {time.perf_counter() - t:.2f} s; duel "
        f"{mi['duel']['michi_ms']:.1f} ms per michi@{DUEL_SIMS} move, "
        f"{mi['duel']['net_ms']:.1f} ms per xl net move; michi GTP "
        f"{mi['gtp']['genmove_ms'][-1]:.0f} ms per genmove at 1400 sims on "
        f"{card}")
    t = time.perf_counter()
    multi_ranks, multi = phase_multirank(args.seed, dev, card, gen["batch"],
                                         variables)
    log(f"phase 14 multi-rank: ok in {time.perf_counter() - t:.2f} s; "
        f"{multi['world']} ranks over {multi['backend']} on {card}")
    t = time.perf_counter()
    b19_counts, b19 = phase_bench19(args.seed, dev, card)
    ops.check_kernel_errors(dev)
    log(f"phase 15 19x19 bench point: ok in {time.perf_counter() - t:.2f} s; "
        f"{b19['move_ms']:.1f} ms a move at B={B19_GAMES} on {card}")

    for row in (gostep_row, flood_row):
        name = row["name"]
        row.update(launches=counts[name],
                   launches_selfplay=sp_counts[name],
                   selfplay_steps=sp["steps"],
                   launches_gate=gate_counts[name], gate_moves=gate["moves"],
                   launches_generation=gen_counts[name],
                   generation_selfplay_steps=gen["selfplay_steps"],
                   generation_gate_moves=gen["gate_moves"],
                   launches_gtp=gtp_counts[name], gtp_moves=gtp["moves"],
                   gtp_genmoves=gtp["genmoves"],
                   launches_kgs=kgs_counts[name],
                   kgs_replayed_moves=kgs["replayed_moves"],
                   launches_duel=michi_counts[name],
                   duel_michi_moves=mi["duel"]["michi_moves"],
                   duel_net_moves=mi["duel"]["net_moves"],
                   launches_michi_gtp=mi["gtp"]["launches"][name],
                   michi_gtp_genmoves=MICHI_GTP_GENMOVES,
                   launches_multirank_generation=[
                       r["generation"]["counts"][name] for r in multi_ranks],
                   multirank_world=multi["world"],
                   multirank_backend=multi["backend"],
                   multirank_selfplay_steps=[
                       r["generation"]["selfplay_steps"] for r in multi_ranks],
                   multirank_gate_moves=[
                       r["generation"]["gate_moves"] for r in multi_ranks],
                   launches_bench19=b19_counts[name],
                   bench19_moves=b19["moves"])
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
