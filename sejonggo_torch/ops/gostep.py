"""Fused leaf step + next-mover legality: the CUDA kernel
``csrc/gostep.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``sejonggo_tpu/ops/gostep.py``
(``step_legal_pallas``).  Per board: place the mover's stone, remove the
dead opponent groups that touch it, resolve own suicide, then for the next
mover the simple-ko point, the capturable groups (<= 1 distinct liberty)
and ``legal = empty & ~ko & (next to empty | next to capturable)``; pass
is always legal.  The search calls it once per round on all B*k leaves
(``search.mcts.simulate_round`` through
``goenv.engine.step_and_illegal_stones_batch``).

``step_legal`` dispatches on the tensors' device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes ``step_legal_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from sejonggo_torch.goenv import engine
from sejonggo_torch.ops import errors


def step_legal_plain(stones: torch.Tensor, sides: torch.Tensor,
                     actions: torch.Tensor):
    """engine.step_stones_batch, then
    engine.illegal_moves_mask_stones_batch(new, parent, -sides)."""
    new = engine.step_stones_batch(stones, sides, actions)
    illegal = engine.illegal_moves_mask_stones_batch(
        new, stones, -sides.to(torch.int8))
    return new, illegal


def _check(stones, sides, actions):
    if stones.dtype != torch.int8 or stones.dim() != 3 \
            or stones.shape[1] != stones.shape[2]:
        raise ValueError(f"step_legal takes (B, N, N) int8 stones, got "
                         f"{tuple(stones.shape)} {stones.dtype}")
    b = stones.shape[0]
    if sides.shape != (b,) or actions.shape != (b,):
        raise ValueError(f"step_legal takes (B,) sides and actions, got "
                         f"{tuple(sides.shape)} and {tuple(actions.shape)}")
    if not (stones.device == sides.device == actions.device):
        raise ValueError("stones, sides and actions lie on different devices")


def _launch(stones, sides, actions, out_stones, out_illegal, err) -> None:
    """Launch the kernel on the current stream; raises if CUDA refused
    the launch.  Counts nothing: ``step_legal`` is the wrapper."""
    from sejonggo_torch.ops import _build

    b, n, _ = stones.shape
    vp = ctypes.c_void_p
    code = _build.load_library().sejonggo_step_legal(
        vp(stones.data_ptr()), vp(sides.data_ptr()), vp(actions.data_ptr()),
        vp(out_stones.data_ptr()), vp(out_illegal.data_ptr()),
        vp(err.data_ptr()), b, n,
        vp(torch.cuda.current_stream(stones.device).cuda_stream))
    if code != 0:
        raise RuntimeError(f"gostep kernel launch failed: CUDA error {code}")


def step_legal(stones: torch.Tensor, sides: torch.Tensor,
               actions: torch.Tensor):
    """(B, N, N) int8 signed parent grids, (B,) sides (+-1), (B,) actions
    in [0, N*N] -> (new grids (B, N, N) int8, illegal (B, N*N+1) bool for
    the next mover).  CUDA tensors run the kernel, CPU tensors the plain
    version; there is no fallback from CUDA to the plain version.  The
    launch does not synchronise: a hit iteration cap sets the error word,
    which ``errors.check_kernel_errors`` reads."""
    _check(stones, sides, actions)
    if not stones.is_cuda:
        return step_legal_plain(stones, sides, actions)
    from sejonggo_torch.ops._build import MAX_SIZE

    b, n, _ = stones.shape
    if not 2 <= n <= MAX_SIZE:
        raise ValueError(f"gostep kernel takes 2 <= N <= {MAX_SIZE}, got N={n}")
    stones = stones.contiguous()
    sides = sides.to(torch.int8).contiguous()
    actions = actions.to(torch.int32).contiguous()
    out_stones = torch.empty_like(stones)
    out_illegal = torch.empty((b, n * n + 1), dtype=torch.bool,
                              device=stones.device)
    if b == 0:
        return out_stones, out_illegal
    _launch(stones, sides, actions, out_stones, out_illegal,
            errors.error_word(stones.device))
    step_legal.launches += 1
    return out_stones, out_illegal


step_legal.launches = 0
