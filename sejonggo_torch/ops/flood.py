"""Batched flood fill: the CUDA kernel ``csrc/flood.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``sejonggo_tpu/ops/flood.py``
(``flood_fixpoint_pallas``): the region reachable from ``seed & allowed``
by 4-neighbour steps inside ``allowed``, iterated to a fixpoint.  The
engine's env step (``goenv.engine.step_batch``) calls ``flood_fixpoint``
four times per move.

``flood_fixpoint`` dispatches on the tensors' device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes ``flood_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from sejonggo_torch.ops import errors


def dilate(m: torch.Tensor) -> torch.Tensor:
    """4-neighbourhood dilation of a (..., N, N) bool mask: a point is set
    when any orthogonal neighbour is set (off-board counts as unset)."""
    out = torch.zeros_like(m)
    out[..., :-1, :] |= m[..., 1:, :]
    out[..., 1:, :] |= m[..., :-1, :]
    out[..., :, :-1] |= m[..., :, 1:]
    out[..., :, 1:] |= m[..., :, :-1]
    return out


def flood_plain(seed: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """Grow ``seed & allowed`` within ``allowed`` to the fixpoint (the
    whole batch iterates together, as sejonggo_tpu.goenv.engine._flood).

    A region of an N x N board is reached within N*N - 1 steps, so the
    loop is capped at N*N + 1 iterations and raises if it ever runs out.
    """
    cur = seed & allowed
    n = seed.shape[-1]
    for _ in range(n * n + 1):
        nxt = cur | (allowed & dilate(cur))
        if torch.equal(nxt, cur):
            return cur
        cur = nxt
    raise RuntimeError("flood_plain did not converge within N*N+1 steps")


def _check_masks(seed: torch.Tensor, allowed: torch.Tensor) -> None:
    if seed.dtype != torch.bool or allowed.dtype != torch.bool:
        raise TypeError(f"flood_fixpoint takes bool masks, got {seed.dtype} "
                        f"and {allowed.dtype}")
    if seed.dim() != 3 or seed.shape != allowed.shape \
            or seed.shape[1] != seed.shape[2]:
        raise ValueError(f"flood_fixpoint takes two (B, N, N) masks, got "
                         f"{tuple(seed.shape)} and {tuple(allowed.shape)}")
    if seed.device != allowed.device:
        raise ValueError("seed and allowed lie on different devices")


def _launch(seed, allowed, out, err) -> None:
    """Launch the kernel on the current stream; raises if CUDA refused
    the launch.  Counts nothing: ``flood_fixpoint`` is the wrapper."""
    from sejonggo_torch.ops import _build

    b, n, _ = seed.shape
    code = _build.load_library().sejonggo_flood(
        ctypes.c_void_p(seed.data_ptr()), ctypes.c_void_p(allowed.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(err.data_ptr()),
        b, n, ctypes.c_void_p(torch.cuda.current_stream(seed.device).cuda_stream))
    if code != 0:
        raise RuntimeError(f"flood kernel launch failed: CUDA error {code}")


def flood_fixpoint(seed: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool masks -> (B, N, N) bool reached region.

    CUDA tensors run the hand-written kernel (one thread per board,
    bitboards in registers, see csrc/flood.cu); CPU tensors run
    ``flood_plain``.  There is no fallback from CUDA to the plain version.
    The launch does not synchronise: a hit iteration cap sets the error
    word, which ``errors.check_kernel_errors`` reads.
    """
    _check_masks(seed, allowed)
    if not seed.is_cuda:
        return flood_plain(seed, allowed)
    from sejonggo_torch.ops._build import MAX_SIZE

    b, n, _ = seed.shape
    if not 2 <= n <= MAX_SIZE:
        raise ValueError(f"flood kernel takes 2 <= N <= {MAX_SIZE}, got N={n}")
    seed = seed.contiguous()
    allowed = allowed.contiguous()
    out = torch.empty_like(seed)
    if b == 0:
        return out
    _launch(seed, allowed, out, errors.error_word(seed.device))
    flood_fixpoint.launches += 1
    return out


flood_fixpoint.launches = 0
