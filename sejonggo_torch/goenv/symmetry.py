"""D4 (dihedral) symmetries as gather tables (port of
sejonggo_tpu/goenv/symmetry.py).

Indices 0..6 are the reference's SYMMETRIES (symmetry.py:117-125), the
right diagonal is index 7.  A stone of the original board at (x, y)
appears at T(x, y) on the transformed board; the policy table maps the
net's output on the transformed board back to original move order.  The
inverses of rotation 90/270 follow the JAX package, which fixed the
reference's swapped pair.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_TRANSFORMS = (
    ("identity", lambda x, y, n: (x, y)),
    ("left_diagonal", lambda x, y, n: (y, x)),
    ("vertical_axis", lambda x, y, n: (n - 1 - x, y)),
    ("horizontal_axis", lambda x, y, n: (x, n - 1 - y)),
    ("rotation_90", lambda x, y, n: (y, n - 1 - x)),
    ("rotation_180", lambda x, y, n: (n - 1 - x, n - 1 - y)),
    ("rotation_270", lambda x, y, n: (n - 1 - y, x)),
    ("right_diagonal", lambda x, y, n: (n - 1 - y, n - 1 - x)),
)

NUM_SYMMETRIES = len(_TRANSFORMS)
# Number the reference draws from (symmetry.py:117-128).
NUM_REFERENCE_SYMMETRIES = 7


@functools.lru_cache(maxsize=None)
def symmetry_tables(size: int):
    """(board_perm (S, N*N), policy_perm (S, N*N+1)) int64 numpy tables:
    transformed_flat = original_flat[board_perm[s]] and
    policy_orig = policy_net[policy_perm[s]] (pass fixed).  Read-only."""
    n = size
    num = n * n
    board_perm = np.zeros((NUM_SYMMETRIES, num), np.int64)
    policy_perm = np.zeros((NUM_SYMMETRIES, num + 1), np.int64)
    for s, (_, t) in enumerate(_TRANSFORMS):
        for y in range(n):
            for x in range(n):
                tx, ty = t(x, y, n)
                board_perm[s, ty * n + tx] = y * n + x
                policy_perm[s, y * n + x] = ty * n + tx
        policy_perm[s, num] = num
    board_perm.flags.writeable = False
    policy_perm.flags.writeable = False
    return board_perm, policy_perm


@functools.lru_cache(maxsize=None)
def _tables_on(size: int, device: torch.device):
    bperm, pperm = symmetry_tables(size)
    return (torch.as_tensor(bperm.copy(), device=device),
            torch.as_tensor(pperm.copy(), device=device))


def _gather_last(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Permute the last axis of ``x`` by ``perm``: (L,) for all rows, or
    (B, L) with one row per leading batch entry of ``x``."""
    if perm.dim() == 1:
        return x.index_select(-1, perm)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (perm.shape[-1],)
    return torch.gather(x, -1, perm.view(shape).expand(*x.shape[:-1], -1))


def transform_flat(x: torch.Tensor, sym, size: int) -> torch.Tensor:
    """Permute the flat spatial last axis (size*size) of ``x`` by
    symmetry ``sym``: an int (the whole batch, as
    symmetry.transform_flat_switch) or a (B,) tensor (one per leading
    entry, as symmetry.transform_flat_pergame)."""
    bperm, _ = _tables_on(size, x.device)
    return _gather_last(x, bperm[sym] if isinstance(sym, int)
                        else bperm[sym.to(x.device)])


def inverse_policy(policies: torch.Tensor, sym) -> torch.Tensor:
    """(..., A) policies on transformed boards -> original move order;
    ``sym`` an int or a (B,) tensor as in ``transform_flat``."""
    n = int(round((policies.shape[-1] - 1) ** 0.5))
    _, pperm = _tables_on(n, policies.device)
    return _gather_last(policies, pperm[sym] if isinstance(sym, int)
                        else pperm[sym.to(policies.device)])


def transform_boards_batch(boards: torch.Tensor, sym_ids: torch.Tensor):
    """(B, N, N, C) boards, (B,) symmetry ids -> transformed batch."""
    b, n, _, c = boards.shape
    flat = boards.reshape(b, n * n, c).transpose(1, 2)   # (B, C, N*N)
    out = transform_flat(flat, sym_ids, n)
    return out.transpose(1, 2).reshape(boards.shape)


def inverse_policy_batch(policies: torch.Tensor, sym_ids: torch.Tensor):
    """(B, A) policies on transformed boards -> original move order."""
    return inverse_policy(policies, sym_ids)
