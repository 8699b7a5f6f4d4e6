"""Batched Go heuristics for the model-free michi engine (port of
sejonggo_tpu/search/heuristics.py).

Reference counterpart: mcts1/go_heuristics.py — 3x3 playout patterns
(pat3src/pat3_expand :29-107,266-290), common-fate-graph distances
(cfg_distances :215-236), line height / empty area (:239-250),
atari/capture analysis incl. ladder reading (fix_atari :116-213), and
eye detection (is_eyeish/is_eye :420-456).  Each heuristic is computed
for every point of a batch of boards at once.

Boards are (B, N, N, 17) int8 plane boards (plane 0 = side-to-move
stones, plane 1 = opponent stones); masks are (B, N, N) bool, from the
side-to-move perspective.  Every function takes the leading batch axis.

What the JAX package computes, not how: every group fact comes from one
same-colour reachability closure of each board (``closure_analysis``:
ceil(log2 N^2) boolean squarings of an (N^2, N^2) matrix, one batched
matmul each — float32 on the CPU, bfloat16 on the card; a 0/1 product
thresholded at 0.5 is exact in both).  Liberty counts and group sizes
are int32 sums of booleans, never a product's value (a bf16 output
cannot hold 361 exactly).  The JAX package's sort-based fixpoints
(``group_lib_tops``, ``group_labels``, ``self_atari_mask``,
``capture_moves``) read the same facts off that closure, and
``cfg_distances`` relaxes along it in ``cap`` rounds.  The only loop
that depends on the data is the ladder reader: a batched loop over every
read, frozen lanes keep their state, capped at 2 N^2 iterations as in
the JAX package, and it reads the host once every two iterations to end
when every lane is done.  Its moves go through ``step_legal`` (the
gostep kernel on the card), its group floods through ``flood_fixpoint``
(the flood kernel).

Deliberate deviations of the JAX package from the reference, kept here:
- ladder reading uses a deterministic greedy attacker instead of the
  reference's exhaustive two-branch recursion (read_ladder_attack
  go_heuristics.py:137-150);
- self-atari is "resulting group has exactly one liberty" (with
  snapback awareness).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from sejonggo_torch.goenv.engine import _shift_fill, signed_stones
from sejonggo_torch.ops import gostep
from sejonggo_torch.ops.flood import dilate as _dilate
from sejonggo_torch.ops.flood import flood_fixpoint

# ---------------------------------------------------------------------------
# 3x3 playout patterns (reference pat3src go_heuristics.py:29-71)
#
# Pattern alphabet: 'X' own stone, 'O' opponent stone, '.' empty,
# ' ' off-board, '?' anything, 'x' not-own, 'o' not-opponent.  A point
# matches when its 3x3 neighborhood matches any pattern under any of
# the 8 dihedral transforms and either color orientation; the closure
# is one 4^8-entry lookup table indexed by the base-4 neighborhood code.

_PAT3_SRC = [
    # hane patterns
    ("XOX", "...", "???"),   # enclosing hane
    ("XO.", "...", "?.?"),   # non-cutting hane
    ("XO?", "X..", "x.?"),   # magari
    # generic attachment
    (".O.", "X..", "..."),   # katatsuke / diagonal attachment
    # cut patterns
    ("XO?", "O.o", "?o?"),   # unprotected cut
    ("XO?", "O.X", "???"),   # peeped cut
    ("?X?", "O.O", "ooo"),   # de
    ("OX?", "o.O", "???"),   # cut keima
    # side (edge) patterns
    ("X.?", "O.?", "   "),   # chase
    ("OX?", "X.O", "   "),   # block side cut
    ("?X?", "x.O", "   "),   # block side connection
    ("?XO", "x.x", "   "),   # sagari
    ("?OX", "X.O", "   "),   # side cut
]

# symbol codes used in neighborhood encodings
_EMPTY, _OWN, _OPP, _EDGE = 0, 1, 2, 3

# allowed-symbol bitmask per pattern character (bit i = symbol i allowed)
_CHAR_MASK = {
    ".": 1 << _EMPTY,
    "X": 1 << _OWN,
    "O": 1 << _OPP,
    " ": 1 << _EDGE,
    "?": 0b1111,
    "x": 0b1111 & ~(1 << _OWN),
    "o": 0b1111 & ~(1 << _OPP),
}
_SWAP = {"X": "O", "O": "X", "x": "o", "o": "x"}

# the 8 non-center offsets, row-major — the order of the code's digits
_NBR8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _dihedral_variants(rows):
    """All 8 rotations/reflections of a 3-row pattern."""
    g = [list(r) for r in rows]
    out = []
    for _ in range(4):
        g = [[g[2 - c][r] for c in range(3)] for r in range(3)]  # rot90
        out.append(g)
        out.append(g[::-1])  # vertical flip
    return out


@lru_cache(maxsize=1)
def _pat3_table_np() -> np.ndarray:
    """(65536,) bool: neighborhood-code -> matches any pat3.

    Code: the 8 non-center points of the 3x3 square in row-major order
    (NW, N, NE, W, E, SW, S, SE), base-4 little-endian, symbols
    (_EMPTY, _OWN, _OPP, _EDGE).  Center is the empty candidate point.
    """
    masks = []
    for pat in _PAT3_SRC:
        for rows in (pat, tuple("".join(_SWAP.get(ch, ch) for ch in r)
                                for r in pat)):
            for var in _dihedral_variants(rows):
                flat = [ch for row in var for ch in row]
                if not (_CHAR_MASK[flat[4]] >> _EMPTY) & 1:
                    continue  # center cannot host a move
                masks.append([_CHAR_MASK[ch]
                              for i, ch in enumerate(flat) if i != 4])
    masks = np.unique(np.asarray(masks, np.uint8), axis=0)  # (P, 8)

    codes = np.arange(4 ** 8, dtype=np.int64)
    syms = np.stack([(codes >> (2 * k)) & 3 for k in range(8)], 1)  # (C, 8)
    table = np.zeros(4 ** 8, bool)
    for m in masks:
        table |= np.all((m[None, :] >> syms) & 1 == 1, axis=1)
    return table


_TABLES: dict = {}


def _device_table(name: str, make, device) -> torch.Tensor:
    """A constant table, copied to each device once."""
    key = (name, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(make()).to(device)
    return _TABLES[key]


def _planes(boards: torch.Tensor):
    return boards[..., 0] == 1, boards[..., 1] == 1


def neighbors8(v: torch.Tensor, fill) -> torch.Tensor:
    """(B, N, N) -> (B, 8, N, N): each point's 8 neighbours in _NBR8
    order, ``fill`` off the board (one padded copy, eight views)."""
    b, n = v.shape[0], v.shape[-1]
    p = v.new_full((b, n + 2, n + 2), fill)
    p[:, 1:-1, 1:-1] = v
    return torch.stack([p[:, 1 + dy:1 + dy + n, 1 + dx:1 + dx + n]
                        for dy, dx in _NBR8], 1)


def neighborhood_codes(own: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int64 base-4 code of each point's 8 neighbours."""
    sym = own.to(torch.int64) * _OWN + opp.to(torch.int64) * _OPP
    shifts = _device_table("shifts", lambda: (
        2 * np.arange(8, dtype=np.int64))[:, None, None], own.device)
    return (neighbors8(sym, _EDGE) << shifts).sum(1)


def pat3_mask(boards: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool: empty points whose 3x3 neighborhood matches a pat3
    (reference `neighborhood_33(...) in pat3set`, go_heuristics.py:108)."""
    return pat3_mask_from(*_planes(boards))


def pat3_mask_from(own: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """pat3_mask from raw (B, N, N) own/opp masks (stone-grid playouts)."""
    table = _device_table("pat3", _pat3_table_np, own.device)
    return table[neighborhood_codes(own, opp)] & ~(own | opp)


# ---------------------------------------------------------------------------
# locality / shape heuristics


def line_height_grid(n: int, device=None) -> torch.Tensor:
    """(N, N) int32 line number above the nearest edge (0-indexed;
    reference line_height go_heuristics.py:239-242)."""
    i = torch.arange(n, dtype=torch.int32, device=device)
    d = torch.minimum(i, n - 1 - i)
    return torch.minimum(d[:, None], d[None, :])


def empty_area_mask(boards: torch.Tensor, dist: int = 3) -> torch.Tensor:
    """(B, N, N) bool: empty points with no stone within `dist` steps
    through empty space (reference empty_area go_heuristics.py:245-250)."""
    own, opp = _planes(boards)
    stones = own | opp
    empty = ~stones
    bad = _dilate(stones)
    for _ in range(dist - 1):
        bad = bad | _dilate(bad & empty)
    return empty & ~bad


def own_true_eye_mask(boards: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool: single-point true eyes of the side to move — all
    on-board orthogonal neighbors own, and not falsified by diagonals
    (>= 2 opponent diagonals, edge counts as one; reference is_eye
    go_heuristics.py:436-456)."""
    return own_true_eye_from(*_planes(boards))


_ORTH, _DIAG = [1, 3, 4, 6], [0, 2, 5, 7]   # indices into _NBR8


def _edge_diagonal_np(n: int) -> np.ndarray:
    """(N, N) int32: 1 where a diagonal neighbour is off the board."""
    d = np.zeros((n, n), np.int32)
    d[0, :] = d[-1, :] = d[:, 0] = d[:, -1] = 1
    return d


def own_true_eye_from(own: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """own_true_eye_mask from raw (B, N, N) own/opp masks."""
    n = own.shape[-1]
    eyeish = neighbors8(own, True)[:, _ORTH].all(1)
    false_count = neighbors8(opp, False)[:, _DIAG].sum(1) + _device_table(
        f"edge{n}", lambda: _edge_diagonal_np(n), own.device)
    return ~(own | opp) & eyeish & (false_count < 2)


# ---------------------------------------------------------------------------
# reachability closure: every group fact of a board


@lru_cache(maxsize=8)
def _adjacency_np(n: int) -> np.ndarray:
    """(nn, nn) bool 4-neighborhood adjacency of board points."""
    nn = n * n
    a = np.zeros((nn, nn), bool)
    for y in range(n):
        for x in range(n):
            for dy, dx in _DIRS:
                yy, xx = y + dy, x + dx
                if 0 <= yy < n and 0 <= xx < n:
                    a[y * n + x, yy * n + xx] = True
    return a


def _adjacency(n: int, device) -> torch.Tensor:
    return _device_table(f"adj{n}", lambda: _adjacency_np(n), device)


def _eye(nn: int, device) -> torch.Tensor:
    return _device_table(f"eye{nn}", lambda: np.eye(nn, dtype=bool), device)


def _mm_dtype(t: torch.Tensor) -> torch.dtype:
    """Boolean products run as float32 matmuls on the CPU and bfloat16 on
    the card; a sum of 0/1 products is >= 1 or 0 in both, so clamping it
    at 1 (or thresholding it at 0.5) is exact."""
    return torch.bfloat16 if t.is_cuda else torch.float32


def _bmat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean matmul (..., p, q) @ (..., q, r) -> bool."""
    dt = _mm_dtype(a)
    return torch.matmul(a.to(dt), b.to(dt)) > 0.5


def _reach(same: torch.Tensor, n: int) -> torch.Tensor:
    """(B, nn, nn) reachability through ``same`` steps, self included, as
    0/1 values of the matmul dtype."""
    nn = n * n
    m = ((_adjacency(n, same.device) & same)
         | _eye(nn, same.device)).to(_mm_dtype(same))
    for _ in range(math.ceil(math.log2(nn))):
        m = torch.matmul(m, m).clamp_(max=1)
    return m


class GroupAnalysis(NamedTuple):
    """Per-board group facts from one reachability closure (B boards,
    nn = N*N, flat indexing).

      own, opp, empty: (B, N, N) bool
      reach:     (B, nn, nn) bool — same-color reachability incl. self
      libset:    (B, nn, nn) bool — libset[p, q]: q is a liberty of p's
                 group (rows of empty p: p's own adjacent empties)
      lib_count: (B, nn) int32 — distinct liberties of p's group (stones)
      size:      (B, nn) int32 — stones in p's group (stones; else 0)
    """

    own: torch.Tensor
    opp: torch.Tensor
    empty: torch.Tensor
    reach: torch.Tensor
    libset: torch.Tensor
    lib_count: torch.Tensor
    size: torch.Tensor


def closure_analysis(own: torch.Tensor, opp: torch.Tensor) -> GroupAnalysis:
    """GroupAnalysis of B boards from their (B, N, N) own/opp masks."""
    b, n = own.shape[0], own.shape[-1]
    nn = n * n
    empty = ~(own | opp)
    of, pf, ef = own.reshape(b, nn), opp.reshape(b, nn), empty.reshape(b, nn)
    color = of.to(torch.int8) - pf.to(torch.int8)
    same = (color[:, :, None] == color[:, None, :]) & (color != 0)[:, :, None]
    mf = _reach(same, n)
    libset = torch.matmul(mf, (_adjacency(n, own.device)
                               & ef[:, None, :]).to(mf.dtype)) > 0.5
    m = mf > 0.5
    stones = of | pf
    lib_count = (libset.sum(-1) * stones).to(torch.int32)
    size = ((m & stones[:, None, :]).sum(-1) * stones).to(torch.int32)
    return GroupAnalysis(own, opp, empty, m, libset, lib_count, size)


def self_atari_from(a: GroupAnalysis) -> torch.Tensor:
    """(B, N, N) bool: empty points where a side-to-move stone would
    leave its merged group with exactly one distinct liberty (the point's
    empty neighbours, the liberties of adjacent own groups, the points of
    adjacent opponent stones it captures — snapback stays self-atari —
    minus the point itself); capturing >= 2 stones is never self-atari."""
    b, n = a.own.shape[0], a.own.shape[-1]
    nn = n * n
    adj = _adjacency(n, a.own.device)
    of, pf, ef = (a.own.reshape(b, nn), a.opp.reshape(b, nn),
                  a.empty.reshape(b, nn))
    cand = (adj & ef[:, None, :]) | _bmat(adj & of[:, None, :], a.libset)
    cand = cand & ~_eye(nn, a.own.device)
    opp_atari = pf & (a.lib_count == 1)
    # captures_here[x, q]: adjacent opp stone q in atari whose single
    # liberty is x — its point becomes a liberty (snapback candidate)
    captures_here = adj & opp_atari[:, None, :] & a.libset.transpose(1, 2)
    relief = (captures_here.to(torch.int32) * a.size[:, None, :]).sum(-1)
    distinct = (cand | captures_here).sum(-1)
    return (a.empty & (distinct <= 1).reshape(b, n, n)
            & (relief < 2).reshape(b, n, n))


def capture_moves_from(a: GroupAnalysis, include_escapes: bool = True,
                       self_atari: Optional[torch.Tensor] = None,
                       with_many: bool = True):
    """(suggest, many): (B, N, N) bool.  ``suggest`` marks the liberties
    of opponent groups in atari and, with ``include_escapes``, the
    liberty of an own group in atari where the escape is not self-atari
    (reference fix_atari go_heuristics.py:176-213); ``many`` marks the
    suggestions whose group has > 1 stones (PRIOR_CAPTURE_MANY vs _ONE,
    tree_node.py:43-51); None without ``with_many`` (the playout)."""
    b, n = a.own.shape[0], a.own.shape[-1]
    nn = n * n
    of, pf = a.own.reshape(b, nn), a.opp.reshape(b, nn)
    big = a.size > 1
    opp_atari = pf & (a.lib_count == 1)
    # an atari group's libset row is one-hot at its single liberty
    suggest = (opp_atari[:, :, None] & a.libset).any(1)
    many = ((opp_atari & big)[:, :, None] & a.libset).any(1) if with_many \
        else None
    if include_escapes:
        sa = (self_atari_from(a) if self_atari is None
              else self_atari).reshape(b, nn)
        own_atari = of & (a.lib_count == 1)
        valid = own_atari[:, :, None] & a.libset & ~sa[:, None, :]
        suggest = suggest | valid.any(1)
        if with_many:
            many = many | (valid & big[:, :, None]).any(1)
    suggest = suggest.reshape(b, n, n) & a.empty
    return suggest, (many.reshape(b, n, n) & a.empty if with_many else None)


def illegal_from(a: GroupAnalysis, ko_pt: torch.Tensor) -> torch.Tensor:
    """The engine's illegality from a closure analysis: (B, N*N+1) bool,
    pass legal.  ko_pt: (B, N, N) bool simple-ko candidate."""
    b, n = a.own.shape[0], a.own.shape[-1]
    ko = ko_pt & (ko_pt.sum((-2, -1), keepdim=True) == 1)
    opp_capturable = a.opp & (a.lib_count == 1).reshape(b, n, n)
    breath = _dilate(a.empty) | _dilate(opp_capturable)
    legal = a.empty & ~ko & breath
    return torch.cat([~legal.reshape(b, n * n),
                      torch.zeros((b, 1), dtype=torch.bool,
                                  device=legal.device)], 1)


def board_ko_point(boards: torch.Tensor) -> torch.Tensor:
    """(B, N, N) simple-ko candidate read off the history planes (an own
    stone one position ago that is gone now), as the engine reads it."""
    return (boards[..., 2].to(torch.int32) - boards[..., 0].to(torch.int32)) == 1


# ---------------------------------------------------------------------------
# the JAX package's sort-based group functions, read off the closure


def _smallest(mask: torch.Tensor, k: int) -> torch.Tensor:
    """(..., nn) bool -> (..., k) int32: the k smallest set indices, nn
    where fewer are set."""
    nn = mask.shape[-1]
    iota = torch.arange(nn, dtype=torch.int32, device=mask.device)
    return torch.where(mask, iota, nn).sort(-1).values[..., :k]


def group_lib_tops(stones: torch.Tensor, empty: torch.Tensor,
                   k: int = 3) -> torch.Tensor:
    """(B, k, N, N) int32: per stone, the k smallest distinct flat indices
    of its group's liberties (N*N pad and off the stones)."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    sf, ef = stones.reshape(b, nn), empty.reshape(b, nn)
    m = _reach(sf[:, :, None] & sf[:, None, :], n)
    libset = _bmat(m, _adjacency(n, stones.device) & ef[:, None, :])
    tops = torch.where(sf[:, :, None], _smallest(libset, k), nn)
    return tops.transpose(1, 2).reshape(b, k, n, n)


def lib_count_capped(tops: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int32 distinct-liberty count (capped at k) from tops."""
    n = tops.shape[-1]
    return (tops < n * n).sum(1).to(torch.int32)


def group_labels(stones: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int32: per stone, the minimum flat index in its group
    (N*N for non-stones) — a stable group id."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    sf = stones.reshape(b, nn)
    m = _reach(sf[:, :, None] & sf[:, None, :], n) > 0.5
    first = _smallest(m, 1)[..., 0]
    return torch.where(sf, first, nn).reshape(b, n, n)


def group_sizes(stones: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int32 stone count of each stone's group (0 elsewhere)."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    lab = labels.reshape(b, nn).long()
    counts = torch.zeros((b, nn + 1), dtype=torch.int32, device=stones.device)
    counts.scatter_add_(1, lab, stones.reshape(b, nn).to(torch.int32))
    return torch.where(stones, torch.gather(counts, 1, lab).reshape(b, n, n), 0)


def self_atari_mask(boards: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool: self_atari_from of the boards' closure analysis."""
    return self_atari_from(closure_analysis(*_planes(boards)))


def capture_moves(boards: torch.Tensor, include_escapes: bool = True):
    """(suggest, many) of the boards: capture_moves_from their closure
    analysis."""
    return capture_moves_from(closure_analysis(*_planes(boards)),
                              include_escapes)


# ---------------------------------------------------------------------------
# common-fate-graph distances


def cfg_distances(boards: torch.Tensor, last_action: torch.Tensor,
                  cap: int = 4,
                  analysis: Optional[GroupAnalysis] = None) -> torch.Tensor:
    """(B, N, N) int32 common-fate-graph distance from ``last_action``
    ((B,) flat indices): a step within a same-colored chain is free, any
    other step costs 1 (reference cfg_distances go_heuristics.py:215-236);
    clamped to ``cap``, all-``cap`` for a pass.

    The JAX package relaxes to the fixpoint; here each of ``cap`` rounds
    takes one costed step and then the minimum over each chain (the
    closure's reach rows), which reaches the same capped shortest paths."""
    own, opp = _planes(boards)
    a = analysis if analysis is not None else closure_analysis(own, opp)
    b, n = own.shape[0], own.shape[-1]
    nn = n * n
    flat = torch.arange(nn, dtype=torch.int32, device=own.device)
    dist = torch.where(flat[None] == last_action.to(torch.int32)[:, None],
                       0, cap).to(torch.int32)

    def chain_min(d):
        return torch.where(a.reach, d[:, None, :], cap).amin(-1).to(torch.int32)

    dist = chain_min(dist)
    for _ in range(cap):
        grid = dist.reshape(b, n, n)
        step = grid
        for dy, dx in _DIRS:
            step = torch.minimum(step, torch.clamp(
                _shift_fill(grid, dy, dx, cap) + 1, max=cap))
        dist = chain_min(step.reshape(b, nn))
    return dist.reshape(b, n, n)


# ---------------------------------------------------------------------------
# ladder reading (greedy deterministic variant of read_ladder_attack)

_LADDER_MAX_TARGETS = 4  # 2-liberty groups read per board
_LADDER_CHECK_EVERY = 2  # ladder iterations between host reads


def _freedom(empty: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(L,) number of empty orthogonal neighbors of flat points idx."""
    b, n = empty.shape[0], empty.shape[-1]
    e = empty.to(torch.int32)
    cnt = sum(_shift_fill(e, dy, dx, 0) for dy, dx in _DIRS)
    return torch.gather(cnt.reshape(b, n * n), 1, idx.long()[:, None])[:, 0]


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[l, idx[l]] for (L, M) x and (L,) idx."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def _ladder_reads_capture(grids: torch.Tensor, sides: torch.Tensor,
                          seeds: torch.Tensor, first_libs: torch.Tensor,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """(L,) bool: the side to move of each (N, N) signed grid captures
    the opponent group containing flat point ``seeds`` (exactly 2
    liberties) by attacking at ``first_libs``.

    Greedy variant of the reference's exhaustive 2-liberty solver
    (read_ladder_attack go_heuristics.py:137-150): the defender always
    extends on its last liberty; the attacker blocks the liberty with
    more empty neighbors.  Countercaptures (an attacker group in atari
    next to the chased group) end the ladder as an escape (fix_atari's
    countercapture scan, go_heuristics.py:182-192).  All L reads run as
    one batched loop of at most 2 N^2 iterations; a finished read keeps
    its state."""
    step_legal = gostep.step_legal
    lanes, n = grids.shape[0], grids.shape[-1]
    inf = n * n
    dev = grids.device
    rows = torch.arange(lanes, device=dev)
    iota = torch.arange(inf, device=dev)
    seedm = (iota[None] == seeds[:, None]).reshape(lanes, n, n)
    attacker = sides.to(torch.int8)
    side = -attacker                              # the defender
    bd, ill = step_legal(grids, attacker, first_libs.to(torch.int32))
    alive = bd.reshape(lanes, inf)[rows, seeds.long()] == side
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    captured = torch.zeros_like(done)
    pass_a = torch.full((lanes,), inf, dtype=torch.int32, device=dev)
    iters = 0
    for it in range(2 * inf):
        if it and it % _LADDER_CHECK_EVERY == 0 and bool(done.all()):
            break
        iters += 1
        # defender to move; the target group is bd's own side
        own = bd == side[:, None, None]
        opp = bd == attacker[:, None, None]
        a = closure_analysis(own, opp)
        own_f = own.reshape(lanes, inf)
        at_seed = _at(own_f, seeds)
        grp = a.reach[rows, seeds.long()] & own_f
        tops = _smallest(a.libset[rows, seeds.long()] & at_seed[:, None], 3)
        nlibs = (tops < inf).sum(-1)
        atk_atari = opp.reshape(lanes, inf) & (a.lib_count == 1)
        counter = (_dilate(grp.reshape(lanes, n, n))
                   & atk_atari.reshape(lanes, n, n)).any((-2, -1))
        escaped = counter | (nlibs >= 2)
        lib0 = tops[:, 0]
        legal_def = ~_at(ill, lib0.clamp(0, inf))
        captured_now = ~escaped & ~legal_def
        # a finished read steps a pass: its result is dropped
        a1 = torch.where(legal_def & ~done, lib0, pass_a)
        bd1, ill1 = step_legal(bd, side, a1)
        # attacker to move; the target group is now the opponent side
        def1 = bd1 == side[:, None, None]
        empty1 = bd1 == 0
        grp1 = flood_fixpoint(seedm & def1, def1)
        tops1 = _smallest((_dilate(grp1) & empty1).reshape(lanes, inf), 3)
        nlibs1 = (tops1 < inf).sum(-1)
        escaped = escaped | (nlibs1 >= 3)
        captured_now = captured_now | (~escaped & (nlibs1 <= 1))
        f0 = _freedom(empty1, tops1[:, 0].clamp(0, inf - 1))
        f1 = _freedom(empty1, tops1[:, 1].clamp(0, inf - 1))
        pick = torch.where(f1 > f0, tops1[:, 1], tops1[:, 0])
        other = torch.where(f1 > f0, tops1[:, 0], tops1[:, 1])
        pick = torch.where(_at(ill1, pick.clamp(0, inf)), other, pick)
        atk_fail = _at(ill1, pick.clamp(0, inf))
        escaped = escaped | (~captured_now & atk_fail)
        stop = done | escaped | captured_now
        bd2, ill2 = step_legal(bd1, attacker,
                               torch.where(stop, pass_a, pick.clamp(0, inf)))
        captured = torch.where(done, captured, captured_now)
        bd = torch.where(stop[:, None, None], bd, bd2)
        ill = torch.where(stop[:, None], ill, ill2)
        done = stop
    if stats is not None:
        stats["ladder_calls"] = stats.get("ladder_calls", 0) + 1
        stats["ladder_iters"] = stats.get("ladder_iters", 0) + iters
    return alive & captured


def ladder_capture_moves(boards: torch.Tensor,
                         analysis: Optional[GroupAnalysis] = None,
                         stats: Optional[dict] = None):
    """(suggest, many): (B, N, N) bool moves that capture an opponent
    two-liberty group in a working ladder (fix_atari's twolib_test path,
    go_heuristics.py:163-173).  Reads up to _LADDER_MAX_TARGETS groups
    per board (the smallest group ids), both initial attack points each,
    greedy afterwards.  Only the reads that can start (a target and a
    legal first attack) run, gathered with one host read.  ``stats``
    counts the reads' batched calls and iterations."""
    b, n = boards.shape[0], boards.shape[-3]
    inf = n * n
    dev = boards.device
    own, opp = _planes(boards)
    a = analysis if analysis is not None else closure_analysis(own, opp)
    pf = opp.reshape(b, inf)
    iota = torch.arange(inf, dtype=torch.int32, device=dev)
    tops = torch.where(pf[:, :, None], _smallest(a.libset, 3), inf)
    lib_count = (tops < inf).sum(-1)
    label = torch.where(pf, _smallest(a.reach, 1)[..., 0], inf)
    cand = pf & (lib_count == 2) & (a.size > 1)
    # one seed per group: its smallest stone, i.e. its label
    leader = cand & (label == iota[None])
    targets = _smallest(leader, _LADDER_MAX_TARGETS)          # (B, T)
    libs = torch.stack(
        [torch.gather(tops[..., w], 1, targets.clamp(0, inf - 1).long())
         for w in range(2)], 1)                                # (B, 2, T)
    seeds = targets[:, None, :].expand_as(libs)
    illegal = illegal_from(a, board_ko_point(boards))
    valid = (seeds < inf) & (libs < inf) & ~torch.gather(
        illegal, 1, libs.clamp(0, inf).reshape(b, -1).long()).reshape(libs.shape)
    works = torch.zeros_like(valid)
    lane = valid.reshape(-1).nonzero()[:, 0]
    if lane.numel():
        bi = lane // valid[0].numel()
        grids = signed_stones(boards)[bi]
        sides = boards[bi, 0, 0, 16]
        got = _ladder_reads_capture(grids, sides, seeds.reshape(-1)[lane],
                                    libs.reshape(-1)[lane], stats)
        works = works.reshape(-1).index_put((lane,), got).reshape(valid.shape)
    hit = torch.where(works, libs, inf).reshape(b, -1).long()
    big = (torch.gather(a.size, 1, seeds.clamp(0, inf - 1).reshape(b, -1).long())
           > 1)
    suggest = torch.zeros((b, inf + 1), dtype=torch.bool, device=dev)
    suggest.scatter_(1, hit, True)
    many = torch.zeros((b, inf + 1), dtype=torch.int32, device=dev)
    many.scatter_reduce_(1, hit, big.to(torch.int32), "amax")
    return (suggest[:, :inf].reshape(b, n, n),
            many[:, :inf].reshape(b, n, n) > 0)
