"""Large-scale spatial pattern subsystem (pachi-format .spat/.prob files);
a numpy copy of sejonggo_tpu/search/patterns.py.

Reference counterpart: mcts1/go_heuristics.py:300-366 —
load_spat_patterndict/load_large_patterns parse pachi pattern files,
neighborhood_gridcular yields progressively wider "gridcular"
neighborhood strings in all 8 rotations, and large_pattern_probability
returns the probability of the widest matching pattern; priors scale it
by sqrt * PRIOR_LARGEPATTERN (tree_node.py:81-86).

The reference does not ship the pattern files (conf.py:85-86 names
patterns.spat/patterns.prob but the repo contains neither), so the
whole subsystem is inert there; here it is equally optional — when no
files are loaded every query returns None and the michi priors skip
the term.

Deviations:
- patterns are keyed by the neighborhood string itself instead of
  Python hash() (the reference's hash() is salted per process under
  PYTHONHASHSEED, which only works because it hashes at load AND query
  time in the same process);
- pattern priors are applied at the search ROOT (host-side, where the
  string matcher lives); in-tree expansions get the smallest diameter
  through the table of search/pattern_lut.py.

Boards are (N, N, 17) plane boards, numpy arrays or tensors on any
device.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Optional

import numpy as np

# Gridcular neighborhood offsets by progressively wider diameter
# (public michi/pachi spatial-dictionary ordering; reference
# pat_gridcular_seq go_heuristics.py:12-27 — the ordering is part of
# the .spat file format and must match it byte-for-byte).
GRIDCULAR_SEQ = [
    [(0, 0),
     (0, 1), (0, -1), (1, 0), (-1, 0),
     (1, 1), (-1, 1), (1, -1), (-1, -1)],       # d = 1, 2
    [(0, 2), (0, -2), (2, 0), (-2, 0)],
    [(1, 2), (-1, 2), (1, -2), (-1, -2), (2, 1), (-2, 1), (2, -1), (-2, -1)],
    [(0, 3), (0, -3), (2, 2), (-2, 2), (2, -2), (-2, -2), (3, 0), (-3, 0)],
    [(1, 3), (-1, 3), (1, -3), (-1, -3), (3, 1), (-3, 1), (3, -1), (-3, -1)],
    [(0, 4), (0, -4), (2, 3), (-2, 3), (2, -3), (-2, -3),
     (3, 2), (-3, 2), (3, -2), (-3, -2), (4, 0), (-4, 0)],
    [(1, 4), (-1, 4), (1, -4), (-1, -4), (3, 3), (-3, 3), (3, -3), (-3, -3),
     (4, 1), (-4, 1), (4, -1), (-4, -1)],
    [(0, 5), (0, -5), (2, 4), (-2, 4), (2, -4), (-2, -4),
     (4, 2), (-4, 2), (4, -2), (-4, -2), (5, 0), (-5, 0)],
    [(1, 5), (-1, 5), (1, -5), (-1, -5), (3, 4), (-3, 4), (3, -4), (-3, -4),
     (4, 3), (-4, 3), (4, -3), (-4, -3), (5, 1), (-5, 1), (5, -1), (-5, -1)],
    [(0, 6), (0, -6), (2, 5), (-2, 5), (2, -5), (-2, -5), (4, 4), (-4, 4),
     (4, -4), (-4, -4), (5, 2), (-5, 2), (5, -2), (-5, -2), (6, 0), (-6, 0)],
    [(1, 6), (-1, 6), (1, -6), (-1, -6), (3, 5), (-3, 5), (3, -5), (-3, -5),
     (5, 3), (-5, 3), (5, -3), (-5, -3), (6, 1), (-6, 1), (6, -1), (-6, -1)],
    [(0, 7), (0, -7), (2, 6), (-2, 6), (2, -6), (-2, -6), (4, 5), (-4, 5),
     (4, -5), (-4, -5), (5, 4), (-5, 4), (5, -4), (-5, -4),
     (6, 2), (-6, 2), (6, -2), (-6, -2), (7, 0), (-7, 0)],
]

# the 8 dihedral rotations as ((dy-index, dx-index), (dy-sign, dx-sign))
_ROTATIONS = [((0, 1), (1, 1)), ((0, 1), (-1, 1)),
              ((0, 1), (1, -1)), ((0, 1), (-1, -1)),
              ((1, 0), (1, 1)), ((1, 0), (-1, 1)),
              ((1, 0), (1, -1)), ((1, 0), (-1, -1))]


class PatternStore:
    """Loaded spatial dictionary + probability table.

    spat: neighborhood string -> spatial id (reference
    load_spat_patterndict go_heuristics.py:301-309).
    probs: spatial id -> play probability (load_large_patterns
    :311-323)."""

    def __init__(self):
        self.spat: Dict[str, int] = {}
        self.probs: Dict[int, float] = {}

    def __bool__(self) -> bool:
        return bool(self.spat) and bool(self.probs)

    def load_spat(self, path: str) -> int:
        """Parse a pachi .spat file: `<id> <size> <pattern> <hashes...>`.
        '#'->' ' (off-board) and 'O'->'x' normalization as the
        reference does (go_heuristics.py:307-308)."""
        count = 0
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                neighborhood = parts[2].replace("#", " ").replace("O", "x")
                self.spat[neighborhood] = int(parts[0])
                count += 1
        return count

    def load_probs(self, path: str) -> int:
        """Parse a pachi .prob file: `<prob> <n> <m> (... s:<id> ...)`
        keeping only the spatial feature (go_heuristics.py:316-323)."""
        count = 0
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                p = float(line.split()[0])
                m = re.search(r"s:(\d+)", line)
                if m is not None:
                    self.probs[int(m.group(1))] = p
                    count += 1
        return count


def _host(board) -> np.ndarray:
    if hasattr(board, "detach"):
        board = board.detach().cpu().numpy()
    return np.asarray(board)


def _board_chars(board) -> np.ndarray:
    """(N, N) unicode chars from a plane board: 'X' to move, 'x' opp,
    '.' empty."""
    bn = _host(board)
    own = bn[:, :, 0] == 1
    opp = bn[:, :, 1] == 1
    out = np.full(own.shape, ".", dtype="<U1")
    out[own] = "X"
    out[opp] = "x"
    return out


def gridcular_neighborhoods(chars: np.ndarray, y: int, x: int
                            ) -> Iterator[str]:
    """Yield progressively wider gridcular neighborhood strings in all
    8 rotations (reference neighborhood_gridcular
    go_heuristics.py:326-345): for each diameter, 8 strings — each the
    running concatenation for one rotation."""
    n = chars.shape[0]
    acc = ["" for _ in _ROTATIONS]
    for dseq in GRIDCULAR_SEQ:
        for ri, (idx, sgn) in enumerate(_ROTATIONS):
            for o in dseq:
                yy = y + o[idx[0]] * sgn[0]
                xx = x + o[idx[1]] * sgn[1]
                if 0 <= yy < n and 0 <= xx < n:
                    acc[ri] += chars[yy, xx]
                else:
                    acc[ri] += " "
            yield acc[ri]


def large_pattern_probability(store: PatternStore, board, y: int, x: int
                              ) -> Optional[float]:
    """Probability of the widest matching pattern at (y, x), or None
    (reference large_pattern_probability go_heuristics.py:348-366,
    including its stop-once-a-diameter-fails-to-match rule)."""
    if not store:
        return None
    chars = _board_chars(board)
    probability = None
    matched_len = 0
    non_matched_len = 0
    for nb in gridcular_neighborhoods(chars, y, x):
        sp_i = store.spat.get(nb)
        prob = store.probs.get(sp_i) if sp_i is not None else None
        if prob is not None:
            probability = prob
            matched_len = len(nb)
        elif matched_len < non_matched_len < len(nb):
            break
        else:
            non_matched_len = len(nb)
    return probability


def root_prior_bonus(store: PatternStore, board, prior_largepattern: float
                     ) -> Optional[np.ndarray]:
    """(A,) prior bonus sqrt(prob) * PRIOR_LARGEPATTERN for every empty
    point (tree_node.py:81-86), or None when no patterns are loaded.
    Host-side; applied to the search root by MichiEngine."""
    if not store:
        return None
    board = _host(board)
    chars = _board_chars(board)
    n = chars.shape[0]
    out = np.zeros((n * n + 1,), np.float32)
    for y in range(n):
        for x in range(n):
            if chars[y, x] != ".":
                continue
            p = large_pattern_probability(store, board, y, x)
            if p is not None and p > 0.001:
                out[y * n + x] = math.sqrt(p) * prior_largepattern
    return out
