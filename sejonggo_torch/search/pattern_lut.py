"""Small-radius gridcular pattern prior as a lookup table (port of
sejonggo_tpu/search/pattern_lut.py).

The reference applies the large-pattern prior at every node expansion
(mcts1/tree_node.py:81-86: pv/pw += PRIOR_LARGEPATTERN * sqrt(prob)).
The host-side string matcher (search/patterns.py) reaches only the
search root; this module bakes the smallest gridcular diameter (the 3x3
ring, GRIDCULAR_SEQ[0]) into a 4^8-entry float32 table indexed with the
same base-4 neighborhood code the pat3 matcher uses, so every batched
expansion gets the prior.

Pattern files: runs/patterns_r5/patterns.{spat,prob}
(scripts/build_patterns.py synthesized them from self-play SGFs).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from sejonggo_torch.search.heuristics import (_EDGE, _EMPTY, _NBR8, _OPP,
                                              _OWN, neighborhood_codes)
from sejonggo_torch.search.patterns import (GRIDCULAR_SEQ, _ROTATIONS,
                                            PatternStore)

_SYMBOLS = {_EMPTY: ".", _OWN: "X", _OPP: "x", _EDGE: " "}


def build_small_pattern_lut(store: PatternStore,
                            min_prob: float = 0.001) -> np.ndarray:
    """(4^8,) f32: neighborhood-code -> sqrt(pattern probability), 0
    when no diameter-1 pattern matches.

    Code layout matches heuristics.pat3_mask_from: the 8 non-center
    points in _NBR8 row-major order, 2 bits each, little-endian.  The
    candidate point itself (gridcular center) is always empty.  Lookup
    follows the matcher's try-all-8-rotations rule.
    """
    out = np.zeros(4 ** 8, np.float32)
    if not store:
        return out
    group0 = GRIDCULAR_SEQ[0]
    codes = np.arange(4 ** 8)
    syms = np.stack([(codes >> (2 * k)) & 3 for k in range(8)], 1)
    for code in codes:
        chars = {(0, 0): "."}
        for k, (dy, dx) in enumerate(_NBR8):
            chars[(dy, dx)] = _SYMBOLS[int(syms[code, k])]
        prob = None
        for idx, sgn in _ROTATIONS:
            s = "".join(chars[(o[idx[0]] * sgn[0], o[idx[1]] * sgn[1])]
                        for o in group0)
            sp_i = store.spat.get(s)
            if sp_i is not None and sp_i in store.probs:
                prob = store.probs[sp_i]
                break
        if prob is not None and prob > min_prob:
            out[code] = math.sqrt(prob)
    return out


def load_small_pattern_lut(spat_path: str, prob_path: str) -> np.ndarray:
    store = PatternStore()
    store.load_spat(spat_path)
    store.load_probs(prob_path)
    return build_small_pattern_lut(store)


def lut_bonus_from(own: torch.Tensor, opp: torch.Tensor,
                   lut: torch.Tensor) -> torch.Tensor:
    """(B, N, N) f32 sqrt-probability bonus of the boards' empty points.
    Scale by MichiConfig.prior_largepattern at the call site."""
    lut = torch.as_tensor(lut, dtype=torch.float32).to(own.device)
    return torch.where(~(own | opp), lut[neighborhood_codes(own, opp)], 0.0)
