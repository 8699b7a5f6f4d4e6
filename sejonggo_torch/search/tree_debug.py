"""Array-tree introspection: depth, live nodes, consistency checks,
path dumps (host-side, numpy; port of sejonggo_tpu/search/tree_debug.py).

Reference counterpart: tree_depth/show_tree (play.py:355-374) — the
reference debugs its dict trees by recursive walking/printing; the
array tree (search/tree.py) needs the equivalent or every search bug
gets debugged through raw (C, A) tables.  Used from tests and from the
GTP frontend's ``sg_showtree`` debug command (io/gtp.py).

All functions take ONE tree's host arrays; pick a game out of a batched
Tree (tensors on any device) with :func:`extract_tree`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class HostTree(NamedTuple):
    node_P: np.ndarray        # (C, A)
    node_legal: np.ndarray    # (C, A)
    child_N: np.ndarray       # (C, A)
    child_W: np.ndarray       # (C, A)
    child_idx: np.ndarray     # (C, A)
    parent: np.ndarray        # (C,)
    parent_action: np.ndarray  # (C,)
    n_nodes: int
    root_N: int
    root_W: float


def extract_tree(trees, g: Optional[int] = None) -> HostTree:
    """Host copy of one tree; `g=None` for a Tree whose fields carry no
    batch axis, else the game index into a batched Tree (leading axis on
    every field)."""
    def pick(x: torch.Tensor) -> np.ndarray:
        return (x if g is None else x[g]).cpu().numpy()

    return HostTree(
        node_P=pick(trees.node_P), node_legal=pick(trees.node_legal),
        child_N=pick(trees.child_N), child_W=pick(trees.child_W),
        child_idx=pick(trees.child_idx), parent=pick(trees.parent),
        parent_action=pick(trees.parent_action),
        n_nodes=int(pick(trees.n_nodes)), root_N=int(pick(trees.root_N)),
        root_W=float(pick(trees.root_W)))


def live_nodes(t: HostTree) -> List[int]:
    """Slots reachable from the root via child_idx edges, preorder.
    (Slot liveness is reachability — after re-rooting, dead slots keep
    stale contents but nothing points at them.)"""
    out, stack, seen = [], [0], {0}
    while stack:
        n = stack.pop()
        out.append(n)
        kids = t.child_idx[n]
        for c in kids[kids >= 0]:
            c = int(c)
            if c not in seen:
                seen.add(c)
                stack.append(c)
    return out


def node_depths(t: HostTree) -> dict:
    """{slot: depth} for reachable slots (root = 0)."""
    depths = {0: 0}
    stack = [0]
    while stack:
        n = stack.pop()
        for c in t.child_idx[n][t.child_idx[n] >= 0]:
            c = int(c)
            if c not in depths:
                depths[c] = depths[n] + 1
                stack.append(c)
    return depths


def tree_depth(t: HostTree) -> int:
    """Max depth over reachable nodes (reference tree_depth
    play.py:355-360)."""
    return max(node_depths(t).values())


def check_consistency(t: HostTree) -> List[str]:
    """Structural invariants of the array tree; returns a list of
    violations (empty = consistent).

    - every expanded edge's child backpointers match (parent /
      parent_action);
    - children always sit at LARGER slot indices than their parent —
      the acyclicity invariant the search's pointer doubling and
      advance_root_batch's index-order truncation rest on;
    - child slots are inside the node table;
    - an edge's visit count is >= the visits recorded inside the child
      it leads to (each descent through the edge also visited the
      child's subtree or stopped at the child).
    """
    problems = []
    cap = t.parent.shape[0]
    for p in live_nodes(t):
        row = t.child_idx[p]
        for a in np.nonzero(row >= 0)[0]:
            c = int(row[a])
            if not (0 <= c < cap):
                problems.append(f"edge ({p},{a}) -> slot {c} out of range")
                continue
            if c <= p:
                problems.append(
                    f"edge ({p},{a}) -> slot {c} <= parent slot {p} "
                    "(acyclicity invariant broken)")
            if int(t.parent[c]) != p:
                problems.append(
                    f"slot {c}: parent backpointer {int(t.parent[c])} != {p}")
            if int(t.parent_action[c]) != a:
                problems.append(
                    f"slot {c}: parent_action {int(t.parent_action[c])} != {a}")
            if int(t.child_N[p, a]) < int(t.child_N[c].sum()):
                problems.append(
                    f"edge ({p},{a}): N={int(t.child_N[p, a])} < child "
                    f"subtree visits {int(t.child_N[c].sum())}")
    return problems


def _coord(a: int, size: int) -> str:
    if a == size * size:
        return "pass"
    y, x = divmod(a, size)
    letters = "ABCDEFGHJKLMNOPQRST"  # GTP: no I
    return f"{letters[x]}{y + 1}"


def principal_variation(t: HostTree, size: int,
                        max_len: int = 16) -> List[Tuple[str, int, float]]:
    """Most-visited path from the root: [(coord, N, Q), ...]."""
    out, n = [], 0
    for _ in range(max_len):
        if t.child_N[n].sum() == 0:
            break
        a = int(np.argmax(t.child_N[n]))
        N = int(t.child_N[n, a])
        q = float(t.child_W[n, a]) / max(N, 1)
        out.append((_coord(a, size), N, q))
        c = int(t.child_idx[n, a])
        if c < 0:
            break
        n = c
    return out


def show_tree(t: HostTree, size: int, max_depth: int = 2,
              top_k: int = 5) -> str:
    """Indented dump of the top-k edges per node down to `max_depth`
    (reference show_tree play.py:363-374)."""
    lines = [f"root: N={t.root_N} W={t.root_W:+.2f} "
             f"live={len(live_nodes(t))}/{t.n_nodes} "
             f"depth={tree_depth(t)}"]

    def rec(n: int, depth: int):
        if depth > max_depth:
            return
        order = np.argsort(-t.child_N[n])[:top_k]
        for a in order:
            N = int(t.child_N[n, a])
            if N == 0:
                break
            q = float(t.child_W[n, a]) / N
            c = int(t.child_idx[n, a])
            lines.append("  " * depth
                         + f"{_coord(int(a), size)}: N={N} Q={q:+.3f} "
                         f"P={float(t.node_P[n, a]):.3f}"
                         + (f" -> slot {c}" if c >= 0 else ""))
            if c >= 0:
                rec(c, depth + 1)

    rec(0, 1)
    return "\n".join(lines)
