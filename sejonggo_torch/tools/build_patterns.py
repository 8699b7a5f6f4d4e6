"""Harvest a pachi-format spatial pattern store from SGFs (port of
scripts/build_patterns.py).

It replays the SGFs of ``--sgf-dirs`` (on the card unless ``--device
cpu`` is passed), estimates per-pattern play probabilities, and writes
pachi-format ``patterns.spat`` and ``patterns.prob`` files, which
``search/patterns.py`` (host matcher) and ``search/pattern_lut.py``
(device-side expansion prior) read.

Estimator: at every recorded position the played point is a positive
and ``--negatives`` random empty points are negatives; for each
gridcular diameter group up to ``--max-diameter-groups`` the canonical
(lexicographically smallest rotation) neighborhood string accumulates
seen/played counts; prob = played / seen for patterns seen at least
``--min-seen`` times.  The replayed boards are exact integers and the
negatives come from ``RandomState(--seed)``, so every device writes the
same bytes.

    python -m sejonggo_torch.tools.build_patterns --out-dir runs/patterns_r5 \
        --sgf-dirs runs/strength_r4/duels runs/strength_r4b/duels
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

from sejonggo_torch._device import resolve_device
from sejonggo_torch.search.patterns import GRIDCULAR_SEQ, _ROTATIONS


def canonical_neighborhoods(chars, y, x, max_groups):
    """Per diameter group, the canonical (min over the 8 rotations)
    cumulative neighborhood string (patterns.gridcular_neighborhoods
    ordering)."""
    n = chars.shape[0]
    acc = ["" for _ in _ROTATIONS]
    out = []
    for dseq in GRIDCULAR_SEQ[:max_groups]:
        for ri, (idx, sgn) in enumerate(_ROTATIONS):
            for o in dseq:
                yy = y + o[idx[0]] * sgn[0]
                xx = x + o[idx[1]] * sgn[1]
                acc[ri] += (chars[yy, xx] if 0 <= yy < n and 0 <= xx < n
                            else " ")
        out.append(min(acc))
    return out


def harvest(sgf_dirs, *, out_dir: str = "runs/patterns_r5",
            max_diameter_groups: int = 4, negatives: int = 4,
            min_seen: int = 8, max_games: int = 400, size: int = 9,
            seed: int = 0, device=None) -> dict:
    """Replay up to ``max_games`` SGFs of ``sgf_dirs`` on ``device`` and
    write the pattern store into ``out_dir``; returns the games,
    positions, kept patterns and the two paths."""
    from sejonggo_torch.io.kgs import iter_sgf_files, replay_sgf

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    seen = defaultdict(int)
    played = defaultdict(int)
    games = 0
    positions = 0
    for d in sgf_dirs:
        for path in sorted(iter_sgf_files(d)):
            if games >= max_games:
                break
            try:
                with open(path, errors="replace") as f:
                    samples = replay_sgf(f.read(), size, dev)
            except (ValueError, IndexError, KeyError):
                # an unparseable SGF is skipped, as the script does; a
                # device or launch error (RuntimeError) ends the harvest
                continue
            games += 1
            for s in samples:
                board = s["board"]
                n = board.shape[0]
                move = int(np.argmax(s["policy"]))
                if move >= n * n:
                    continue
                own = np.asarray(board[:, :, 0] == 1)
                opp = np.asarray(board[:, :, 1] == 1)
                chars = np.full((n, n), ".", dtype="<U1")
                chars[own] = "X"
                chars[opp] = "x"
                empties = np.flatnonzero(~(own | opp).reshape(-1))
                negs = rng.choice(empties, size=min(negatives, len(empties)),
                                  replace=False)
                pts = {int(move)} | {int(q) for q in negs}
                positions += 1
                for p in pts:
                    y, x = divmod(p, n)
                    for nb in canonical_neighborhoods(
                            chars, y, x, max_diameter_groups):
                        seen[nb] += 1
                        if p == move:
                            played[nb] += 1

    os.makedirs(out_dir, exist_ok=True)
    spat_path = os.path.join(out_dir, "patterns.spat")
    prob_path = os.path.join(out_dir, "patterns.prob")
    kept = 0
    with open(spat_path, "w") as fs, open(prob_path, "w") as fp:
        fs.write("# synthesized from repo self-play SGFs "
                 f"(games={games}, positions={positions})\n")
        for nb, cnt in sorted(seen.items(), key=lambda kv: -kv[1]):
            if cnt < min_seen:
                continue
            prob = played[nb] / cnt
            pid = kept + 1
            # .spat line: <id> <size> <pattern> ; loader reads parts[2]
            fs.write(f"{pid} {len(nb)} {nb.replace(' ', '#')}\n")
            # .prob line: <prob> <n> <m> (s:<id>)
            fp.write(f"{prob:.6f} {cnt} {played[nb]} (s:{pid})\n")
            kept += 1
    print(f"games={games} positions={positions} patterns kept={kept} "
          f"-> {spat_path}, {prob_path}")
    return {"games": games, "positions": positions, "kept": kept,
            "spat": spat_path, "prob": prob_path}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sgf-dirs", nargs="+", required=True)
    ap.add_argument("--out-dir", default="runs/patterns_r5")
    ap.add_argument("--max-diameter-groups", type=int, default=4,
                    help="gridcular diameter groups to harvest (4 = "
                    "13+8 points, covers the device LUT radius)")
    ap.add_argument("--negatives", type=int, default=4)
    ap.add_argument("--min-seen", type=int, default=8)
    ap.add_argument("--max-games", type=int, default=400)
    ap.add_argument("--size", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device for the replay (default cuda; 'cpu' "
                    "to run on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    return harvest(**vars(parse_args(argv)))


if __name__ == "__main__":
    main()
