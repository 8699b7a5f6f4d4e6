"""Minimal SGF reader/writer (no external deps): a copy of
sejonggo_tpu/io/sgf.py, pure Python, kept here so the port never imports
the JAX package.  Its files are byte-equal to the JAX package's,
``AP[sejonggo-tpu]`` included, so tools that read either read both.

Reference counterpart: sgfsave.py:130-167 (save_game_sgf via sgfmill,
with per-move value comments) and the KGS parsers' SGF consumption
(kgs_data_generator.py:95-143).  Supports the property subset those
paths use: GM FF SZ KM HA RE AB AW B W C PL.

SGF point encoding: two lowercase letters column+row, 'aa' = top-left,
i.e. column letter = x, row letter = y in the engine's coordinates; an
empty value ([]) or 'tt' on boards <= 19 is a pass.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple


def _xy_to_sgf(x: int, y: int, size: int) -> str:
    if y >= size:
        return ""  # pass
    return chr(ord("a") + x) + chr(ord("a") + y)


def _sgf_to_xy(val: str, size: int) -> Tuple[int, int]:
    if val == "" or (val == "tt" and size <= 19):
        return 0, size  # pass
    x = ord(val[0]) - ord("a")
    y = ord(val[1]) - ord("a")
    return x, y


_TOKEN = re.compile(r";|\(|\)|([A-Z]{1,2})((?:\[(?:[^\]\\]|\\.)*\])+)")
_VALUE = re.compile(r"\[((?:[^\]\\]|\\.)*)\]")


def parse_sgf(text: str) -> Dict:
    """Parse the main line of an SGF game.

    Returns {size, komi, handicap, result, setup_black, setup_white,
    moves: [(color:+1/-1, x, y), ...]} — variations are ignored (the
    main line is followed), escaped ']' handled.
    """
    props: Dict[str, List[str]] = {}
    moves: List[Tuple[int, int, int]] = []
    setup_b: List[Tuple[int, int]] = []
    setup_w: List[Tuple[int, int]] = []
    depth = 0
    size = 19
    for m in _TOKEN.finditer(text):
        tok = m.group(0)
        if tok == "(":
            depth += 1
            if depth > 1:
                break  # first variation point: stop at main line
            continue
        if tok == ")" or tok == ";":
            continue
        ident, raw = m.group(1), m.group(2)
        vals = [v.replace("\\]", "]") for v in _VALUE.findall(raw)]
        if ident in ("B", "W"):
            x, y = _sgf_to_xy(vals[0].strip().lower(), size)
            moves.append((1 if ident == "B" else -1, x, y))
        elif ident == "AB":
            setup_b.extend(_sgf_to_xy(v.strip().lower(), size) for v in vals)
        elif ident == "AW":
            setup_w.extend(_sgf_to_xy(v.strip().lower(), size) for v in vals)
        else:
            props.setdefault(ident, []).extend(vals)
            if ident == "SZ":
                size = int(vals[0])
    komi = 0.0
    if props.get("KM"):
        try:
            komi = float(props["KM"][0])
        except ValueError:
            komi = 0.0
    return {
        "size": size,
        "komi": komi,
        "handicap": int(props["HA"][0]) if props.get("HA") else 0,
        "result": props.get("RE", [""])[0],
        "setup_black": setup_b,
        "setup_white": setup_w,
        "moves": moves,
        "props": props,
    }


def game_to_sgf(size: int, komi: float, moves, result: str = "",
                values=None, black_name: str = "", white_name: str = "") -> str:
    """moves: [(player:+1/-1, x, y)]; values: optional per-move floats
    written as comments (reference sgfsave.py:150-160 stores the
    predicted value per node)."""
    out = [f"(;GM[1]FF[4]CA[UTF-8]AP[sejonggo-tpu]SZ[{size}]KM[{komi}]"]
    if black_name:
        out.append(f"PB[{black_name}]")
    if white_name:
        out.append(f"PW[{white_name}]")
    if result:
        out.append(f"RE[{result}]")
    for i, (player, x, y) in enumerate(moves):
        color = "B" if player == 1 else "W"
        out.append(f";{color}[{_xy_to_sgf(x, y, size)}]")
        if values is not None and i < len(values):
            out.append(f"C[{float(values[i]):.4f}]")
    out.append(")")
    return "".join(out)


def save_game_sgf(directory: str, model_name: str, game_n: int, *, size: int,
                  komi: float, games, game_index: int,
                  black_name: str = "", white_name: str = "") -> str:
    """Write one game of an actor GameBatch (numpy fields) as SGF
    (reference save_game_sgf path games/<model>/game_<n>.sgf)."""
    g = game_index
    valid = games.move_valid[:, g]
    moves = [
        (int(games.players[t, g]),
         *divmod_xy(int(games.actions[t, g]), size))
        for t in range(len(valid)) if valid[t]
    ]
    values = [float(games.values[t, g]) for t in range(len(valid)) if valid[t]]
    w = int(games.resign_winners[g])
    reason = int(games.end_reasons[g])
    if w == 0:
        result = "0"
    else:
        color = "B" if w == 1 else "W"
        if reason == 2:
            result = f"{color}+R"
        else:
            margin = abs(float(games.black_points[g]) - float(games.white_points[g]))
            result = f"{color}+{margin}"
    path = os.path.join(directory, model_name)
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"game_{game_n:03d}.sgf")
    with open(fname, "w") as f:
        f.write(game_to_sgf(size, komi, moves, result, values,
                            black_name, white_name))
    return fname


def divmod_xy(action: int, size: int) -> Tuple[int, int]:
    if action >= size * size:
        return 0, size
    y, x = divmod(action, size)
    return x, y
