"""Coordinate conversions (a copy of sejonggo_tpu/goenv/coords.py).

Flat action index = y * size + x, row-major; index == size*size is pass.
GTP columns skip the letter "I".
"""
from __future__ import annotations

import string

GTP_COLS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"  # "I" skipped per GTP convention


def index2coord(index: int, size: int):
    """Flat action index -> (x, y); pass -> (0, size)."""
    if index == size * size:
        return 0, size
    y, x = divmod(index, size)
    return x, y


def coord2index(x: int, y: int, size: int) -> int:
    """(x, y) -> flat action index; y == size means pass."""
    if y == size:
        return size * size
    return y * size + x


def gtp_to_xy(vertex: str, size: int):
    """GTP vertex ('D4', 'pass') -> engine (x, y); GTP rows count from
    the bottom, the engine's y from the top."""
    v = vertex.strip().lower()
    if v == "pass":
        return 0, size
    letter = v[0].upper()
    number = int(v[1:])
    x = string.ascii_uppercase.index(letter)
    if x >= 9:
        x -= 1  # 'I' is skipped
    y = number - 1
    return x, size - y - 1


def xy_to_gtp(x: int, y: int, size: int) -> str:
    """Engine (x, y) -> GTP vertex."""
    if y == size:
        return "pass"
    row = size - y - 1
    col = x
    if col >= 8:
        col += 1  # 'I' is skipped
    return string.ascii_uppercase[col] + str(row + 1)
