"""KGS supervised pretraining pipeline (port of sejonggo_tpu/io/kgs.py).

Reference counterpart: kgs_data_generator.py (stream SGF games through
the engine into (board, one-hot policy, ±1 value) samples,
play_game_kgs :95-143), kgs_game_parser/KGSSelfPlayWorker.py (handicap
setup :52-55 — AB stones played as forced-black moves), and
downloader.py (archive scraping; this environment has no egress, so
download_archives keeps the API but will typically be fed local files;
extraction replaces patoolib with stdlib zip/tar).

The reference needed 15 parser worker processes + fit_generator with 64
loader threads (main_training.py:80-84); here replay is plain host
code feeding the ReplayBuffer / train step directly.  The replay steps a
board on an explicit ``device`` (CUDA unless the caller names another):
on the card each move floods through the flood kernel four times.
"""
from __future__ import annotations

import os
import tarfile
import zipfile
from typing import Iterator, List, Optional

import numpy as np
import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.goenv import engine
from sejonggo_torch.io.sgf import parse_sgf


def replay_sgf(text: str, size: int, device=None):
    """Replay one SGF game into per-move training samples on ``device``.

    Returns list of dicts {board (int8), policy (one-hot incl. pass),
    value (+-1 by winner==mover), player, move} — the reference's
    move_data shape (kgs_data_generator.py:133-141).  Games with a
    different board size are skipped (returns []).
    """
    parsed = parse_sgf(text)
    if parsed["size"] != size:
        return []
    result = parsed["result"].strip().upper()
    winner = 0
    if result.startswith("B+"):
        winner = 1
    elif result.startswith("W+"):
        winner = -1
    return _replay_parsed(parsed, size, winner, resolve_device(device))


def _replay_parsed(parsed, size: int, winner: int, device):
    board = engine.init_board(size, device=device)
    # handicap: AB stones are played as forced-black moves
    # (KGSSelfPlayWorker.py:52-55)
    for (x, y) in parsed["setup_black"]:
        board, _ = engine.play_at(board, x, y, color=1)
    for (x, y) in parsed["setup_white"]:
        board, _ = engine.play_at(board, x, y, color=-1)

    samples, boards = [], []
    num_actions = size * size + 1
    for player, x, y in parsed["moves"]:
        index = num_actions - 1 if y >= size else y * size + x
        policy = np.zeros(num_actions, np.float32)
        policy[index] = 1.0
        value = 1.0 if winner == player else -1.0
        samples.append({
            "board": None,       # filled from the host copy below
            "policy": policy,
            "value": np.float32(value),
            "player": player,
            "move": (x, y),
        })
        boards.append(board)
        board, _ = engine.play_at(board, x, y, color=player)
    if boards:
        # one copy to the host for the whole game
        host = torch.stack(boards).cpu().numpy().astype(np.int8)
        for s, b in zip(samples, host):
            s["board"] = b
    return samples


def iter_sgf_files(data_dir: str) -> Iterator[str]:
    for root, _, files in os.walk(data_dir):
        for f in sorted(files):
            if f.lower().endswith(".sgf"):
                yield os.path.join(root, f)


def kgs_sample_stream(data_dir: str, size: int,
                      batch_size: int = 32,
                      rng: Optional[np.random.RandomState] = None,
                      loop: bool = False, device=None):
    """Yield (boards_f32, policies, values) batches from a directory of
    SGF files (the KGSDataGenerator role, without the worker processes).
    Unparseable games are skipped like the reference's bare except
    (kgs_data_generator.py:82-86)."""
    rng = rng or np.random.RandomState(0)
    device = resolve_device(device)   # outside the per-game except
    buf: List[dict] = []
    while True:
        files = list(iter_sgf_files(data_dir))
        rng.shuffle(files)
        if not files:
            return
        for path in files:
            try:
                with open(path, "r", errors="replace") as f:
                    samples = replay_sgf(f.read(), size, device)
            except Exception:  # noqa: BLE001 — mirror reference tolerance
                continue
            buf.extend(samples)
            while len(buf) >= batch_size:
                batch, buf = buf[:batch_size], buf[batch_size:]
                yield (
                    np.stack([s["board"] for s in batch]).astype(np.float32),
                    np.stack([s["policy"] for s in batch]),
                    np.asarray([s["value"] for s in batch], np.float32),
                )
        if not loop:
            break


def load_kgs_directory(data_dir: str, size: int, limit_games: int = 0,
                       device=None):
    """Materialize a whole directory into arrays (small corpora/tests)."""
    device = resolve_device(device)   # outside the per-game except
    boards, policies, values = [], [], []
    for i, path in enumerate(iter_sgf_files(data_dir)):
        if limit_games and i >= limit_games:
            break
        try:
            with open(path, "r", errors="replace") as f:
                samples = replay_sgf(f.read(), size, device)
        except Exception:  # noqa: BLE001
            continue
        for s in samples:
            boards.append(s["board"])
            policies.append(s["policy"])
            values.append(s["value"])
    if not boards:
        return (np.zeros((0, size, size, 17), np.int8),
                np.zeros((0, size * size + 1), np.float32),
                np.zeros((0,), np.float32))
    return np.stack(boards), np.stack(policies), np.asarray(values, np.float32)


def extract_archives(archive_dir: str, out_dir: str) -> int:
    """Unpack .zip/.tar.* archives of SGFs (replaces patoolib +
    copyUtil.sh).  Returns archives extracted."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fn in sorted(os.listdir(archive_dir)):
        path = os.path.join(archive_dir, fn)
        try:
            if zipfile.is_zipfile(path):
                with zipfile.ZipFile(path) as z:
                    z.extractall(out_dir)
                n += 1
            elif tarfile.is_tarfile(path):
                with tarfile.open(path) as t:
                    t.extractall(out_dir)
                n += 1
        except Exception:  # noqa: BLE001
            continue
    return n


def scrape_links(html: str, suffix: str = "") -> list:
    """Extract http(s) links from an index page, optionally filtered by
    suffix (reference downloader.py:99-113's regex scrape of the
    u-go/orb archive pages, as a pure function)."""
    import re as _re

    links = [m[0] for m in _re.findall(
        r"((https?)://[\w\d:#@%/;$()~_?+\-=\\.&]*)", html)]
    if suffix:
        links = [l for l in links if l.endswith(suffix)]
    # preserve order, drop duplicates
    seen = set()
    out = []
    for l in links:
        if l not in seen:
            seen.add(l)
            out.append(l)
    return out


def download_index(url: str, dest_dir: str, suffix: str = ".sgf") -> int:
    """Scrape an archive index page and fetch every linked file
    (reference download_from_url downloader.py:99-113; sequential
    instead of a 64-process pool — IO-bound, not CPU-bound).  Returns
    files fetched; 0 when the page is unreachable (no network egress
    here, like any air-gapped deployment)."""
    from urllib import request

    try:
        with request.urlopen(url) as resp:  # noqa: S310
            html = resp.read().decode("utf-8", "replace")
    except Exception:  # noqa: BLE001 — mirror reference tolerance
        return 0
    return download_archives(scrape_links(html, suffix), dest_dir)


def download_archives(urls, dest_dir: str) -> int:
    """Fetch SGF archives (reference downloader.py:88-111).  Kept for
    API parity; most deployments (including this one, which has no
    network egress) should place archives in `dest_dir` by other means
    and use extract_archives + kgs_sample_stream."""
    from urllib import request

    os.makedirs(dest_dir, exist_ok=True)
    n = 0
    for url in urls:
        try:
            filename = url.split("/")[-1]
            with request.urlopen(url) as resp:  # noqa: S310
                with open(os.path.join(dest_dir, filename), "wb") as f:
                    f.write(resp.read())
            n += 1
        except Exception:  # noqa: BLE001 — mirror reference tolerance
            continue
    return n
