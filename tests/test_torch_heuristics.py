"""The port's heuristics (sejonggo_torch.search.heuristics) against the
JAX package's, jitted and vmapped over the same boards.

Positions: 32 from seeded random legal play at 9x9 (contact-biased, so
ataris, ladders and captures occur), 4 at 19x19, and the JAX tests'
ladder and eye-falsification positions (tests/test_heuristics.py:264-330).
Every output is an integer or a boolean and must be equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sejonggo_tpu.search import heuristics as JH
from sejonggo_torch.goenv import engine
from sejonggo_torch.goenv.positions import choose_actions
from sejonggo_torch.search import heuristics as H

LADDER_ROWS = [
    ".........",
    ".........",
    "..XX.....",
    "..XOO....",
    "...XX....",
    ".........",
    ".........",
    ".........",
    ".........",
]
BREAKER_ROWS = [LADDER_ROWS[0], "......O.."] + LADDER_ROWS[2:]
EYE_ROWS = [
    "OX.......",
    "X.X......",
    ".XO......",
    ".........",
    ".........",
    ".........",
    "....O....",
    "...O.O...",
    "....O....",
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's small matmuls run as fast on one thread, and the test
    workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def board_from_ascii(rows, to_move=1):
    """A plane board from ascii ('X' black, 'O' white); 'X' stones go on
    the side-to-move planes when to_move is 1."""
    n = len(rows)
    b = np.zeros((n, n, 17), np.int8)
    for y, row in enumerate(rows):
        for x, ch in enumerate(row):
            if ch == "X":
                b[y, x, 0 if to_move == 1 else 1] = 1
            elif ch == "O":
                b[y, x, 1 if to_move == 1 else 0] = 1
    b[:, :, 16] = to_move
    return b


def played_boards(size, games, snapshots, seed, contact=0.8):
    """(len(snapshots) * games, N, N, 17) int8 plane boards (history
    planes included) and the move that made each, from seeded random
    legal games played by the port's engine on the CPU."""
    rng = np.random.RandomState(seed)
    boards = engine.init_board(size, batch=games, device="cpu")
    out, last = [], []
    act = np.full((games,), -1, np.int32)
    for m in range(max(snapshots) + 1):
        if m in snapshots:
            out.append(boards.clone())
            last.append(torch.as_tensor(act))
        illegal = engine.illegal_moves_mask_batch(boards).numpy()
        occ = ((boards[..., 0] == 1) | (boards[..., 1] == 1)).numpy()
        act = choose_actions(rng, illegal, occ, contact, 0.02)
        boards = engine.step_batch(boards, torch.as_tensor(act))
    return torch.cat(out), torch.cat(last)


def cases_9x9():
    boards, last = played_boards(9, 8, (10, 25, 40, 55), seed=5)
    extra = np.stack([board_from_ascii(r) for r in
                      (LADDER_ROWS, BREAKER_ROWS, EYE_ROWS)]
                     + [board_from_ascii(LADDER_ROWS, to_move=-1)])
    boards = torch.cat([boards, torch.from_numpy(extra)])
    last = torch.cat([last, torch.tensor([-1, 15, 81, 40], dtype=torch.int32)])
    return boards, last


@pytest.fixture(scope="module")
def positions():
    b9, l9 = cases_9x9()
    b19, l19 = played_boards(19, 2, (60, 120), seed=6)
    return {9: (b9, l9), 19: (b19, l19)}


@pytest.fixture(scope="module")
def jx():
    """The JAX functions, jitted over a batch (compiled once per shape)."""
    def planes(bd):
        return bd[:, :, 0] == 1, bd[:, :, 1] == 1

    def groups(bd):
        own, opp = planes(bd)
        empty = ~(own | opp)
        out = {}
        for name, st in (("own", own), ("opp", opp)):
            for k in (2, 3):
                tops = JH.group_lib_tops(st, empty, k=k)
                out[f"tops{k}_{name}"] = tops
                out[f"count{k}_{name}"] = JH.lib_count_capped(tops)
            lab = JH.group_labels(st)
            out[f"labels_{name}"] = lab
            out[f"sizes_{name}"] = JH.group_sizes(st, lab)
        return out

    def closure(bd):
        own, opp = planes(bd)
        a = JH.closure_analysis(own, opp)
        ko = (bd[:, :, 2].astype(jnp.int32) - bd[:, :, 0].astype(jnp.int32)) == 1
        cap, many = JH.capture_moves_from(a)
        cap2, many2 = JH.capture_moves_from(a, include_escapes=False)
        return dict(reach=a.reach, libset=a.libset, lib_count=a.lib_count,
                    size=a.size, self_atari=JH.self_atari_from(a),
                    cap=cap, many=many, cap_noesc=cap2, many_noesc=many2,
                    illegal=JH.illegal_from(a, ko))

    def sorted_path(bd):
        cap, many = JH.capture_moves(bd)
        cap2, many2 = JH.capture_moves(bd, include_escapes=False)
        lcap, lmany = JH.ladder_capture_moves(bd)
        return dict(self_atari=JH.self_atari_mask(bd), cap=cap, many=many,
                    cap_noesc=cap2, many_noesc=many2, ladder=lcap,
                    ladder_many=lmany)

    def shapes(bd, last):
        return dict(pat3=JH.pat3_mask(bd), eye=JH.own_true_eye_mask(bd),
                    empty_area=JH.empty_area_mask(bd),
                    empty_area2=JH.empty_area_mask(bd, dist=2),
                    cfg=JH.cfg_distances(bd, last, cap=4),
                    cfg6=JH.cfg_distances(bd, last, cap=6))

    return dict(groups=jax.jit(jax.vmap(groups)),
                closure=jax.jit(jax.vmap(closure)),
                sorted=jax.jit(jax.vmap(sorted_path)),
                shapes=jax.jit(jax.vmap(shapes)))


def _np(x):
    return {k: np.asarray(v) for k, v in x.items()}


def _equal(want, got, what):
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.shape == v.shape, (what, k, g.shape, v.shape)
        bad = np.argwhere(g != v)
        assert not bad.size, f"{what} {k}: {len(bad)} entries differ, first {bad[:3]}"


@pytest.mark.parametrize("size", [9, 19])
def test_shape_heuristics_match_jax(positions, jx, size):
    boards, last = positions[size]
    want = _np(jx["shapes"](boards.numpy(), last.numpy()))
    got = dict(pat3=H.pat3_mask(boards), eye=H.own_true_eye_mask(boards),
               empty_area=H.empty_area_mask(boards),
               empty_area2=H.empty_area_mask(boards, dist=2),
               cfg=H.cfg_distances(boards, last, cap=4),
               cfg6=H.cfg_distances(boards, last, cap=6))
    _equal(want, got, f"{size}x{size}")
    assert want["pat3"].any() and want["cfg"].min() == 0
    height = np.asarray(JH.line_height_grid(size))
    assert np.array_equal(H.line_height_grid(size).numpy(), height)


@pytest.mark.parametrize("size", [9, 19])
def test_group_functions_match_jax(positions, jx, size):
    boards, _ = positions[size]
    want = _np(jx["groups"](boards.numpy()))
    own, opp = boards[..., 0] == 1, boards[..., 1] == 1
    empty = ~(own | opp)
    got = {}
    for name, st in (("own", own), ("opp", opp)):
        for k in (2, 3):
            tops = H.group_lib_tops(st, empty, k=k)
            got[f"tops{k}_{name}"] = tops
            got[f"count{k}_{name}"] = H.lib_count_capped(tops)
        lab = H.group_labels(st)
        got[f"labels_{name}"] = lab
        got[f"sizes_{name}"] = H.group_sizes(st, lab)
    _equal(want, got, f"{size}x{size}")


@pytest.mark.parametrize("size", [9, 19])
def test_closure_analysis_matches_jax(positions, jx, size):
    boards, _ = positions[size]
    want = _np(jx["closure"](boards.numpy()))
    a = H.closure_analysis(boards[..., 0] == 1, boards[..., 1] == 1)
    cap, many = H.capture_moves_from(a)
    cap2, many2 = H.capture_moves_from(a, include_escapes=False)
    got = dict(reach=a.reach, libset=a.libset, lib_count=a.lib_count,
               size=a.size, self_atari=H.self_atari_from(a), cap=cap,
               many=many, cap_noesc=cap2, many_noesc=many2,
               illegal=H.illegal_from(a, H.board_ko_point(boards)))
    _equal(want, got, f"{size}x{size}")
    assert want["cap"].any() and want["self_atari"].any()
    assert np.array_equal(got["illegal"].numpy(),
                          engine.illegal_moves_mask_batch(boards).numpy())


@pytest.mark.parametrize("size", [9, 19])
def test_sorted_path_and_ladders_match_jax(positions, jx, size):
    boards, _ = positions[size]
    want = _np(jx["sorted"](boards.numpy()))
    stats = {}
    cap, many = H.capture_moves(boards)
    cap2, many2 = H.capture_moves(boards, include_escapes=False)
    lcap, lmany = H.ladder_capture_moves(boards, stats=stats)
    got = dict(self_atari=H.self_atari_mask(boards), cap=cap, many=many,
               cap_noesc=cap2, many_noesc=many2, ladder=lcap,
               ladder_many=lmany)
    _equal(want, got, f"{size}x{size}")
    if size == 9:
        # the JAX tests' golden ladders: only (3, 5) works; the breaker
        # stone stops it; the same shape with white to move has none
        ladder, breaker = got["ladder"][-4], got["ladder"][-3]
        assert set(map(tuple, ladder.nonzero().tolist())) == {(3, 5)}
        assert got["ladder_many"][-4, 3, 5]
        assert not breaker.any()
        assert stats["ladder_iters"] >= 5       # the ladder ran to the edge
        # the eye-falsification position: (1, 1) falsified by two
        # opponent diagonals, white's own eye at (7, 4) is not ours
        eyes = H.own_true_eye_mask(boards[-2:-1])[0]
        assert not eyes[1, 1] and not eyes[7, 4]
