"""Batched Go engine on tensors (port of sejonggo_tpu/goenv/engine.py).

Board encoding as in the JAX package and the reference (play.py):
(B, N, N, 17) int8 planes; 0..15 are 8 move-pairs of (side-to-move
stones, opponent stones) history, plane 16 is the side to move (+-1); the
player swap permutes planes by ``SWAP_INDEX``.  Signed stone grids
(B, N, N) int8 are black-positive.

The reference's suicide quirk is kept (README.md, "suicide"): a move is
illegal iff it has no adjacent empty point and captures nothing, which
also forbids filling a fully surrounded point next to a live friendly
group.

Dispatch is by device, not by a global switch: ``step_batch`` and
``score_batch`` flood through ``ops.flood.flood_fixpoint`` and
``step_and_illegal_stones_batch``
goes through ``ops.gostep.step_legal``; both launch the CUDA kernels for
CUDA tensors and run their plain versions for CPU tensors.

The single-board API at the end (``play_at``, ``score``, ``show_board``
and the rest) is what GTP, SGF replay and the tests use: one (N, N, 17)
board on its own device, routed through the batched functions at B=1.
"""
from __future__ import annotations

import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.ops.flood import dilate as _dilate
from sejonggo_torch.ops.flood import flood_fixpoint
from sejonggo_torch.ops.flood import flood_plain as _flood

# Plane permutation applied on every player swap (reference play.py:15).
SWAP_INDEX = (1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14)
NUM_PLANES = 17


def _shift_fill(v: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = v[..., y + dy, x + dx], ``fill`` off the board
    (|dy|, |dx| <= 1)."""
    rows, cols = v.shape[-2], v.shape[-1]
    out = torch.full_like(v, fill)
    out[..., max(0, -dy):rows - max(0, dy), max(0, -dx):cols - max(0, dx)] = \
        v[..., max(0, dy):rows - max(0, -dy), max(0, dx):cols - max(0, -dx)]
    return out


def _nbr_reduce(v: torch.Tensor, fill, op) -> torch.Tensor:
    """Elementwise ``op`` over the 4 orthogonal neighbours."""
    return op(op(_shift_fill(v, 1, 0, fill), _shift_fill(v, -1, 0, fill)),
              op(_shift_fill(v, 0, 1, fill), _shift_fill(v, 0, -1, fill)))


def _flat_index(n: int, device) -> torch.Tensor:
    return torch.arange(n * n, dtype=torch.int32, device=device).view(n, n)


def _group_minmax_lib(stones: torch.Tensor, empty: torch.Tensor):
    """Per-stone min/max flat index of its group's distinct liberties.

    Returns (mn, mx) int32 grids; non-stones get mn = N*N and mx = -1.
    A group has <= 1 distinct liberty iff mn >= mx.  The fixpoint moves a
    value one stone per step, so it settles within N*N steps; the loop is
    capped at N*N + 1 and raises if it runs out."""
    n = stones.shape[-1]
    inf = n * n
    flat = _flat_index(n, stones.device)
    lib_min = torch.where(empty, flat, inf)
    lib_max = torch.where(empty, flat, -1)
    mn = torch.where(stones, _nbr_reduce(lib_min, inf, torch.minimum), inf)
    mx = torch.where(stones, _nbr_reduce(lib_max, -1, torch.maximum), -1)
    for _ in range(n * n + 1):
        nmn = torch.minimum(mn, _nbr_reduce(torch.where(stones, mn, inf),
                                            inf, torch.minimum))
        nmx = torch.maximum(mx, _nbr_reduce(torch.where(stones, mx, -1),
                                            -1, torch.maximum))
        nmn = torch.where(stones, nmn, inf)
        nmx = torch.where(stones, nmx, -1)
        if torch.equal(nmn, mn) and torch.equal(nmx, mx):
            return mn, mx
        mn, mx = nmn, nmx
    raise RuntimeError("_group_minmax_lib did not converge within N*N+1 steps")


def _onehot(actions: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) actions -> (B, N, N) bool; all-False for the pass N*N."""
    flat = _flat_index(n, actions.device)
    return flat[None] == actions.to(torch.int32)[:, None, None]


# ---------------------------------------------------------------------------
# board API


def init_board(size: int, batch: int | None = None, device=None,
               dtype=torch.int8) -> torch.Tensor:
    """Empty board(s), player +1 to move: (N, N, 17), or (B, N, N, 17)
    when ``batch`` is given."""
    dev = resolve_device(device)
    shape = (size, size, NUM_PLANES) if batch is None \
        else (batch, size, size, NUM_PLANES)
    board = torch.zeros(shape, dtype=dtype, device=dev)
    board[..., 16] = 1
    return board


def signed_stones(boards: torch.Tensor) -> torch.Tensor:
    """(..., N, N, 17) plane boards -> (..., N, N) int8 black-positive
    stone grids (reference get_real_board play.py:106-112)."""
    player = boards[..., 0, 0, 16].to(torch.int8)[..., None, None]
    return (boards[..., 0].to(torch.int8) - boards[..., 1].to(torch.int8)) \
        * player


def to_features(boards: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Network input features: the 17 planes as floats."""
    return boards.to(dtype)


def _place_and_capture(own, opp, onehot, flood):
    """The reference's take_stones ordering (play.py:182-217): dead
    opponent groups next to the placed stone go first, then own groups at
    or next to it with no liberty (suicide)."""
    empty = ~(own | opp)
    dead_opp = opp & ~flood(opp & _dilate(empty), opp)
    removed_opp = flood(dead_opp & _dilate(onehot), dead_opp)
    opp = opp & ~removed_opp
    empty = ~(own | opp)
    dead_own = own & ~flood(own & _dilate(empty), own)
    removed_own = flood(dead_own & (_dilate(onehot) | onehot), dead_own)
    own = own & ~removed_own
    return own, opp


def step_batch(boards: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Apply one move per board: boards (B, N, N, 17), actions (B,) in
    [0, N*N] (N*N = pass).  The env step of the move loop; its four
    floods run through ``flood_fixpoint`` (the CUDA kernel on the card)."""
    n = boards.shape[-3]
    dtype = boards.dtype
    shifted = torch.cat(
        [boards[..., 0:2], boards[..., 0:14], boards[..., 16:17]], dim=-1)
    onehot = _onehot(actions, n)
    p0 = (shifted[..., 0] == 1) | onehot
    p1 = shifted[..., 1] == 1
    p0, p1 = _place_and_capture(p0, p1, onehot, flood_fixpoint)
    shifted[..., 0] = p0.to(dtype)     # shifted is a fresh tensor
    shifted[..., 1] = p1.to(dtype)
    swapped = shifted[..., list(SWAP_INDEX)]
    return torch.cat([swapped, -shifted[..., 16:17]], dim=-1)


def _illegal_core(own, opp, ko_pt):
    """(B, N, N) masks -> (B, N*N+1) bool illegality (pass always legal)."""
    b, n = own.shape[0], own.shape[-1]
    empty = ~(own | opp)
    ko = ko_pt & (ko_pt.sum(dim=(-2, -1), keepdim=True) == 1)
    opp_mn, opp_mx = _group_minmax_lib(opp, empty)
    opp_capturable = opp & (opp_mn >= opp_mx)
    breath = _dilate(empty) | _dilate(opp_capturable)
    legal = empty & ~ko & breath
    illegal = ~legal.reshape(b, n * n)
    return torch.cat([illegal, torch.zeros((b, 1), dtype=torch.bool,
                                           device=own.device)], dim=-1)


def illegal_moves_mask_batch(boards: torch.Tensor) -> torch.Tensor:
    """(B, N, N, 17) -> (B, N*N+1) bool, True = illegal: occupied, simple
    ko read off the history planes, suicide unless capturing."""
    own = boards[..., 0] == 1
    opp = boards[..., 1] == 1
    ko_pt = (boards[..., 2].to(torch.int32) - boards[..., 0].to(torch.int32)) == 1
    return _illegal_core(own, opp, ko_pt)


def step_stones_batch(stones: torch.Tensor, sides: torch.Tensor,
                      actions: torch.Tensor) -> torch.Tensor:
    """Move on signed grids: (B, N, N) int8, (B,) sides, (B,) actions ->
    (B, N, N) int8.  Always the plain version (the search's leaf path
    goes through ``step_and_illegal_stones_batch``)."""
    n = stones.shape[-1]
    side = sides.to(torch.int8)[:, None, None]
    onehot = _onehot(actions, n)
    own = (stones == side) | onehot
    opp = stones == -side
    own, opp = _place_and_capture(own, opp, onehot, _flood)
    zero = torch.zeros((), dtype=torch.int8, device=stones.device)
    return torch.where(own, side, torch.where(opp, -side, zero))


def illegal_moves_mask_stones_batch(stones: torch.Tensor,
                                    prev_stones: torch.Tensor,
                                    sides: torch.Tensor) -> torch.Tensor:
    """(B, N, N) grids + the previous grids (for simple ko) + (B,) sides
    to move -> (B, N*N+1) bool illegality."""
    side = sides.to(torch.int8)[:, None, None]
    own = stones == side
    opp = stones == -side
    ko_pt = (prev_stones == side) & ~own
    return _illegal_core(own, opp, ko_pt)


def step_and_illegal_stones_batch(stones: torch.Tensor, sides: torch.Tensor,
                                  actions: torch.Tensor):
    """Leaf step + next-mover legality: (B, N, N) int8 grids, (B,) sides
    and actions -> (new_stones (B, N, N) int8, illegal (B, N*N+1) bool).
    The search's hot path: CUDA tensors run the gostep kernel."""
    from sejonggo_torch.ops.gostep import step_legal

    return step_legal(stones, sides, actions)


def score_batch(boards: torch.Tensor, komi: float):
    """Area score (reference get_winner play.py:274-292): returns
    (winner (B,) int32 in {+1, 0, -1}, black_points, white_points).  Its
    two floods run through ``flood_fixpoint`` (the CUDA kernel on the
    card): the continuous self-play step scores every slot every step."""
    real = signed_stones(boards)
    black, white, empty = real == 1, real == -1, real == 0
    reach_b = flood_fixpoint(empty & _dilate(black), empty)
    reach_w = flood_fixpoint(empty & _dilate(white), empty)
    black_pts = (black.sum((-2, -1)) + (reach_b & ~reach_w).sum((-2, -1))
                 ).to(torch.float32)
    white_pts = (white.sum((-2, -1)) + (reach_w & ~reach_b).sum((-2, -1))
                 ).to(torch.float32) + komi
    w = torch.where(black_pts > white_pts, 1,
                    torch.where(black_pts == white_pts, 0, -1))
    return w.to(torch.int32), black_pts, white_pts


# ---------------------------------------------------------------------------
# single-board API: one (N, N, 17) board, through the batched functions
# at B=1 (so a CUDA board floods through the kernel)


def current_player(board: torch.Tensor) -> torch.Tensor:
    """Side to move, +1/-1, as a 0-d int32 tensor."""
    return board[0, 0, 16].to(torch.int32)


def real_board(board: torch.Tensor) -> torch.Tensor:
    """(N, N) int32 signed board, black (the first mover) = +1
    (reference get_real_board play.py:106-112)."""
    return signed_stones(board).to(torch.int32)


def _swap_sides(board: torch.Tensor) -> torch.Tensor:
    """Swap the current/other planes and flip the side to move
    (play.py:219-224)."""
    return torch.cat([board[..., list(SWAP_INDEX)], -board[..., 16:17]],
                     dim=-1)


def illegal_moves_mask(board: torch.Tensor) -> torch.Tensor:
    """(N*N+1,) bool, True = illegal; pass (the last entry) is legal."""
    return illegal_moves_mask_batch(board[None])[0]


def legal_moves_mask(board: torch.Tensor) -> torch.Tensor:
    """(N*N+1,) bool, True = legal."""
    return ~illegal_moves_mask(board)


def step(board: torch.Tensor, action: int) -> torch.Tensor:
    """Apply a move for the side to move; action in [0, N*N], N*N = pass.
    No legality check, as in the JAX package."""
    actions = torch.tensor([action], dtype=torch.int32, device=board.device)
    return step_batch(board[None], actions)[0]


def play_at(board: torch.Tensor, x: int, y: int, color=None):
    """Reference make_play(x, y, board, color): y == size is a pass.  If
    ``color`` is given and is not the side to move, the sides are swapped
    first (GTP and the tests force consecutive moves of one colour,
    play.py:226-229).  Returns (new_board, player who moved)."""
    n = board.shape[-3]
    if color is not None and int(board[0, 0, 16]) != color:
        board = _swap_sides(board)
    player = int(board[0, 0, 16])
    action = n * n if y >= n else y * n + x
    return step(board, action), player


def score(board: torch.Tensor, komi: float):
    """Area score of one board: (winner 0-d int32 in {+1, 0, -1}, black
    points, white points with komi), as ``score_batch``."""
    w, b, wh = score_batch(board[None], komi)
    return w[0], b[0], wh[0]


def winner(board: torch.Tensor, komi: float) -> torch.Tensor:
    return score(board, komi)[0]


def color_board(real: torch.Tensor, color: int) -> torch.Tensor:
    """Empty points connected to ``color`` stones become ``color``
    (reference color_board/_color_adjoint play.py:244-271), on an (N, N)
    signed board; int32."""
    real = torch.as_tensor(real).to(torch.int32)
    stones = real == color
    empty = real == 0
    reach = flood_fixpoint((empty & _dilate(stones))[None], empty[None])[0]
    return torch.where(reach, color, real)


def area_counts(real: torch.Tensor) -> torch.Tensor:
    """color_board(real, 1) + color_board(real, -1) (reference
    _get_points play.py:286-292): black stones 2, white stones -2,
    black-only territory 1, white-only -1, dame 0."""
    return color_board(real, 1) + color_board(real, -1)


def group_liberty_count(board: torch.Tensor, x: int, y: int,
                        color: int) -> torch.Tensor:
    """Distinct liberties of the ``color`` group connected to (x, y),
    excluding the seed point itself (reference get_liberties
    play.py:57-69, clean semantics as in the JAX package)."""
    n = board.shape[-3]
    real = real_board(board)
    iota = torch.arange(n, device=board.device)
    seed = (iota[:, None] == y) & (iota[None, :] == x)
    stones = real == color
    group = seed | flood_fixpoint((stones & _dilate(seed))[None],
                                  stones[None])[0]
    libs = (real == 0) & _dilate(group) & ~seed
    return libs.sum()


def show_board(board: torch.Tensor) -> str:
    """ASCII rendering (reference _show_board play.py:114-133 style):
    black ○, white ●, empty ."""
    out = []
    for brow in real_board(board).cpu().tolist():
        out.append(" ".join("○" if c == 1 else "●" if c == -1 else "."
                            for c in brow))
    return "\n".join(out)
