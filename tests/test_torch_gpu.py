"""The CUDA kernels of sejonggo_torch against their plain PyTorch
versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import contextlib
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from sejonggo_torch import ops
from sejonggo_torch.actor import init_state, make_move_step, play_games
from sejonggo_torch.config import NetConfig, SearchConfig, strength_9x9_xl
from sejonggo_torch.goenv.positions import random_positions
from sejonggo_torch.learn import (CheckpointStore, init_train_state,
                                  make_optimizer, make_train_step)
from sejonggo_torch.learn.checkpoint import state_tree
from sejonggo_torch.nets import (AZNet, dummy_predict_fn, from_jax_variables,
                                 make_predict_fn, seeded_flax_variables)

MODELS = pathlib.Path(__file__).resolve().parents[1] / \
    "runs/strength_r5b/sp_models"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _random_masks(n, b, seed):
    rng = np.random.RandomState(seed)
    allowed = rng.rand(b, n, n) < 0.6
    seeds = allowed & (rng.rand(b, n, n) < 0.15)
    return seeds, allowed


def _serpentine(n):
    allowed = np.zeros((1, n, n), bool)
    path = []
    for y in range(n):
        xs = range(n - 1) if y % 2 == 0 else range(n - 1, 0, -1)
        path += [(y, x) for x in xs]
    for y, x in path:
        allowed[0, y, x] = True
    seeds = np.zeros_like(allowed)
    seeds[0, path[0][0], path[0][1]] = True
    return seeds, allowed


def _unaligned(x):
    """A copy of ``x`` whose data starts one byte past a 16-byte boundary
    (the kernels then take their non-bulk copy path)."""
    flat = torch.empty(x.numel() * x.element_size() + 16, dtype=torch.uint8,
                       device=x.device)
    y = flat[1:1 + x.numel() * x.element_size()].view(x.dtype).view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 1 and y.is_contiguous()
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("n,b", [(9, 3072), (9, 77), (19, 300), (5, 64), (2, 3)])
def test_flood_kernel_matches_plain(cuda, n, b):
    seeds, allowed = _random_masks(n, b, n + b)
    s, a = torch.from_numpy(seeds).to(cuda), torch.from_numpy(allowed).to(cuda)
    before = ops.flood_fixpoint.launches
    got = ops.flood_fixpoint(s, a)
    assert ops.flood_fixpoint.launches == before + 1
    ops.check_kernel_errors(cuda)
    assert torch.equal(got, ops.flood_plain(s, a))
    if n >= 3:
        ls, la = (torch.from_numpy(x).to(cuda) for x in _serpentine(n))
        assert torch.equal(ops.flood_fixpoint(ls, la), ops.flood_plain(ls, la))
        ops.check_kernel_errors(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 31, 33, 3071, 98305])
@pytest.mark.parametrize("n", [2, 5, 9, 11, 15, 19])
def test_flood_kernel_ragged_batches_every_width(cuda, n, b):
    """W = ceil(N*N/64) from 1 to 6, batches that leave a ragged last
    block, inputs on and off 16-byte alignment."""
    if n * n * b > 8_000_000:
        b = 8_000_000 // (n * n)   # keep the plain version's memory small
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + b)
    a = torch.rand((b, n, n), generator=g, device=cuda) < 0.6
    s = a & (torch.rand((b, n, n), generator=g, device=cuda) < 0.1)
    exp = ops.flood_plain(s, a)
    assert torch.equal(ops.flood_fixpoint(s, a), exp)
    ops.check_kernel_errors(cuda)
    assert torch.equal(ops.flood_fixpoint(_unaligned(s), _unaligned(a)), exp)
    ops.check_kernel_errors(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("n,games,moves,contact", [
    (9, 64, 60, 0.0), (9, 64, 60, 0.9), (19, 8, 80, 0.9), (13, 6, 40, 0.5),
    (7, 5, 9, 0.5)])
def test_gostep_kernel_matches_plain(cuda, n, games, moves, contact):
    stones, sides, actions = random_positions(n, games, moves, n + moves,
                                              contact=contact)
    stones, sides, actions = stones.to(cuda), sides.to(cuda), actions.to(cuda)
    before = ops.step_legal.launches
    got_s, got_i = ops.step_legal(stones, sides, actions)
    assert ops.step_legal.launches == before + 1
    ops.check_kernel_errors(cuda)
    exp_s, exp_i = ops.step_legal_plain(stones, sides, actions)
    assert torch.equal(got_s, exp_s)
    assert torch.equal(got_i, exp_i)


_POSITIONS = {}


def _positions(n, count):
    """``count`` positions of contact-biased random games at size n (made
    once per size on the CPU and cut to the count)."""
    if n not in _POSITIONS or _POSITIONS[n][0].shape[0] < count:
        moves = min(2 * n * n, 96)
        games = -(-count // moves)
        _POSITIONS[n] = random_positions(n, games, moves, n, contact=0.7)
    return tuple(x[:count] for x in _POSITIONS[n])


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 31, 33, 3071, 98305])
@pytest.mark.parametrize("n", [2, 5, 9, 11, 15, 19])
def test_gostep_kernel_ragged_batches_every_width(cuda, n, b):
    """W = ceil(N*N/64) from 1 to 6, batches that leave a ragged last
    block, inputs on and off 16-byte alignment."""
    if n * n * b > 8_000_000:
        b = 8_000_000 // (n * n)   # keep the CPU game generation short
    stones, sides, actions = (x.to(cuda) for x in _positions(n, b))
    exp_s, exp_i = ops.step_legal_plain(stones, sides, actions)
    got_s, got_i = ops.step_legal(stones, sides, actions)
    ops.check_kernel_errors(cuda)
    assert torch.equal(got_s, exp_s) and torch.equal(got_i, exp_i)
    got_s, got_i = ops.step_legal(_unaligned(stones), sides, actions)
    ops.check_kernel_errors(cuda)
    assert torch.equal(got_s, exp_s) and torch.equal(got_i, exp_i)


@pytest.mark.gpu
def test_kernel_error_word_raises_once_set(cuda):
    """A set error word raises at the next check and is reset by it; the
    kernels themselves never synchronise the host."""
    from sejonggo_torch.ops import errors

    ops.check_kernel_errors(cuda)
    word = errors.error_word(cuda)
    word.fill_(errors.FLOOD)
    with pytest.raises(RuntimeError, match="flood"):
        ops.check_kernel_errors(cuda)
    assert int(word.item()) == 0
    ops.check_kernel_errors(cuda)
    word.fill_(errors.GOSTEP)
    with pytest.raises(RuntimeError, match="gostep"):
        ops.check_kernel_errors()


@pytest.mark.gpu
def test_gostep_kernel_ko_case(cuda):
    n = 9
    grid = np.zeros((n, n), np.int8)
    grid[0, 1] = grid[1, 0] = grid[1, 2] = 1
    grid[1, 1] = grid[2, 0] = grid[2, 2] = grid[3, 1] = -1
    stones = torch.from_numpy(grid[None]).to(cuda)
    sides = torch.tensor([1], dtype=torch.int8, device=cuda)
    actions = torch.tensor([2 * n + 1], dtype=torch.int32, device=cuda)
    got_s, got_i = ops.step_legal(stones, sides, actions)
    ops.check_kernel_errors(cuda)
    exp_s, exp_i = ops.step_legal_plain(stones, sides, actions)
    assert torch.equal(got_s, exp_s) and torch.equal(got_i, exp_i)
    assert bool(got_i[0, n + 1])


@pytest.mark.gpu
def test_move_step_kernel_path_matches_plain_path(cuda):
    """Greedy, noise-free, identity-symmetry moves: the card (both
    kernels) and the CPU (plain versions) give the same games."""
    b = 16
    search = SearchConfig(simulations=32, batch_size=16, use_symmetry=True,
                          max_nodes=48)
    step = make_move_step(dummy_predict_fn, search, 9, selfplay=False)
    states = {d: init_state(b, 9, search, device=d) for d in (cuda, "cpu")}
    ops.reset_kernel_launches()
    for _ in range(5):
        recs = {}
        for d in (cuda, "cpu"):
            states[d], recs[d], _ = step(
                states[d], torch.ones(b, dtype=torch.bool, device=d),
                torch.full((b,), float("nan"), device=d),
                syms=[torch.zeros(b, dtype=torch.long)] * search.rounds)
        assert torch.equal(recs[cuda]["actions"].cpu(), recs["cpu"]["actions"])
        assert torch.equal(states[cuda].boards.cpu(), states["cpu"].boards)
        for name, t in states[cuda].trees.fields().items():
            assert torch.equal(t.cpu(), getattr(states["cpu"].trees, name)), name
    assert ops.kernel_launches() == {"gostep": 2 * 5, "flood": 4 * 5}
    # every move read the error word; a normal game leaves it 0
    from sejonggo_torch.ops import errors
    assert int(errors.error_word(cuda).item()) == 0


@pytest.mark.gpu
def test_play_games_kernel_path_matches_plain_path(cuda):
    """Whole self-play games with root noise, symmetries and sampled
    opening moves, all drawn on the CPU from one seed: the card (both
    kernels) and the CPU (plain versions) give the same GameBatch."""
    search = SearchConfig(simulations=16, batch_size=8, use_symmetry=True,
                          dirichlet_alpha=0.3, max_nodes=40)
    games = {}
    for d in (cuda, "cpu"):
        ops.reset_kernel_launches()
        games[d] = play_games(
            dummy_predict_fn, size=5, komi=5.5, search=search, game_batch=8,
            generator=torch.Generator().manual_seed(3), stop_exploration=3,
            max_moves=30, device=d,
            resign_thresholds=[np.nan] * 7 + [2.0])
        if d is cuda:
            launches = ops.kernel_launches()
    t = games[cuda].actions.shape[0]
    assert launches == {"gostep": 2 * t, "flood": 4 * t + 2}
    for f in dataclasses.fields(games[cuda]):
        assert np.array_equal(getattr(games[cuda], f.name),
                              getattr(games["cpu"], f.name)), f.name


@pytest.mark.gpu
def test_model_291_bf16_predict(cuda):
    """The xl net from the committed checkpoint, bf16 on the card, against
    the same net in float32 on the CPU: within 0.1, four times the gap
    between bf16 and float32 that the CPU shows on such boards (0.025)."""
    cfg = strength_9x9_xl().net
    state = from_jax_variables(
        CheckpointStore(str(MODELS)).load_variables("model_291"))
    preds = {}
    for d, dtype in ((cuda, "bfloat16"), ("cpu", "float32")):
        net = AZNet.from_config(9, dataclasses.replace(cfg, compute_dtype=dtype))
        net.load_state_dict(state)
        preds[d] = make_predict_fn(net.to(d))
    rng = np.random.RandomState(0)
    x = (rng.rand(512, 9, 9, 17) < 0.2).astype(np.int8)
    x[..., 16] = rng.choice([-1, 1], size=(512, 1, 1))
    p16, v16 = preds[cuda](torch.from_numpy(x).to(cuda))
    p32, v32 = preds["cpu"](torch.from_numpy(x))
    assert p16.dtype == torch.float32 and bool(torch.isfinite(v16).all())
    assert float((v16.cpu() - v32).abs().max()) <= 0.1
    assert float((p16.cpu() - p32).abs().max()) <= 0.1


@pytest.mark.gpu
def test_backup_repeats_bit_equal(cuda):
    """One move's search with a real (seeded) net, twice from the same
    state and draws: the value sums and counts repeat bit for bit."""
    search = SearchConfig(simulations=64, batch_size=32, use_symmetry=True,
                          negamax=True, max_nodes=96)
    cfg = NetConfig(blocks=2, filters=32, value_hidden=32)
    net = AZNet.from_config(9, cfg)
    net.load_state_dict(from_jax_variables(seeded_flax_variables(9, cfg, 0)))
    step = make_move_step(make_predict_fn(net.to(cuda)), search, 9)
    b = 256
    state = init_state(b, 9, search, device=cuda)
    gen = torch.Generator().manual_seed(0)
    greedy = torch.zeros(b, dtype=torch.bool, device=cuda)
    thr = torch.full((b,), float("nan"), device=cuda)
    for _ in range(3):
        state, _, _ = step(state, greedy, thr, generator=gen)
    draws = dict(noise=torch.full((b, 82), 1 / 82), syms=[1, 2],
                 gumbel=torch.zeros(b, 82))
    runs = [step(state, greedy, thr, **draws) for _ in range(2)]
    (s1, r1, _), (s2, r2, _) = runs
    assert torch.equal(r1["actions"], r2["actions"])
    for name in ("child_W", "child_N", "root_W", "root_N"):
        a, c = getattr(s1.trees, name), getattr(s2.trees, name)
        assert torch.equal(a, c), name
    assert float(s1.trees.child_W.abs().sum()) > 0


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Three float32 train steps (TF32 off) of a seeded 2x16 net on the
    card and on the CPU: loss, grad norm, parameters, BatchNorm
    statistics, momentum trace and step agree within 1e-4 (sums in
    another order)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NetConfig(blocks=2, filters=16, value_hidden=16,
                    compute_dtype="float32")
    variables = seeded_flax_variables(9, cfg, 4)
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(3):
        boards = (rng.rand(32, 9, 9, 17) < 0.3).astype(np.float32)
        policy = rng.rand(32, 82).astype(np.float32)
        batches.append((boards, policy / policy.sum(-1, keepdims=True),
                        rng.choice([-1.0, 1.0], size=32).astype(np.float32)))
    out = {}
    for d in (cuda, torch.device("cpu")):
        net = AZNet.from_config(9, cfg)
        net.load_state_dict(from_jax_variables(variables))
        state = init_train_state(net.to(d))
        step = make_train_step(make_optimizer(2e-2))
        for batch in batches:
            state, m = step(state, *(torch.from_numpy(x).to(d) for x in batch))
        out[d.type] = (state_tree(state), {k: float(v) for k, v in m.items()})
    (gpu_tree, gpu_m), (cpu_tree, cpu_m) = out["cuda"], out["cpu"]
    assert gpu_m["nonfinite"] == cpu_m["nonfinite"] == 0.0
    for k in ("loss", "grad_norm"):
        assert abs(gpu_m[k] - cpu_m[k]) <= 1e-4 * max(1.0, abs(cpu_m[k]))

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        return [t]

    assert int(gpu_tree["step"]) == int(cpu_tree["step"]) == 3
    for a, b in zip(leaves(gpu_tree), leaves(cpu_tree)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_model_291_reencodes_byte_equal_on_the_card_host(cuda, tmp_path):
    """The port's msgpack decoder and encoder on the card's machine (no
    msgpack package there): model_291 read into the net and optimiser
    state and written back is the file, byte for byte."""
    net = AZNet.from_config(9, strength_9x9_xl().net)
    state = CheckpointStore(str(MODELS)).load_state("model_291", net.to(cuda))
    CheckpointStore(str(tmp_path)).save_state("model_291", state)
    assert (tmp_path / "model_291.msgpack").read_bytes() == \
        (MODELS / "model_291.msgpack").read_bytes()


@pytest.mark.gpu
def test_gtp_genmove_19x19_kernel_path_matches_plain_path(cuda):
    """One full_19x19 search (1600 simulations in 16 rounds of 100
    leaves, 3302 slots) through the GTP engine with the dummy net and
    fixed symmetries: the card (both kernels) and the CPU (plain
    versions) choose the same vertex with bit-equal trees; the card
    launches gostep once a round and flood 4 times for the move."""
    from sejonggo_torch.config import full_19x19
    from sejonggo_torch.io.gtp import GoEngine

    search = full_19x19().search
    syms = [r % 7 for r in range(search.rounds)]
    out = {}
    for d in (cuda, "cpu"):
        eng = GoEngine(dummy_predict_fn, size=19, komi=7.5, search=search,
                       device=d, draws=lambda noise: {"syms": syms})
        eng.play(1, 3, 3)
        eng.play(-1, 15, 15)
        ops.reset_kernel_launches()
        x, y, _ = eng.genmove(1)
        if d is cuda:
            ops.check_kernel_errors(cuda)
            assert ops.kernel_launches() == {"gostep": search.rounds,
                                             "flood": 4}
        out[d] = (x, y, eng)
    (cx, cy, ce), (px, py, pe) = out[cuda], out["cpu"]
    assert (cx, cy) == (px, py)
    assert torch.equal(ce.board.cpu(), pe.board)
    for name, t in ce.tree.fields().items():
        assert torch.equal(t.cpu(), getattr(pe.tree, name)), name


@pytest.mark.gpu
def test_play_at_and_score_on_the_card_match_the_cpu(cuda):
    """A 19x19 corpus game and a 9x9 game with passes and forced colours
    through the single-board API at B=1: the card (the flood kernel, 4
    launches a move and 2 a score) and the CPU give equal boards and
    scores."""
    from sejonggo_torch.goenv import engine
    from sejonggo_torch.io.sgf import parse_sgf

    corpus = MODELS.parents[2] / "runs/full19_r5/corpus/rollout_00_000.sgf"
    games = [(19, [(p, x, y) for p, x, y in
                   parse_sgf(corpus.read_text())["moves"]])]
    rng = np.random.RandomState(0)
    games.append((9, [(int(rng.choice([-1, 1])), int(rng.randint(9)),
                       int(rng.choice([rng.randint(9), 9])))
                      for _ in range(60)]))
    for size, moves in games:
        boards = {d: engine.init_board(size, device=d) for d in (cuda, "cpu")}
        ops.reset_kernel_launches()
        for player, x, y in moves:
            for d in boards:
                if engine.legal_moves_mask(boards[d])[
                        size * size if y == size else y * size + x] or y == size:
                    boards[d], _ = engine.play_at(boards[d], x, y, player)
            assert torch.equal(boards[cuda].cpu(), boards["cpu"])
        scores = {d: engine.score(b, 7.5) for d, b in boards.items()}
        ops.check_kernel_errors(cuda)
        played = ops.kernel_launches()["flood"]
        assert played % 4 == 2 and played > 4 * len(moves) // 2
        for a, b in zip(scores[cuda], scores["cpu"]):
            assert torch.equal(a.cpu(), b)


@contextlib.contextmanager
def _plain_kernels():
    """The engine's, the heuristics' and the search's kernel calls through
    the plain PyTorch versions, on whatever device the tensors lie: the
    library's switch, with no launch while it is off."""
    before = ops.kernel_launches()
    ops.enable_cuda_kernels(False)
    try:
        yield
        assert ops.kernel_launches() == before
    finally:
        ops.enable_cuda_kernels(True)


def _midgame(games, moves, seed):
    """(boards (games, 9, 9, 17), last moves (games,)) after ``moves``
    contact-biased random legal moves, on the CPU."""
    from sejonggo_torch.goenv import engine
    from sejonggo_torch.goenv.positions import choose_actions

    rng = np.random.RandomState(seed)
    boards = engine.init_board(9, batch=games, device="cpu")
    act = np.full((games,), -1, np.int32)
    for _ in range(moves):
        illegal = engine.illegal_moves_mask_batch(boards).numpy()
        occ = ((boards[..., 0] == 1) | (boards[..., 1] == 1)).numpy()
        act = choose_actions(rng, illegal, occ, 0.8, 0.0)
        boards = engine.step_batch(boards, torch.as_tensor(act))
    return boards, torch.as_tensor(act)


def _cpu_draws(cfg, b, seed):
    """draws(round) for michi_search_batch, made on the CPU."""
    g = torch.Generator().manual_seed(seed)
    k, d, s = cfg.playout_parallel, cfg.max_depth(9), cfg.playout_cap(9)

    def draws(r):
        u = torch.rand((s, k * b, 81), generator=g).clamp(
            min=torch.finfo(torch.float32).tiny)
        return {"jitter": torch.rand((k, d, b, 82), generator=g) * 1e-6,
                "gates": torch.rand((s, k * b, 5), generator=g),
                "gumbel": -torch.log(-torch.log(u))}

    return draws


@pytest.mark.gpu
def test_michi_playout_kernel_path_matches_plain_and_cpu(cuda):
    """One heuristic playout of 64 boards: through the kernels and the
    plain versions on the card, and on the CPU, with the same draws."""
    from sejonggo_torch.config import MichiConfig
    from sejonggo_torch.search import michi

    boards, last = _midgame(64, 24, 5)
    cfg = MichiConfig()
    g = torch.Generator().manual_seed(1)
    draws = {"gates": torch.rand((162, 64, 5), generator=g),
             "gumbel": -torch.log(-torch.log(torch.rand(
                 (162, 64, 81), generator=g).clamp(min=1e-30)))}
    amaf = torch.zeros((64, 82), dtype=torch.int8)
    out = {}
    for name, dev in (("kernels", cuda), ("plain", cuda), ("cpu", "cpu")):
        ops.reset_kernel_launches()
        stats = {}
        ctx = _plain_kernels() if name == "plain" else contextlib.nullcontext()
        with ctx:
            res = michi.mc_playout_batch(
                boards.to(dev), amaf.to(dev), cfg, last.to(dev), draws=draws,
                stats=stats, return_final=True)
        out[name] = [x.cpu() for x in res]
        if name == "kernels":
            assert ops.kernel_launches() == {
                "gostep": stats["playout_steps"], "flood": 2}
    for name in ("plain", "cpu"):
        for a, b in zip(out["kernels"], out[name]):
            assert torch.equal(a, b), name
    ops.check_kernel_errors(cuda)


@pytest.mark.gpu
def test_michi_search_kernel_path_matches_plain_and_repeats(cuda):
    """A tiny michi search (3 games, 32 sims in rounds of 4, ladders on):
    through the kernels twice, through the plain versions on the card,
    and on the CPU with the same draws: every tree field bit-equal."""
    from sejonggo_torch.config import MichiConfig
    from sejonggo_torch.search import michi

    boards, last = _midgame(3, 30, 6)
    cfg = MichiConfig(n_sims=32, playout_parallel=4, expand_visits=2)
    out = {}
    for name, dev in (("kernels", cuda), ("again", cuda), ("plain", cuda),
                      ("cpu", "cpu")):
        ops.reset_kernel_launches()
        stats = {}
        ctx = _plain_kernels() if name == "plain" else contextlib.nullcontext()
        with ctx:
            t0 = michi.new_michi_tree_batch(boards.to(dev), cfg, last.to(dev),
                                            stats=stats)
            trees, active = michi.michi_search_batch(
                t0, cfg, draws=_cpu_draws(cfg, 3, 2), stats=stats)
        out[name] = ({k: v.cpu() for k, v in trees.fields().items()},
                     active.cpu())
        if name == "kernels":
            launches, counted = ops.kernel_launches(), dict(stats)
    lc, li = counted.get("ladder_calls", 0), counted.get("ladder_iters", 0)
    assert launches == {
        "gostep": counted["playout_steps"] + lc + 2 * li,
        "flood": 4 * counted["env_steps"] + 2 * counted["scores"] + li}
    for name in ("again", "plain", "cpu"):
        assert torch.equal(out["kernels"][1], out[name][1]), name
        for field, t in out["kernels"][0].items():
            assert torch.equal(t, out[name][0][field]), (name, field)
    assert int(out["kernels"][0]["n_nodes"].max()) > 1
    ops.check_kernel_errors(cuda)


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.gpu
def test_float32_net_turns_tf32_off(cuda):
    """A float32 net's forward on the card turns TF32 off for cuDNN and
    CUDA matmuls, so its outputs agree with the CPU's to float32
    rounding even when the process had TF32 on."""
    cfg = NetConfig(blocks=2, filters=24, value_hidden=24,
                    compute_dtype="float32")
    sd = from_jax_variables(seeded_flax_variables(9, cfg, 5))
    rng = np.random.RandomState(5)
    boards = (rng.rand(64, 9, 9, 17) < 0.3).astype(np.float32)
    outs = []
    with no_tf32():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        for dev in ("cpu", cuda):
            net = AZNet.from_config(9, cfg)
            net.load_state_dict(sd)
            outs.append(make_predict_fn(net.to(dev))(
                torch.from_numpy(boards).to(dev)))
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    for cpu, card in zip(*outs):
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(),
                                   atol=2e-5, rtol=1e-4)


def _rank_train_steps(batch, seed):
    """Rank side of the two-rank card test (``parallel.launch``): two
    float32 steps of a seeded 2x16 net on this rank's half of ``batch``
    on cuda:0; returns the flat parameters and statistics."""
    from sejonggo_torch.parallel import make_mesh, shard_batch

    torch.backends.cudnn.allow_tf32 = False       # float32 means float32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh()
    cfg = NetConfig(blocks=2, filters=16, value_hidden=16,
                    compute_dtype="float32")
    net = AZNet.from_config(9, cfg)
    net.load_state_dict(from_jax_variables(
        seeded_flax_variables(9, cfg, seed)))
    state = init_train_state(net.to(mesh.device))
    step = make_train_step(make_optimizer(2e-2, 0.9, 1e-4), mesh=mesh)
    local = [torch.from_numpy(shard_batch(x, mesh)).to(mesh.device)
             for x in batch]
    for _ in range(2):
        state, m = step(state, *local)
    flat = torch.cat([t.detach().reshape(-1).cpu() for t in
                      list(net.parameters()) + list(net.buffers())
                      + [state.opt_state]])
    return dict(backend=torch.distributed.get_backend(),
                device=str(mesh.device), flat=flat.numpy(),
                loss=float(m["loss"]))


@pytest.mark.gpu
def test_two_rank_train_step_on_one_card_over_gloo(cuda):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one card)
    take two steps on halves of one batch: their parameters, statistics
    and momentum are bit-equal, and within 1e-5 of one process's two
    steps on the whole batch on the card (float32 without TF32)."""
    from sejonggo_torch.parallel.launch import launch

    rng = np.random.RandomState(4)
    boards = (rng.rand(16, 9, 9, 17) < 0.3).astype(np.float32)
    boards[:8] *= rng.rand(8, 9, 9, 17) < 0.3       # sparser first half
    policy = rng.rand(16, 82).astype(np.float32) ** 4
    policy /= policy.sum(-1, keepdims=True)
    values = rng.choice([-1.0, 1.0], size=16).astype(np.float32)
    batch = (boards, policy, values)
    ranks = launch(2, f"{__file__}:_rank_train_steps", (batch, 3),
                   device="cuda:0", timeout_s=300)
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:0"]
    assert np.array_equal(ranks[0]["flat"], ranks[1]["flat"])
    cfg = NetConfig(blocks=2, filters=16, value_hidden=16,
                    compute_dtype="float32")
    net = AZNet.from_config(9, cfg)
    net.load_state_dict(from_jax_variables(seeded_flax_variables(9, cfg, 3)))
    state = init_train_state(net.to(cuda))
    step = make_train_step(make_optimizer(2e-2, 0.9, 1e-4))
    with no_tf32():
        for _ in range(2):
            state, m = step(state, *(torch.from_numpy(x).to(cuda)
                                     for x in batch))
    flat = torch.cat([t.detach().reshape(-1).cpu() for t in
                      list(net.parameters()) + list(net.buffers())
                      + [state.opt_state]]).numpy()
    np.testing.assert_allclose(ranks[0]["flat"], flat, atol=1e-5, rtol=1e-5)
    assert abs(ranks[0]["loss"] - float(m["loss"])) <= 1e-5


@pytest.mark.gpu
def test_kernel_switch_on_the_card(cuda):
    """ops.enable_cuda_kernels(False) runs every batched call site's plain
    version on the card with no launch; on again, the same calls launch
    the kernels (4 floods an env step, 2 a score, 1 gostep a leaf batch)
    and give the same bits."""
    from sejonggo_torch.goenv import engine

    stones, sides, actions = random_positions(9, 8, 20, seed=4, contact=0.8,
                                              device=cuda)
    moves = actions.reshape(8, 20)
    boards = engine.init_board(9, batch=8, device=cuda)
    for m in range(12):
        boards = engine.step_batch(boards, moves[:, m])

    def run():
        return (engine.step_batch(boards, moves[:, 12]),
                *engine.score_batch(boards, 5.5),
                *engine.step_and_illegal_stones_batch(stones, sides, actions))

    ops.reset_kernel_launches()
    ops.enable_cuda_kernels(False)
    try:
        plain = run()
        assert all(t.is_cuda for t in plain)
        assert ops.kernel_launches() == {"gostep": 0, "flood": 0}
    finally:
        ops.enable_cuda_kernels(True)
    kernels = run()
    assert ops.kernel_launches() == {"gostep": 1, "flood": 6}
    ops.check_kernel_errors(cuda)
    for a, b in zip(plain, kernels):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_trained_19x19_cut_on_the_card(cuda):
    """The play-only cut of runs/full19_r5's model_2 in the full_19x19 net
    (20 x 256, bf16) on the card: parameters bit-equal to the file, and
    predictions within 0.01 of the float32 net on the CPU (the trained
    policy head is saturated, so the policy is its output bias in both)."""
    from sejonggo_torch.config import full_19x19

    store = CheckpointStore(str(MODELS.parents[1] / "full19_r5/play_models"))
    assert store.best_name() == "model_2"
    state = from_jax_variables(store.load_variables("model_2"))
    cfg = full_19x19().net
    preds = {}
    for d, dtype in ((cuda, "bfloat16"), ("cpu", "float32")):
        net = AZNet.from_config(19, dataclasses.replace(cfg,
                                                        compute_dtype=dtype))
        net.load_state_dict(state)
        net = net.to(d)
        for name, p in net.named_parameters():
            assert torch.equal(p.detach().cpu(), torch.as_tensor(state[name]))
        preds[d] = make_predict_fn(net)
    stones, sides, actions = random_positions(19, 2, 40, seed=9, device="cpu")
    boards = engine_boards(stones, sides)
    p16, v16 = preds[cuda](boards.to(cuda))
    p32, v32 = preds["cpu"](boards)
    assert bool(torch.isfinite(p16).all()) and bool(torch.isfinite(v16).all())
    assert float((v16.cpu() - v32).abs().max()) <= 0.01
    assert float((p16.cpu() - p32).abs().max()) <= 0.01


def engine_boards(stones, sides):
    """(B, N, N, 17) plane boards holding signed grids as the side to
    move sees them (no history)."""
    own = (stones == sides[:, None, None]).to(torch.int8)
    opp = (stones == -sides[:, None, None]).to(torch.int8)
    boards = torch.zeros(stones.shape + (17,), dtype=torch.int8)
    boards[..., 0], boards[..., 1] = own, opp
    boards[..., 16] = sides[:, None, None]
    return boards
