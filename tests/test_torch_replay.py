"""The port's replay buffer against the JAX package's: the same stream
of games, game batches and samples gives the same ring contents,
counters and sampled rows for one seed (the ring wraps around several
times), and each side loads the other's buffer snapshots and segments."""
import numpy as np

from sejonggo_tpu.actor.selfplay import GameBatch as JGameBatch
from sejonggo_tpu.learn import replay as jreplay
from sejonggo_torch.actor import GameBatch
from sejonggo_torch.learn import replay as treplay

SIZE, A = 9, 82


def _game(rng, t):
    players = np.where(np.arange(t) % 2 == 0, 1, -1).astype(np.int32)
    return {"boards": (rng.rand(t, SIZE, SIZE, 17) < 0.3).astype(np.int8),
            "policies": rng.rand(t, A).astype(np.float32),
            "values": rng.randn(t).astype(np.float32),
            "players": players, "winner": int(rng.choice([-1, 0, 1]))}


def _batch_fields(rng, t, b):
    valid = np.arange(t)[:, None] < rng.randint(1, t + 1, size=b)[None]
    return dict(
        boards=(rng.rand(t, b, SIZE, SIZE, 17) < 0.3).astype(np.int8),
        policy_targets=rng.rand(t, b, A).astype(np.float32),
        values=rng.randn(t, b).astype(np.float32),
        actions=rng.randint(0, A, size=(t, b)).astype(np.int32),
        players=np.where(np.arange(t) % 2 == 0, 1, -1)[:, None].repeat(b, 1),
        move_valid=valid, tree_fresh=np.zeros((t, b), bool),
        winners=rng.choice([-1, 0, 1], size=b).astype(np.int32),
        resign_winners=np.zeros(b, np.int32),
        black_points=np.zeros(b), white_points=np.zeros(b),
        end_reasons=np.zeros(b, np.int32), num_moves=valid.sum(0),
        model1_isblack=np.ones(b, bool))


def _fill(buffers, seed=7):
    """Feed every buffer the same stream; returns the sampled rows."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(18):
        kind = i % 3
        if kind == 0:
            game = _game(rng, rng.randint(0, 30))
            added = {b.add_game(game) for b in buffers}
        elif kind == 1:
            fields = _batch_fields(rng, rng.randint(2, 12), 3)
            added = {buffers[0].add_game_batch(JGameBatch(**fields)),
                     buffers[1].add_game_batch(GameBatch(**fields))}
        else:
            game = _game(rng, rng.randint(1, 25))
            rows = treplay.game_samples(game)
            added = {b.add_samples(*rows) for b in buffers}
        assert len(added) == 1
        if len(buffers[0]):
            samples.append([b.sample(16) for b in buffers])
    return samples


def _same_buffer(a, b):
    for k in ("boards", "policies", "values"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for k in ("cursor", "filled", "total_games", "total_moves", "capacity"):
        assert getattr(a, k) == getattr(b, k), k


def test_replay_stream_and_samples_match_jax():
    jbuf = jreplay.ReplayBuffer(30, SIZE, seed=3)
    tbuf = treplay.ReplayBuffer(30, SIZE, seed=3)
    samples = _fill([jbuf, tbuf])
    assert jbuf.total_moves > 3 * jbuf.capacity      # wrapped around
    _same_buffer(jbuf, tbuf)
    assert len(samples) >= 10
    for js, ts in samples:
        for a, b in zip(js, ts):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_game_samples_match_jax():
    rng = np.random.RandomState(1)
    for t in (0, 1, 17):
        game = _game(rng, t)
        for a, b in zip(jreplay.game_samples(game), treplay.game_samples(game)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_each_side_loads_the_others_files(tmp_path):
    jbuf = jreplay.ReplayBuffer(30, SIZE, seed=3)
    tbuf = treplay.ReplayBuffer(30, SIZE, seed=3)
    _fill([jbuf, tbuf], seed=9)
    jbuf.save(str(tmp_path / "j.npz"))
    tbuf.save(str(tmp_path / "t.npz"))
    _same_buffer(treplay.ReplayBuffer.load(str(tmp_path / "j.npz"), 30, SIZE),
                 jreplay.ReplayBuffer.load(str(tmp_path / "t.npz"), 30, SIZE))
    # a smaller window keeps the first rows, as the JAX loader does
    _same_buffer(treplay.ReplayBuffer.load(str(tmp_path / "j.npz"), 20, SIZE),
                 jreplay.ReplayBuffer.load(str(tmp_path / "t.npz"), 20, SIZE))
    rows = treplay.game_samples(_game(np.random.RandomState(2), 11))
    jreplay.save_segment(str(tmp_path / "j_seg.npz"), *rows)
    treplay.save_segment(str(tmp_path / "t_seg.npz"), *rows)
    for got in (treplay.load_segment(str(tmp_path / "j_seg.npz")),
                jreplay.load_segment(str(tmp_path / "t_seg.npz"))):
        for a, b in zip(got, rows):
            np.testing.assert_array_equal(a, b)
    assert not list(tmp_path.glob("*.tmp"))
