"""Multi-rank dry run: one whole ``Pipeline`` generation over a world of
ranks at tiny shapes (the port's twin of ``__graft_entry__.py``'s
``dryrun_multichip`` and of tests/test_multihost.py).

    python -m sejonggo_torch.parallel.dryrun [n] [--device cpu]

``dryrun_multichip(n)`` starts ``n`` ranks (``parallel/launch.py``), one
card each (or the CPU with ``device="cpu"``), which share a temporary
workdir and run the production loop, ``Pipeline.run(1)``: each rank's
share of the self-play games, train steps whose gradients and BatchNorm
statistics are all-reduced over the world, rank 0's checkpoint behind a
barrier, and the gate with its counts summed over the ranks.  It then
checks what only a multi-process run can break: model_2 written once (by
rank 0), the same promotion decision and best model on every rank, the
parameters bit-equal on every rank after training and equal to the
file, and the per-rank run-state and replay-segment files.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import tempfile

import numpy as np

from sejonggo_torch.config import (Config, DistConfig, EvalConfig, GoConfig,
                                   NetConfig, SearchConfig, SelfPlayConfig,
                                   TrainConfig)
from sejonggo_torch.parallel.launch import launch


def dryrun_config(n: int) -> Config:
    """The JAX dry run's shapes (5x5, a 2x16 float32 net, 8 simulations
    in rounds of 4 with symmetries): 2n self-play and gate games, a train
    batch of 2n, i.e. 2 games and 2 rows a rank.  The game batch is a
    rank's (a JAX host's) own: 2 slots."""
    return Config(
        go=GoConfig(size=5, komi=5.5),
        net=NetConfig(blocks=2, filters=16, value_hidden=16,
                      compute_dtype="float32"),
        search=SearchConfig(simulations=8, batch_size=4, use_symmetry=True),
        selfplay=SelfPlayConfig(num_games=2 * n, stop_exploration=4,
                                game_batch=2),
        train=TrainConfig(batch_size=2 * n, iters_per_epoch=2,
                          epochs_per_save=1, replay_window=4096),
        eval=EvalConfig(num_games=2 * n),
        dist=DistConfig(dp=n))


def state_digest(state) -> str:
    """sha256 of a train state's parameters, BatchNorm statistics,
    momentum trace and step, bit for bit."""
    h = hashlib.sha256()
    for t in (list(state.net.parameters()) + list(state.net.buffers())
              + [state.opt_state, state.step]):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_generation(workdir: str, n: int) -> dict:
    from sejonggo_torch.parallel import make_mesh, process_index
    from sejonggo_torch.pipeline import Pipeline

    mesh = make_mesh(n)
    pipe = Pipeline(dryrun_config(n), workdir, seed=0, mesh=mesh)
    assert pipe.mesh is mesh and (mesh.size, mesh.rank) == \
        (n, process_index()), "the mesh spans the world"
    saved, trained = [], []
    real_save, real_step = pipe.store.save_state, pipe.train_step

    def save_state(name, state):
        saved.append(name)
        real_save(name, state)

    def train_step(*args):
        out = real_step(*args)
        trained[:] = [out[0]]
        return out

    pipe.store.save_state, pipe.train_step = save_state, train_step
    pipe._segment_games = []          # publish this rank's games too
    (gen,) = pipe.run(generations=1)
    segment = pipe._publish_segment()
    mesh.barrier()                    # every rank's files are written
    latest = pipe.store.latest_name()
    written = pipe.store.load_state(latest, pipe._net())
    return dict(
        rank=process_index(), saved=saved, latest=latest, best=gen["best"],
        promote=gen["evaluate"].get("promote"),
        winrate=gen["evaluate"].get("winrate"),
        eval_games=gen["evaluate"].get("games"),
        selfplay_games=gen["selfplay"]["games"],
        selfplay_moves=gen["selfplay"]["moves"],
        train_steps=gen["train"]["steps"], loss=gen["train"]["loss"],
        trained=state_digest(trained[0]), written=state_digest(written),
        segment=os.path.basename(segment) if segment else None,
        files=sorted(os.listdir(workdir)))


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = 900.0) -> list:
    """One full Pipeline generation on ``n_devices`` ranks (tiny shapes)
    with the checks above; returns the ranks' reports."""
    with tempfile.TemporaryDirectory(prefix="sejonggo_dryrun_") as workdir:
        reports = launch(n_devices, "sejonggo_torch.parallel.dryrun:"
                         "_rank_generation", (workdir, n_devices),
                         device=device, timeout_s=timeout_s)
    first = reports[0]
    for r in reports:
        assert r["latest"] == "model_2", r
        assert r["saved"] == (["model_1", "model_2"] if r["rank"] == 0
                              else []), f"rank {r['rank']} wrote {r['saved']}"
        for k in ("promote", "best", "winrate", "eval_games", "trained"):
            assert r[k] == first[k], f"rank {r['rank']} {k} differs: {r}"
        assert r["trained"] == r["written"], \
            f"rank {r['rank']}: model_2 on disk differs from its state"
        assert r["selfplay_moves"] > 0 and r["train_steps"] == 2, r
        assert np.isfinite(r["loss"]), r
        assert r["segment"] == f"seg_p{r['rank']}_000000.npz", r
    files = set(first["files"])
    for i in range(n_devices):
        assert {f"run_state_p{i}.json", f"replay_p{i}.npz"} <= files, files
    assert first["eval_games"] == 2 * n_devices
    print(f"dryrun_multichip({n_devices}): full Pipeline generation on "
          f"{n_devices} ranks OK — selfplay "
          f"{sum(r['selfplay_moves'] for r in reports)} moves "
          f"({[r['selfplay_moves'] for r in reports]} by rank), train loss "
          f"{first['loss']:.4f}, parameters bit-equal on every rank and on "
          f"disk, eval winrate {first['winrate']:.2f} over "
          f"{first['eval_games']} games, promote {first['promote']} on "
          f"every rank", flush=True)
    return reports


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-rank pipeline dry run")
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU (default: a card "
                    "per rank, or ranks sharing one card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
