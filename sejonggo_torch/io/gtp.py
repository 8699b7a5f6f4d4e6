"""GTP (Go Text Protocol) frontend (port of sejonggo_tpu/io/gtp.py).

Reference counterpart: sejonggo.py — SejongGoEngine (board + reusable
MCTS tree across moves, sejonggo.py:19-69) and GTPEngine (getattr
command dispatch over stdin/stdout, sejonggo.py:71-178), including the
skipped-letter-'I' vertex convention (sejonggo.py:102-126).

The engine runs on one device (CUDA unless ``--device`` names another):
``genmove`` searches with the gostep kernel once a round, ``play`` floods
through the flood kernel four times a move and ``final_score`` twice.
Where the JAX engine splits a key, the port draws from a CPU
``torch.Generator`` seeded from ``seed``, or takes the draws from a
``draws`` callable (the tests hand in JAX's).  ``--engine michi`` plays
the model-free michi/RAVE engine (search/michi.py): its playouts step
through the gostep kernel every step.

Run: python -m sejonggo_torch.io.gtp --preset tiny [--dummy | --model-dir DIR
     | --engine michi [--sims N] [--spat F --prob F]] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import types
from typing import Callable, Optional

import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import (Config, MichiConfig, SearchConfig,
                                   full_19x19, small_9x9, strength_9x9)
from sejonggo_torch.goenv import engine, gtp_to_xy, xy_to_gtp
from sejonggo_torch.search import (advance_root_batch, decide_batch,
                                   new_tree_batch, run_search,
                                   sample_dirichlet)
from sejonggo_torch.search.michi import MichiSearcher, best_root_stats
from sejonggo_torch.search.pattern_lut import build_small_pattern_lut
from sejonggo_torch.search.patterns import PatternStore, root_prior_bonus

COLOR_TO_PLAYER = {"B": 1, "W": -1, "b": 1, "w": -1}


class GoEngine:
    """Single-game engine: board + reusable tree (sejonggo.py:19-69).

    ``predict(boards) -> (policies, values)`` on ``device``.  ``draws``,
    when given, is called once per searched genmove with whether root
    noise is wanted and returns {"noise": (1, A), "syms": one D4 id per
    round, "gumbel": (1, A)} (any key may be absent)."""

    def __init__(self, predict: Callable, *, size: int, komi: float,
                 search: SearchConfig, resign: Optional[float] = None,
                 temperature: int = 0, add_noise: bool = False, seed: int = 0,
                 device=None, draws: Optional[Callable[[bool], dict]] = None):
        self.predict = predict
        self.size = size
        self.komi = komi
        self.search = search
        self.resign = resign
        self.temperature = temperature
        self.add_noise = add_noise
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(seed)
        self.draws = draws
        self.clear()

    def clear(self):
        self.board = engine.init_board(self.size, device=self.device)
        self.tree = None
        self.tree_valid = False
        self.move_n = 0

    @property
    def player(self) -> int:
        return int(self.board[0, 0, 16])

    def play(self, color: int, x: int, y: int, update_tree: bool = True):
        """Apply an external (or own) move; advance the reused tree if
        it knows this child, else drop it (sejonggo.py:34-45)."""
        action = self.size * self.size if y >= self.size else y * self.size + x
        new_board, _ = engine.play_at(self.board, x, y, color)
        if update_tree and self.tree_valid:
            trees, valid = advance_root_batch(
                self.tree, torch.tensor([action], device=self.device),
                new_board[None], reserve=self.search.simulations)
            self.tree = trees
            self.tree_valid = bool(valid[0])
        else:
            self.tree_valid = False
        self.board = new_board
        self.move_n += 1
        return self.board

    def _draws(self, noise: bool) -> dict:
        if self.draws is not None:
            return self.draws(noise)
        if not noise:
            return {}
        a = self.size * self.size + 1
        return {"noise": sample_dirichlet(self.search.dirichlet_alpha, 1, a,
                                          self.generator)}

    def genmove(self, color: int):
        """Returns (x, y, value); y == size means pass, y == size+1 means
        resign (reference sejonggo.py:47-69 marker)."""
        if self.player != color:
            # force the side to move like make_play(color=...) does; the
            # kept tree stays valid, as in the JAX engine
            self.board = engine._swap_sides(self.board)
        feats = self.board[None].to(torch.float32)
        policies, values = self.predict(feats)
        value = float(values[0, 0])
        if self.resign is not None and value <= self.resign:
            return 0, self.size + 1, value

        draws = self._draws(self.add_noise and not self.tree_valid)
        if not self.tree_valid:
            self.tree = new_tree_batch(
                policies, self.board[None], self.search.capacity(),
                noise=draws.get("noise"),
                epsilon=self.search.dirichlet_epsilon)
            self.tree_valid = True

        self.tree = run_search(
            self.tree, self.predict, simulations=self.search.simulations,
            batch_size=self.search.batch_size, c_puct=self.search.c_puct,
            negamax=self.search.negamax,
            use_symmetry=self.search.use_symmetry, syms=draws.get("syms"),
            generator=self.generator)
        greedy = torch.tensor([self.temperature == 0])
        action = int(decide_batch(self.tree, greedy, self.generator,
                                  gumbel=draws.get("gumbel"))[0])
        x, y = (action % self.size, action // self.size) \
            if action < self.size * self.size else (0, self.size)
        self.play(color, x, y)
        return x, y, value


class MichiEngine:
    """Single-game michi-style engine (model-free RAVE search), speaking
    the same GTP protocol as GoEngine.  Resigns below
    MichiConfig.resign_thres (conf.py:89 RESIGN_THRES).

    With pattern files, the small-radius table reaches every in-tree
    expansion and the full-radius host matcher boosts the root
    (tree_node.py:81-86).  ``draws``, when given, is called once per
    genmove and returns the searcher's draws(chunk, round); else they
    come from a generator on ``device`` seeded with ``seed``."""

    def __init__(self, *, size: int, komi: float,
                 michi: Optional[MichiConfig] = None, seed: int = 0,
                 spat_file: Optional[str] = None,
                 prob_file: Optional[str] = None, device=None,
                 draws: Optional[Callable[[], Callable]] = None):
        self.size = size
        self.komi = komi
        self.cfg = michi or MichiConfig(komi=komi)
        self.search = types.SimpleNamespace(simulations=self.cfg.n_sims)
        self.device = resolve_device(device)
        self.seed = seed
        self.draws = draws
        self._searcher = None
        self._key = None
        self.last_sims = 0
        self.patterns = PatternStore()
        if spat_file and prob_file:
            self.patterns.load_spat(spat_file)
            self.patterns.load_probs(prob_file)
        self.clear()

    def clear(self):
        self.board = engine.init_board(self.size, device=self.device)
        self.move_n = 0
        self.last_action = -1

    @property
    def player(self) -> int:
        return int(self.board[0, 0, 16])

    def play(self, color: int, x: int, y: int, update_tree: bool = True):
        self.board, _ = engine.play_at(self.board, x, y, color)
        self.last_action = (self.size * self.size if y >= self.size
                            else y * self.size + x)
        self.move_n += 1
        return self.board

    def searcher(self):
        """The MichiSearcher for the current komi (rebuilt when it
        changes); its generator carries across genmoves."""
        if self._searcher is None or self._key != self.komi:
            lut = (build_small_pattern_lut(self.patterns) if self.patterns
                   else None)
            self._searcher = MichiSearcher(
                dataclasses.replace(self.cfg, komi=self.komi),
                pattern_lut=lut, device=self.device, seed=self.seed)
            self._key = self.komi
        return self._searcher

    def genmove(self, color: int):
        """Returns (x, y, winrate); y == size means pass, y == size + 1
        means resign."""
        if self.player != color:
            self.board = engine._swap_sides(self.board)
        searcher = self.searcher()
        # the move before drives the root CFG locality prior
        last = torch.tensor([self.last_action], dtype=torch.int32)
        bonus = None
        if self.patterns:
            bonus = torch.from_numpy(root_prior_bonus(
                self.patterns, self.board, self.cfg.prior_largepattern))[None]
        trees = searcher.search(
            self.board[None], last, bonus,
            draws=None if self.draws is None else self.draws())
        acts, wrs = best_root_stats(trees)
        action, wr = int(acts[0]), float(wrs[0])
        self.last_sims = int(trees.root_v[0])
        print(f"michi genmove: {self.last_sims} simulations, winrate "
              f"{wr:.4f}", file=sys.stderr, flush=True)
        if wr < self.cfg.resign_thres:
            return 0, self.size + 1, wr
        x, y = (action % self.size, action // self.size) \
            if action < self.size * self.size else (0, self.size)
        self.play(color, x, y)
        return x, y, wr


class GTPFrontend:
    """GTP v2 command loop (reference GTPEngine sejonggo.py:71-160)."""

    def __init__(self, engine_: GoEngine, name: str = "sejonggo-torch"):
        self.engine = engine_
        self._name = name
        self._komi = engine_.komi
        self._quit = False

    # --- commands ------------------------------------------------------

    def protocol_version(self):
        return "2"

    def name(self):
        return f"{self._name} - {self.engine.search.simulations} simulations"

    def version(self):
        from sejonggo_torch import __version__

        return __version__

    def list_commands(self):
        return "\n".join(
            c for c in dir(self)
            if not c.startswith("_") and callable(getattr(self, c))
            and c not in ("parse_command", "run"))

    def known_command(self, name):
        """GTP v2 §6.3.4 capability probe (GoGui/Sabaki issue it before
        using optional commands)."""
        return ("true" if name in self.list_commands().split("\n")
                else "false")

    def boardsize(self, size):
        if int(size) != self.engine.size:
            raise ValueError(
                f"configured for {self.engine.size}x{self.engine.size}, "
                f"GTP asked for {size}x{size}")
        return ""

    def komi(self, komi):
        self._komi = float(komi)
        self.engine.komi = float(komi)
        return ""

    def clear_board(self):
        self.engine.clear()
        return ""

    def play(self, color, vertex):
        player = COLOR_TO_PLAYER[color[0]]
        n = self.engine.size
        x, y = gtp_to_xy(vertex, n)
        if (x, y) != (0, n) and not (0 <= x < n and 0 <= y < n):
            # the JAX engine plays such a vertex as a clamped index
            raise ValueError(f"vertex {vertex} is off the {n}x{n} board")
        self.engine.play(player, x, y)
        return ""

    def genmove(self, color):
        player = COLOR_TO_PLAYER[color[0]]
        x, y, value = self.engine.genmove(player)
        if y == self.engine.size + 1:
            return "resign"
        return xy_to_gtp(x, y, self.engine.size)

    def showboard(self):
        return "\n" + engine.show_board(self.engine.board)

    def final_score(self):
        w, b, wh = engine.score(self.engine.board, self._komi)
        w = int(w)
        if w == 0:
            return "0"
        return ("B+" if w == 1 else "W+") + str(abs(float(b) - float(wh)))

    def sg_showtree(self, max_depth="2", top_k="5"):
        """Debug dump of the reused search tree + consistency check
        (reference show_tree/tree_depth play.py:355-374; private
        extension command, hence the sg_ prefix)."""
        from sejonggo_torch.search import tree_debug

        t = getattr(self.engine, "tree", None)
        if t is None or not getattr(self.engine, "tree_valid", False):
            return "no tree (genmove first)"
        if not hasattr(t, "child_idx"):
            return "engine has no array tree"
        ht = tree_debug.extract_tree(t, 0)
        out = tree_debug.show_tree(ht, self.engine.size,
                                   int(max_depth), int(top_k))
        problems = tree_debug.check_consistency(ht)
        if problems:
            out += "\nINCONSISTENT: " + "; ".join(problems[:5])
        pv = tree_debug.principal_variation(ht, self.engine.size)
        out += "\npv: " + " ".join(c for c, _, _ in pv)
        return "\n" + out

    def quit(self):
        self._quit = True
        return ""

    # --- loop ----------------------------------------------------------

    def parse_command(self, line: str) -> str:
        tokens = line.strip().split()
        if not tokens:
            return ""
        cmd_id = ""
        if tokens[0].isdigit():
            cmd_id = tokens[0]
            tokens = tokens[1:]
        command, args = tokens[0], tokens[1:]
        try:
            method = getattr(self, command)
            result = method(*args)
        except Exception as e:  # noqa: BLE001 — GTP reports errors inline
            return f"?{cmd_id} {e}\n\n"
        if not str(result).strip():
            return f"={cmd_id}\n\n"
        return f"={cmd_id} {result}\n\n"

    def run(self, infile=sys.stdin, outfile=sys.stdout):
        for line in infile:
            for cmd in line.split("\n"):
                if not cmd.strip():
                    continue
                result = self.parse_command(cmd)
                if result.strip():
                    outfile.write(result)
                    outfile.flush()
            if self._quit:
                break


def _build_engine(args):
    cfg: Config = {"tiny": small_9x9, "strength": strength_9x9,
                   "full": full_19x19}[args.preset]()
    device = resolve_device(args.device)
    if args.engine == "michi":
        michi = MichiConfig(komi=cfg.go.komi, n_sims=args.sims) \
            if args.sims else MichiConfig(komi=cfg.go.komi)
        return MichiEngine(size=cfg.go.size, komi=cfg.go.komi, michi=michi,
                           spat_file=args.spat, prob_file=args.prob,
                           device=device)
    if args.dummy or args.engine == "dummy":
        from sejonggo_torch.nets import dummy_predict_fn

        return GoEngine(dummy_predict_fn, size=cfg.go.size, komi=cfg.go.komi,
                        search=cfg.search, device=device)
    from sejonggo_torch.learn import CheckpointStore
    from sejonggo_torch.nets import AZNet, from_jax_variables, make_predict_fn

    store = CheckpointStore(args.model_dir)
    name = args.checkpoint or store.best_name() or store.latest_name()
    if name is None:
        raise SystemExit(f"no checkpoint found in {args.model_dir}")
    net = AZNet.from_config(cfg.go.size, cfg.net)
    net.load_state_dict(from_jax_variables(store.load_variables(name)))
    return GoEngine(make_predict_fn(net.to(device)), size=cfg.go.size,
                    komi=cfg.go.komi, search=cfg.search, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="sejonggo_torch GTP engine")
    parser.add_argument("--preset", choices=["tiny", "strength", "full"],
                        default="full")
    parser.add_argument("--model-dir", default="sp_models")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--dummy", action="store_true",
                        help="play with the deterministic stub net")
    parser.add_argument("--engine", choices=["net", "dummy", "michi"],
                        default="net",
                        help="michi = model-free RAVE engine (mcts1 parity)")
    parser.add_argument("--sims", type=int, default=0,
                        help="override simulations for --engine michi")
    parser.add_argument("--spat", default=None,
                        help="pachi .spat pattern file for --engine michi")
    parser.add_argument("--prob", default=None,
                        help="pachi .prob pattern file for --engine michi")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on "
                        "the CPU)")
    args = parser.parse_args(argv)
    engine_ = _build_engine(args)
    frontend = GTPFrontend(engine_)
    print("GTP engine ready", file=sys.stderr)
    frontend.run()
    if engine_.device.type == "cuda":
        import json

        from sejonggo_torch import ops

        print(f"kernel launches: {json.dumps(ops.kernel_launches())}",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
