"""Typed configuration (a copy of the parts of sejonggo_tpu/config.py the
port uses: GoConfig, NetConfig, SearchConfig, MichiConfig,
SelfPlayConfig, TrainConfig, EvalConfig, Config, the 9x9 presets and
full_19x19).

Kept as its own copy so the port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GoConfig:
    """Board/game parameters (reference conf.py:33-34)."""

    size: int = 19
    komi: float = 5.5

    @property
    def num_actions(self) -> int:
        return self.size * self.size + 1  # + pass

    @property
    def max_moves(self) -> int:
        # Reference move cap: 2 * SIZE^2 (self_play.py:181)
        return 2 * self.size * self.size


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """AlphaZero residual network (reference conf.py:23, model.py:55-95)."""

    blocks: int = 20
    filters: int = 256
    value_hidden: int = 256
    policy_filters: int = 2
    value_filters: int = 2
    l2: float = 1e-4
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """MCTS parameters (reference conf.py:29-38, play.py:18)."""

    simulations: int = 1600       # MCTS_SIMULATIONS
    batch_size: int = 100         # MCTS_BATCH_SIZE: leaves per NN call
    c_puct: float = 1.0
    dirichlet_alpha: float = 0.03
    dirichlet_epsilon: float = 0.25
    # False replicates the reference's root-perspective backup;
    # True is the AlphaZero negamax backup.
    negamax: bool = False
    policy_target: str = "prior"  # 'prior' | 'visits'
    use_symmetry: bool = True
    # Node capacity of the array tree; 0 = auto (simulations + slack).
    max_nodes: int = 0

    @property
    def rounds(self) -> int:
        return self.simulations // self.batch_size

    def capacity(self) -> int:
        if self.max_nodes:
            return self.max_nodes
        return 2 * self.simulations + self.batch_size + 2


@dataclasses.dataclass(frozen=True)
class MichiConfig:
    """Model-free michi-style RAVE engine (reference conf.py:84-105,
    mcts1/).  Defaults mirror the reference knobs."""

    n_sims: int = 1400             # N_SIMS
    expand_visits: int = 8         # EXPAND_VISITS
    rave_equiv: float = 3500.0     # RAVE_EQUIV
    prior_even: float = 10.0       # PRIOR_EVEN (pw gets half)
    prior_capture_one: float = 15.0
    prior_capture_many: float = 30.0
    prior_pat3: float = 10.0
    prior_cfg: Tuple[float, ...] = (24.0, 22.0, 8.0)
    prior_empty_area: float = 10.0
    prior_selfatari: float = 10.0  # negative prior (pw += 0)
    prior_largepattern: float = 100.0
    resign_thres: float = 0.2      # RESIGN_THRES
    fastplay20: float = 0.8        # FASTPLAY20_THRES
    fastplay5: float = 0.95        # FASTPLAY5_THRES
    prob_capture: float = 0.9      # PROB_HEURISTIC['capture']
    prob_pat3: float = 0.95        # PROB_HEURISTIC['pat3']
    prob_ssareject: float = 0.9    # PROB_SSAREJECT
    prob_rsareject: float = 0.5    # PROB_RSAREJECT
    use_ladders: bool = True       # read ladders in the priors
    # k descents per round (each visit doubles as the virtual loss,
    # reference tree_search.py:35), then one batched playout over k*B
    # boards, then the k updates; 1 = strictly sequential simulations
    playout_parallel: int = 16
    komi: float = 5.5
    max_tree_depth: int = 0        # 0 = min(2*size^2, node capacity)
    capacity: int = 0              # node slots; 0 = auto

    def node_capacity(self) -> int:
        if self.capacity:
            return self.capacity
        # one slot per expand_visits simulations, plus root + slack
        return self.n_sims // max(self.expand_visits, 1) + 8

    def max_depth(self, size: int) -> int:
        return self.max_tree_depth or min(2 * size * size,
                                          self.node_capacity())

    def playout_cap(self, size: int) -> int:
        # MAX_GAME_LEN = 2 * N^2 (tree_search.py:8)
        return 2 * size * size


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    """Self-play parameters (reference conf.py:27-40)."""

    num_games: int = 5000          # N_GAMES
    stop_exploration: int = 30     # STOP_EXPLORATION (temperature -> 0)
    resignation_percent: float = 0.10
    resignation_allowed_error: float = 0.05
    # Upper bound on the calibrated resign threshold (None = pure
    # reference calibration); guards the cold-start collapse where a weak
    # value head resigns whole batches at move 0 (actor/resign.py).
    resignation_cap: Optional[float] = None
    # Number of games stepped in lockstep on the device.
    game_batch: int = 32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training schedule (reference conf.py:43-49, model.py:93)."""

    batch_size: int = 32           # TRAIN_BATCH_SIZE
    iters_per_epoch: int = 64      # NUM_WORKERS (misnamed in reference)
    epochs_per_save: int = 300     # EPOCHS_PER_SAVE
    lr: float = 1e-2
    momentum: float = 0.9
    replay_window: int = 500_000   # N_MOST_RECENT_GAMES, counted in moves
    # 'reference' applies mse+crossentropy to BOTH heads (model.py:49-52
    # quirk); 'agz' is crossentropy(policy) + mse(value).
    loss_mode: str = "agz"
    # ReduceLROnPlateau (reference main_training.py:72): after
    # `lr_plateau_patience` train phases without loss improvement, LR is
    # multiplied by `lr_plateau_factor` (0.0 disables), floored at
    # `lr_min`.
    lr_plateau_factor: float = 0.0
    lr_plateau_patience: int = 8
    lr_min: float = 1e-4
    # Abort a train phase after this many CONSECUTIVE non-finite-loss
    # batches (each one skips its update; reference TerminateOnNaN,
    # train.py:34).
    max_consecutive_nonfinite: int = 8


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluator gating (reference conf.py:52-53, evaluator.py:23-47)."""

    num_games: int = 100           # EVALUATE_N_GAMES
    margin: float = 0.55           # EVALUATE_MARGIN
    # Optional move cap for evaluation games; None = 2*N*N.  Games cut at
    # the cap are decided by area score, as every game is.
    max_moves: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Data-parallel layout (replaces reference conf.py:57-82 host lists).
    The port runs one process per card (``sejonggo_torch/parallel``)."""

    # Ranks over which the train batch is split.  0 = every rank of the
    # process group; any other value must equal the group's size.
    dp: int = 0
    mesh_axis_name: str = "dp"


@dataclasses.dataclass(frozen=True)
class Config:
    """The slices of the JAX package's Config that the port runs."""

    go: GoConfig = dataclasses.field(default_factory=GoConfig)
    net: NetConfig = dataclasses.field(default_factory=NetConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    selfplay: SelfPlayConfig = dataclasses.field(default_factory=SelfPlayConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    dist: DistConfig = dataclasses.field(default_factory=DistConfig)
    model_dir: str = "sp_models"
    selfplay_dir: str = "sp_self_play_data"
    log_dir: str = "logs"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def small_9x9(**overrides) -> Config:
    """9x9 bring-up config (sejonggo_tpu.config.small_9x9)."""
    cfg = Config(
        go=GoConfig(size=9, komi=5.5),
        net=NetConfig(blocks=4, filters=64, value_hidden=64,
                      compute_dtype="float32"),
        search=SearchConfig(simulations=64, batch_size=8),
        selfplay=SelfPlayConfig(num_games=16, stop_exploration=8,
                                game_batch=8),
        train=TrainConfig(batch_size=32, iters_per_epoch=8,
                          epochs_per_save=2, replay_window=512),
        eval=EvalConfig(num_games=8),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def strength_9x9(**overrides) -> Config:
    """9x9 strength config (sejonggo_tpu.config.strength_9x9)."""
    cfg = Config(
        go=GoConfig(size=9, komi=5.5),
        net=NetConfig(blocks=6, filters=96, value_hidden=96,
                      compute_dtype="bfloat16"),
        search=SearchConfig(simulations=96, batch_size=16,
                            dirichlet_alpha=0.15, negamax=True,
                            policy_target="visits", max_nodes=128),
        # resignation off (holdout 100%): a cold value head death-spirals
        # even under a capped threshold
        selfplay=SelfPlayConfig(num_games=512, stop_exploration=12,
                                game_batch=512, resignation_percent=1.0),
        train=TrainConfig(batch_size=256, iters_per_epoch=64,
                          epochs_per_save=4, replay_window=80_000,
                          lr=2e-2, lr_plateau_factor=0.5,
                          lr_plateau_patience=12, lr_min=2e-3),
        eval=EvalConfig(num_games=128),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def strength_9x9_xl(**overrides) -> Config:
    """Scaled 9x9 strength point (sejonggo_tpu.config.strength_9x9_xl):
    the strength_9x9 net (6x96, bf16), 192 simulations in rounds of 32
    leaves, 256 tree slots, calibrated resignation live under a -0.90
    cap, 384 games in lockstep, learning rate 1e-2."""
    base = strength_9x9()
    cfg = base.replace(
        search=dataclasses.replace(base.search, simulations=192,
                                   batch_size=32, max_nodes=256),
        selfplay=dataclasses.replace(
            base.selfplay, resignation_percent=0.10,
            resignation_cap=-0.90, game_batch=384),
        train=dataclasses.replace(base.train, lr=1e-2),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def full_19x19(**overrides) -> Config:
    """Full-scale 19x19 config matching the reference's deployment
    (sejonggo_tpu.config.full_19x19): Config() as it stands, 20 blocks x
    256 filters, 1600 simulations in rounds of 100 leaves."""
    cfg = Config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
