from sejonggo_torch.actor.continuous import ContinuousSelfPlay
from sejonggo_torch.actor.resign import ResignCalibrator
from sejonggo_torch.actor.selfplay import (GameBatch, MoveState, init_state,
                                          make_move_step, play_games)
