from sejonggo_torch.learn.checkpoint import CheckpointStore
from sejonggo_torch.learn.evaluate import evaluate_models
from sejonggo_torch.learn.msgpack import packb, restore
from sejonggo_torch.learn.replay import (ReplayBuffer, game_samples,
                                         load_segment, save_segment)
from sejonggo_torch.learn.train import (PlateauScheduler, TrainState,
                                        init_train_state, make_optimizer,
                                        make_train_step)
