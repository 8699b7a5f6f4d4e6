from sejonggo_torch.learn.checkpoint import CheckpointStore
from sejonggo_torch.learn.evaluate import evaluate_models
from sejonggo_torch.learn.msgpack import restore
