"""Game I/O: SGF files, the reference's HDF5 sample layout, the GTP
engine (``io.gtp``, not imported here so that ``python -m
sejonggo_torch.io.gtp`` runs it cleanly) and the KGS pretraining data
path (``io.kgs``); port of sejonggo_tpu/io."""
from sejonggo_torch.io.sgf import parse_sgf, game_to_sgf, save_game_sgf
from sejonggo_torch.io.h5data import save_self_play_data, load_move_sample
