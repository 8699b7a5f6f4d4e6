from sejonggo_torch.goenv.engine import (
    NUM_PLANES,
    SWAP_INDEX,
    illegal_moves_mask_batch,
    illegal_moves_mask_stones_batch,
    init_board,
    score_batch,
    signed_stones,
    step_and_illegal_stones_batch,
    step_batch,
    step_stones_batch,
    to_features,
)
from sejonggo_torch.goenv.coords import (
    coord2index,
    gtp_to_xy,
    index2coord,
    xy_to_gtp,
)
