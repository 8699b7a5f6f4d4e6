from sejonggo_torch.actor.selfplay import MoveState, init_state, make_move_step
