from sejonggo_torch.search.mcts import (
    advance_root_batch,
    collect_leaves,
    decide_batch,
    expand_backup,
    leaf_features,
    policy_target_batch,
    run_search,
    simulate_round,
)
from sejonggo_torch.search.michi import (
    MichiSearcher,
    MichiTree,
    michi_genmove_batch,
    michi_search_batch,
    new_michi_tree_batch,
)
from sejonggo_torch.search.tree import (
    Tree,
    new_tree_batch,
    sample_dirichlet,
    tree_capacity,
    tree_where,
)
