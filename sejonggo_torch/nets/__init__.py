from sejonggo_torch.nets.azero import (AZNet, batch_norms, fold_batch_stats,
                                      make_predict_fn)
from sejonggo_torch.nets.convert import (from_jax_variables, init_variables,
                                        seeded_flax_variables, to_jax_params,
                                        to_jax_variables)
from sejonggo_torch.nets.losses import az_loss
from sejonggo_torch.nets.stub import dummy_predict_fn
