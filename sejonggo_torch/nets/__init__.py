from sejonggo_torch.nets.azero import AZNet, make_predict_fn
from sejonggo_torch.nets.convert import from_jax_variables, seeded_flax_variables
from sejonggo_torch.nets.stub import dummy_predict_fn
