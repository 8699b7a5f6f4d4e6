"""Data parallelism over a ``torch.distributed`` process group, one rank
per card (port of sejonggo_tpu/parallel)."""
from sejonggo_torch.parallel.dist import (backend, init_distributed,
                                          local_game_slice,
                                          process_count, process_index,
                                          rank_device, rank_seed, shutdown)
from sejonggo_torch.parallel.mesh import (Mesh, host_local_batch, make_mesh,
                                          replicate, shard_actor_state,
                                          shard_batch)
