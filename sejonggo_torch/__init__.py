"""sejonggo_torch: the PyTorch/CUDA port of sejonggo_tpu.

The JAX package ``sejonggo_tpu`` stays beside this one as the reference;
this package imports none of it (nor JAX, flax or msgpack).  Subpackage
names mirror the JAX package so each module's counterpart is easy to find:

- ``goenv``  — batched Go engine on (B, N, N) tensors; the search and env
               steps dispatch to the CUDA kernels for CUDA tensors;
- ``ops``    — the hand-written CUDA kernels (``csrc/*.cu``, built with
               plain ``nvcc`` and bound with ``ctypes``) and their plain
               PyTorch versions;
- ``nets``   — the AlphaZero residual net as an ``nn.Module`` and the
               converter from flax variable trees;
- ``search`` — the array-backed batched MCTS, and the model-free
               michi/RAVE engine with its heuristics and patterns;
- ``actor``  — the move step, whole self-play and evaluation games,
               continuous self-play and the resign calibrator;
- ``learn``  — the train step, the replay buffer, the gate, the duels
               and the checkpoint store, with its own msgpack decoder and
               encoder;
- ``parallel`` — data parallelism over a ``torch.distributed`` group,
               one rank per card: meshes of ranks, collectives, the
               launcher of a world and the multi-rank dry run;
- ``utils``  — metrics logging, timing and a profiler trace;
- ``pipeline`` — the closed loop: self-play, train, checkpoint, gate, on
               one card or one rank per card.

Entry points default to ``device="cuda"`` and raise if CUDA is absent;
the CPU is used only when the caller passes it explicitly.
"""

__version__ = "0.1.0"
