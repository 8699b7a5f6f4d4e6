"""User tools of the port: the counterparts of the JAX package's
``scripts/`` that its users run, each as ``python -m
sejonggo_torch.tools.<name>`` with the script's flags plus ``--device``
(CUDA unless ``--device cpu`` is passed; without a card they refuse):

- ``build_patterns``      — a pachi-format spatial pattern store
                            harvested from SGFs;
- ``strength_campaign``   — the closed loop until the gated best net beats
                            the heuristic engine, with probe and confirm
                            duels and an optional michi rung;
- ``strength_report``     — the strength ladder of a finished run;
- ``ladder_continuation`` — the ladder of a run seeded from another run;
- ``train_19x19``         — a heuristic 19x19 corpus, KGS pretraining of
                            the 20x256 net, then closed-loop generations;
- ``calibrate_slow_loop`` — the learning curve of the slow closed-loop
                            test's configuration.

Each module splits ``main(argv=None)`` (argument parsing and the preset)
from a function that takes the model ``Config``, so a caller can run a
tool at a cut configuration in-process.
"""
