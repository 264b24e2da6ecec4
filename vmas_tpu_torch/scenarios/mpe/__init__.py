"""The multi-agent particle environments (MPE) of the JAX package's
``vmas_tpu/scenarios/mpe``: ``simple`` and ``simple_spread`` are ported."""
