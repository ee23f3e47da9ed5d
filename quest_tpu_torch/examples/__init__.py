"""Runnable examples of the port, one per script of the JAX package's
``examples/`` and under the same file names (``README.md`` maps them).

Each script has ``main(device=None, **sizes) -> dict``, which returns the
numbers it prints, and runs as ``python -m
quest_tpu_torch.examples.<name> [--device cuda|cpu]``. The default device is
the card; without one the scripts raise unless ``--device cpu`` is given.
"""
