"""Test machinery of the port: the golden-file runner
(:mod:`quest_tpu_torch.testing.golden`), a copy of the JAX package's."""

from .golden import GATE_SPECS, GoldenFailure, run_file

__all__ = ["GATE_SPECS", "GoldenFailure", "run_file"]
