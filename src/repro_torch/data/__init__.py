"""Data pipelines. Port of ``repro/data`` (the synthetic LM stream so far;
the cluster traces stay with the JAX package's cluster manager)."""
from repro_torch.data.synthetic import SyntheticLM, to_torch
