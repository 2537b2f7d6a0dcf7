"""Synthetic data pipelines (numpy only)."""

from repro_torch.data.synthetic import LMBatchIterator, SyntheticLM  # noqa: F401
