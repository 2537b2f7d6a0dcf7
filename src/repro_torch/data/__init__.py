"""Synthetic data pipelines (numpy only)."""

from repro_torch.data.synthetic import (LMBatchIterator, SyntheticClassification,  # noqa: F401
                                        SyntheticLM)
