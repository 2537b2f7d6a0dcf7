"""Optimizers over partitioned param trees (``optim.optimizers``)."""

from repro_torch.optim.optimizers import (OptState, apply_updates, init_moments,  # noqa: F401
                                          init_optimizer, make_schedule)
