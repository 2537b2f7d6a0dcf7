"""Checkpoints in the JAX package's on-disk format (``checkpoint.store``)."""

from repro_torch.checkpoint.store import (CheckpointManager, latest_checkpoint,  # noqa: F401
                                          live_rank_map, load_checkpoint,
                                          pack_phased_state, save_checkpoint,
                                          unpack_phased_state)
