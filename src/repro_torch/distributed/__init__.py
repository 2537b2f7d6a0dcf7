"""Sharded placement, int8 gradient sync and the explicit collectives of
the sharded train and serving paths (the counterpart of
``repro/distributed``)."""

from repro_torch.distributed.sharding import (  # noqa: F401
    ACT_RULES,
    ACT_RULES_SP,
    FROZEN_PARAM_RULES,
    PARAM_RULES,
    PARAM_RULES_NO_FSDP,
    axis_rules,
    current_manual_axes,
    current_mesh,
    named_shardings,
    paged_pool_shardings,
    paged_pool_specs,
    param_specs,
    place_at_paths,
    shard,
)
