"""Sharding rule engine of the port (logical axes -> mesh specs)."""

from repro_torch.sharding.rules import (
    NamedSharding,
    activation_sharding,
    batch_mean,
    batch_statistics,
    batch_sum,
    dist_operand_specs,
    maybe_shard,
    pspec_for_def,
    pspecs_for_defs,
    shardings_for_defs,
)

__all__ = [
    "NamedSharding", "activation_sharding", "batch_mean",
    "batch_statistics", "batch_sum", "dist_operand_specs", "maybe_shard",
    "pspec_for_def", "pspecs_for_defs", "shardings_for_defs",
]
