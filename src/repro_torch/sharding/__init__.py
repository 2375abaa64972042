"""Logical-axis placement on DTensor (counterpart of ``repro.sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_LOGICAL_TO_PHYSICAL,
    DEFAULT_RULES,
    AxisRules,
    build_param_placements,
    build_param_specs,
    distribute,
    logical_axes_for_path,
    shard_act,
    spec_for,
    use_sharding,
)
