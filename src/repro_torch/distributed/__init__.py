from repro_torch.distributed.sharding import (
    PartitionSpec,
    ShardingRules,
    activation_sharding,
    current_rules,
    param_sharding,
    placements,
    shard,
    use_sharding_rules,
)

__all__ = [
    "PartitionSpec",
    "ShardingRules",
    "activation_sharding",
    "current_rules",
    "param_sharding",
    "placements",
    "shard",
    "use_sharding_rules",
]
