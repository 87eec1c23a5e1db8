"""Name-based sharding rules and mesh placement (port of
``repro.sharding``)."""
from .rules import (P, NamedSharding, ShardedTensor, batch_spec, data_axes,
                    device_put, replicate_allowed, replicated, rule_for,
                    shard_batch, shard_cache, shard_params, spec_for_cache,
                    spec_for_param)

__all__ = ["P", "NamedSharding", "ShardedTensor", "device_put",
           "spec_for_param", "shard_params", "shard_batch", "shard_cache",
           "spec_for_cache", "batch_spec", "data_axes", "replicated",
           "rule_for", "replicate_allowed"]
