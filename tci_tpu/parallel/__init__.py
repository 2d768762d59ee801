"""L2 function-evaluation runtime: the batch-evaluation protocol, vmap/
shard_map adapters that fan function sampling out across devices, and the
memoizing CachedFunction."""
