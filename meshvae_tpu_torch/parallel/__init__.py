from .sharding import (VERTEX_KEYS, Comm, World, choose_backend,
                       close_world, fetch, init_world, initialize_multihost,
                       is_primary, make_world, replicate, shard_batch,
                       shard_operators, spawn_local, sync_processes,
                       vertex_dim_shardable, vertex_rows)

__all__ = ["VERTEX_KEYS", "Comm", "World", "choose_backend", "close_world",
           "fetch", "init_world", "initialize_multihost", "is_primary",
           "make_world", "replicate", "shard_batch", "shard_operators",
           "spawn_local", "sync_processes", "vertex_dim_shardable",
           "vertex_rows"]
