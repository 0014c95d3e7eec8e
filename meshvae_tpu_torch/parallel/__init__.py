from .sharding import (Comm, World, choose_backend, close_world, fetch,
                       init_world, initialize_multihost, is_primary,
                       make_world, replicate, shard_batch, shard_operators,
                       spawn_local, sync_processes)

__all__ = ["Comm", "World", "choose_backend", "close_world", "fetch",
           "init_world", "initialize_multihost", "is_primary", "make_world",
           "replicate", "shard_batch", "shard_operators", "spawn_local",
           "sync_processes"]
