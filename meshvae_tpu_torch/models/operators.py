"""Bundle of static per-level graph operands consumed by the models
(counterpart of meshvae_tpu/models/operators.py)."""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..mesh.hierarchy import MeshHierarchy
from ..ops.graph import (BSR_MIN_N, POOL_METHODS, GraphOperator,
                         PoolOperator, cheb_operator, embed_operator,
                         pool_operator)

CHEB_METHODS = ("dense", "ell", "pallas")


@dataclasses.dataclass(frozen=True)
class ModelOperators:
    lap: tuple[GraphOperator, ...]     # L+1 per-level Chebyshev operators
    down: tuple[PoolOperator, ...]     # L downsampling selections
    up: tuple[PoolOperator, ...]       # L barycentric upsamplers
    lap_final: GraphOperator           # operator fed to the last decoder conv
    num_nodes: tuple[int, ...]
    # the hybrid cutoff: under seq_parallel every level of at least this
    # many vertices is row-sharded, whatever cheb_method stored it as
    # (parallel.sharding.shard_operators)
    bsr_min_n: int = BSR_MIN_N


def build_operators(hier: MeshHierarchy, device="cuda",
                    cheb_method: str = "pallas",
                    final_conv_adjacency: str = "reference_quirk",
                    bsr_min_n: int = BSR_MIN_N,
                    dtype: torch.dtype = torch.float32,
                    pool_method: str = "gather") -> ModelOperators:
    """cheb_method "pallas" (the config name of the block-sparse kernel
    path) stores levels with at least bsr_min_n vertices block-sparse and
    smaller ones dense; "dense" stores every level dense; "ell" every level
    (and the embedded final operator's corner) as a self-padded neighbour
    list. pool_method "gather" or "dense" picks the pools' one layout
    (ops/graph.py pool_operator). `dtype` is the operands' storage type:
    float32, or bfloat16 for compute_dtype=bfloat16 (``VAEConfig.dtype``).
    bsr_min_n is kept as ModelOperators.bsr_min_n for every method: the
    levels that seq_parallel row-shards.

    final_conv_adjacency:
    - "reference_quirk": the last decoder conv sees the coarsest level's
      operator embedded at full resolution;
    - "finest": it sees the true full-resolution operator."""
    if cheb_method not in CHEB_METHODS:
        raise ValueError(f"unknown cheb method: {cheb_method!r}; the port "
                         f"supports {CHEB_METHODS}")
    if pool_method not in POOL_METHODS:
        raise ValueError(f"unknown pool method: {pool_method!r}; the port "
                         f"supports {POOL_METHODS}")
    device = resolve_device(device)
    min_n = bsr_min_n if cheb_method == "pallas" else None
    ell = cheb_method == "ell"
    lap = tuple(cheb_operator(a, device, bsr_min_n=min_n, dtype=dtype,
                              ell=ell)
                for a in hier.adjacency)
    down = tuple(pool_operator(d, device, dtype, pool_method)
                 for d in hier.downsample)
    up = tuple(pool_operator(u, device, dtype, pool_method)
               for u in hier.upsample)
    if final_conv_adjacency == "reference_quirk":
        lap_final = embed_operator(hier.adjacency[-1], hier.levels[0], device,
                                   bsr_min_n=min_n, dtype=dtype, ell=ell)
    elif final_conv_adjacency == "finest":
        lap_final = lap[0]
    else:
        raise ValueError(f"unknown final_conv_adjacency: {final_conv_adjacency}")
    return ModelOperators(lap=lap, down=down, up=up, lap_final=lap_final,
                          num_nodes=tuple(hier.levels), bsr_min_n=bsr_min_n)
