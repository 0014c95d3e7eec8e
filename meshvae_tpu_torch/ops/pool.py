"""Mesh pool/unpool forward (counterpart of the gather path of
meshvae_tpu/ops/pool.py): out = P @ x per batch item as weighted gathers;
down-pool rows are one-hot selections, barycentric up-pool rows have <= 3
entries."""
from __future__ import annotations

import torch

from .graph import PoolOperator


def pool_apply(x: torch.Tensor, pool: PoolOperator) -> torch.Tensor:
    """x: [B, N_in, F] -> [B, N_out, F]; padded slots carry weight 0."""
    idx, w = pool.idx, pool.w
    if idx.shape[1] == 1:
        return x[:, idx[:, 0]] * w[None, :, 0, None]
    acc = None
    for d in range(idx.shape[1]):
        term = w[None, :, d, None] * x[:, idx[:, d]]
        acc = term if acc is None else acc + term
    return acc
