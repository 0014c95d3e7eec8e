"""Chebyshev GCN classifier, the crecon second-stage model (counterpart of
meshvae_tpu/models/gcn.py).

  n_layers x (ChebConv -> ReLU -> down-pool) over 2 * num_features
  reconstruction-difference channels, flatten, ReLU(enc_lin -> hidden),
  cls_layer -> logits [B, num_classes] (float32, for cross entropy).

compute_dtype=bfloat16 is the VAE's bf16 mode (models/vae.py): the input
is cast to bf16, the convs and pools run on bf16 operators with fp32
accumulation, enc_lin and cls_layer follow flax's Dense(dtype) rule
(``vae.dense``), the logits go to float32 and the parameters stay float32
master weights.

The hidden width is ``GCNConfig.hidden`` (128), not the config's
num_hidden; the flatten width is coarse_verts * filters[-2] of the filter
chain with the input features prepended (the reference's cheb_cls). The
convs run ``ops.cheb.cheb_conv``, so the block-sparse kernel serves the
levels that have one. When the input needs no gradient (crecon's frozen
diff features) the first conv's backward skips its dx recurrence by
itself (``_BasisMix``); the joint model differentiates through it.

Init: Chebyshev weights glorot-uniform over the trailing two dimensions,
zero biases; enc_lin and cls_layer weights ~ N(0, 0.1) and their biases
U(+-1/sqrt(fan_in)). Every draw comes from an explicit torch.Generator.
Parameter names match the flax tree (``cheb_{i}``, ``enc_lin``,
``cls_layer``), so ``models.vae.params_from_flax`` carries JAX weights
across.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops.bsr_shard import from_rows
from ..ops.pool import pool_apply
from .operators import ModelOperators
from .vae import COMPUTE_DTYPES, ChebConvLayer, dense, dtype_and_precision


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    num_features: int          # input channels (2 * mesh feature dim = 6)
    filters: tuple
    polygon_order: tuple
    n_layers: int
    num_classes: int
    coarse_verts: int
    hidden: int = 128
    precision: str | None = None
    compute_dtype: str = "float32"   # float32 | bfloat16 (fp32 accumulation)
    pool_method: str = "gather"      # gather | dense (ops/pool.py)

    @property
    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]

    @staticmethod
    def from_config(cfg: dict, coarse_verts: int,
                    num_features: int = 6) -> "GCNConfig":
        """As VAEConfig.from_config: compute_dtype bfloat16 clamps
        matmul_precision to "default"."""
        compute_dtype, precision = dtype_and_precision(cfg)
        return GCNConfig(
            num_features=num_features,
            filters=tuple(cfg["num_conv_filters"]),
            polygon_order=tuple(cfg["polygon_order"]),
            n_layers=int(cfg["n_layers"]),
            num_classes=int(cfg["num_classes"]),
            coarse_verts=coarse_verts,
            precision=precision,
            compute_dtype=compute_dtype,
            pool_method=str(cfg.get("pool_method", "gather")),
        )


class ChebGCN(nn.Module):
    def __init__(self, cfg: GCNConfig,
                 generator: torch.Generator | None = None):
        """Weights are drawn on the CPU from `generator` (a fresh one seeded
        0 when None); move the module with `.to(device)`."""
        super().__init__()
        self.cfg = c = cfg
        filters = (c.num_features,) + tuple(c.filters)
        for i in range(len(filters) - 2):
            setattr(self, f"cheb_{i}", ChebConvLayer(
                filters[i], filters[i + 1], c.polygon_order[i],
                precision=c.precision, dtype=c.dtype))
        self.enc_lin = nn.Linear(c.coarse_verts * filters[-2], c.hidden)
        self.cls_layer = nn.Linear(c.hidden, c.num_classes)
        self._init_weights(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for mod in self.children():
            if isinstance(mod, ChebConvLayer):
                fan_in, fan_out = mod.weight.shape[-2:]
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.uniform_(-bound, bound, generator=gen)
                mod.bias.zero_()
            else:
                mod.weight.normal_(0.0, 0.1, generator=gen)
                bound = 1.0 / math.sqrt(mod.in_features)
                mod.bias.uniform_(-bound, bound, generator=gen)

    def fresh(self, generator: torch.Generator) -> "ChebGCN":
        """A new GCN of this configuration with weights from `generator`."""
        return ChebGCN(self.cfg, generator=generator)

    def forward(self, x: torch.Tensor, ops: ModelOperators) -> torch.Tensor:
        """x: [B, N, 2 F] difference features -> logits [B, C] (float32).
        In sp's row layout x is the rank's rows of level 0, and so are the
        activations at every row-sharded level; the flatten reads the
        coarsest level whole."""
        dt = self.cfg.dtype
        x = x.to(dt)
        for i in range(self.cfg.n_layers):
            x = torch.relu(getattr(self, f"cheb_{i}")(x, ops.lap[i]))
            x = pool_apply(x, ops.down[i], self.cfg.pool_method)
        coarse = ops.down[self.cfg.n_layers - 1].out_rows
        if coarse is not None:
            x = from_rows(x, coarse)
        x = torch.relu(dense(self.enc_lin, x.reshape(x.shape[0], -1), dt))
        return dense(self.cls_layer, x, dt).float()
