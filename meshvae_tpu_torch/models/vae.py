"""Disentangled, label-conditioned mesh VAE (counterpart of
meshvae_tpu/models/vae.py).

  encoder   : n_layers x (ChebConv -> ReLU -> down-pool), flatten,
              ReLU(enc_lin), dropout                               -> h [B, H]
  classifier: softmax(classifier_layer(dropout(h)))                -> y_hat
  posterior : z_mean / z_log_var(concat[y, h])                     -> mu, logvar
  decoder   : ReLU(dec_lin(concat[y, z])), dropout, ReLU(dec_lin_2), dropout,
              reshape to [B, n_coarse, F_last], n_layers x (up-pool ->
              ChebConv -> ReLU), final bias-free ChebConv on ops.lap_final
                                                                   -> recon

Parameter names match the flax tree one to one (``cheb_enc_i``,
``cheb_dec_i``, ``enc_lin``, ...); ``params_from_flax`` converts a flax tree
into this module's state_dict. Init distributions match the JAX package:
Chebyshev weights and biases ~ N(0, 0.1), enc_lin/dec_lin weights
~ N(0, 0.1), every other weight and every Linear bias
U(+-1/sqrt(fan_in)).

Eval mode (``train=False``) uses z = mu and no dropout. Train mode draws the
dropout masks and the reparameterisation noise from an explicit
``torch.Generator`` on the tensors' device. As in the reference, train mode
drops the classifier's input out twice: once at the end of ``encode`` and
again in ``classify``; the posterior sees h after the first. Under data
parallelism a rank holds rows [start, start + b) of a global batch of
`total` rows; with ``rows=(start, total)`` every draw is made for the whole
global batch and the rank keeps its rows, so the masks and the noise are
the single-process ones. A rank's batch made of several equal segments of
the global one (the joint model's decode of both labels at 2B rows) gives
their starts, ``rows=((start_0, start_1, ...), total)``.

compute_dtype=bfloat16 follows the JAX package's bf16 mode: parameters stay
float32 (the master weights) and are cast to bf16 at use; every product
takes bf16 operands with fp32 accumulation and a bf16 result (a linear
head's bias is added after that rounding, in bf16, as flax's Dense does);
the logits, mu and logvar (so z), and recon go to float32, so the loss and
the pose error are float32. The operators must be built in bf16
(``build_operators(..., dtype=VAEConfig.dtype)``).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..ops.cheb import cheb_conv, resolve_precision
from ..ops.graph import GraphOperator
from ..ops.pool import pool_apply
from .operators import ModelOperators

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_and_precision(cfg: dict) -> tuple[str, str]:
    """(compute_dtype, matmul_precision) of a config dict: compute_dtype
    float32 (the default) or bfloat16, the precision resolved for it
    (ops.cheb.resolve_precision)."""
    compute_dtype = str(cfg.get("compute_dtype", "float32") or "float32")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r}: expected one "
                         f"of {sorted(COMPUTE_DTYPES)}")
    return compute_dtype, resolve_precision(cfg.get("matmul_precision"),
                                            COMPUTE_DTYPES[compute_dtype])


def _draw_buffer(x: torch.Tensor, rows: tuple | None) -> torch.Tensor:
    """An empty tensor like x, or like the whole global batch when rows =
    (start, total) (see the module docstring)."""
    if rows is None:
        return torch.empty_like(x)
    return x.new_empty((rows[1],) + tuple(x.shape[1:]))


def _own_rows(t: torch.Tensor, x: torch.Tensor,
              rows: tuple | None) -> torch.Tensor:
    """The rank's rows of a global draw t (see the module docstring)."""
    if rows is None:
        return t
    starts, n = rows[0], x.shape[0]
    if isinstance(starts, int):
        return t[starts:starts + n]
    seg = n // len(starts)
    return torch.cat([t[s:s + seg] for s in starts])


def _dropout(x: torch.Tensor, rate: float, train: bool,
             generator: torch.Generator | None,
             rows: tuple | None = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); identity unless training."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _draw_buffer(x, rows).bernoulli_(keep, generator=generator)
    return x * _own_rows(mask, x, rows) / keep


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """A linear head in the computation dtype, as flax's Dense(dtype=):
    layer(x) in float32; in bf16, x @ W^T rounded to bf16, then + b in
    bf16 (two roundings)."""
    if dtype == torch.float32:
        return layer(x)
    return (torch.matmul(x.to(dtype), layer.weight.to(dtype).t())
            + layer.bias.to(dtype))


class ChebConvLayer(nn.Module):
    """One Chebyshev graph convolution; the operator is passed at call time.
    x, the weight and the bias are cast to `dtype` (the computation dtype)
    at use."""

    def __init__(self, in_features: int, out_features: int, k: int,
                 use_bias: bool = True, precision: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(k, in_features, out_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)
        self.precision = precision
        self.dtype = dtype

    def forward(self, x: torch.Tensor, op: GraphOperator) -> torch.Tensor:
        dt = self.dtype
        return cheb_conv(x.to(dt), op, self.weight.to(dt),
                         None if self.bias is None else self.bias.to(dt),
                         precision=self.precision)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    num_features: int          # per-vertex feature dim (3)
    filters: tuple             # conv filter widths, e.g. (16, 16, 16, 32, 32)
    polygon_order: tuple       # Chebyshev order per layer
    n_layers: int
    num_hidden: int
    latent: int                # z dim ("num_style")
    num_classes: int
    dropout: float
    coarse_verts: int          # vertex count at the coarsest level
    precision: str | None = None
    compute_dtype: str = "float32"   # float32 | bfloat16 (fp32 accumulation)
    pool_method: str = "gather"      # gather | dense (ops/pool.py)

    @property
    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]

    @staticmethod
    def from_config(cfg: dict, coarse_verts: int,
                    num_features: int = 3) -> "VAEConfig":
        """compute_dtype bfloat16 clamps matmul_precision to "default"
        (resolve_precision); "default" on float32 raises."""
        compute_dtype, precision = dtype_and_precision(cfg)
        return VAEConfig(
            num_features=num_features,
            filters=tuple(cfg["num_conv_filters"]),
            polygon_order=tuple(cfg["polygon_order"]),
            n_layers=int(cfg["n_layers"]),
            num_hidden=int(cfg["num_hidden"]),
            latent=int(cfg["num_style"]),
            num_classes=int(cfg["num_classes"]),
            dropout=float(cfg["dropout"]),
            coarse_verts=coarse_verts,
            precision=precision,
            compute_dtype=compute_dtype,
            pool_method=str(cfg.get("pool_method", "gather")),
        )


class MeshVAE(nn.Module):
    def __init__(self, cfg: VAEConfig,
                 generator: torch.Generator | None = None):
        """Weights are drawn on the CPU from `generator` (a fresh one seeded
        0 when None); move the module with `.to(device)`."""
        super().__init__()
        self.cfg = c = cfg
        # filter chain with input features prepended: [F_in, f1, ..., fL]
        self.filters = filters = (c.num_features,) + tuple(c.filters)
        enc_specs = [(filters[i], filters[i + 1], c.polygon_order[i])
                     for i in range(len(filters) - 2)]
        dec_specs = [(filters[-i - 1], filters[-i - 2], c.polygon_order[i])
                     for i in range(len(filters) - 1)]
        kw = dict(precision=c.precision, dtype=c.dtype)
        for n, (i, o, k) in enumerate(enc_specs):
            setattr(self, f"cheb_enc_{n}", ChebConvLayer(i, o, k, **kw))
        for n, (i, o, k) in enumerate(dec_specs):
            setattr(self, f"cheb_dec_{n}",
                    ChebConvLayer(i, o, k, use_bias=(n != len(dec_specs) - 1),
                                  **kw))

        flat = c.coarse_verts * filters[-1]
        self.enc_lin = nn.Linear(flat, c.num_hidden)
        self.dec_lin = nn.Linear(c.latent + c.num_classes, c.num_hidden)
        self.dec_lin_2 = nn.Linear(c.num_hidden, flat)
        self.classifier_layer = nn.Linear(c.num_hidden, c.num_classes)
        self.z_mean = nn.Linear(c.num_hidden + c.num_classes, c.latent)
        self.z_log_var = nn.Linear(c.num_hidden + c.num_classes, c.latent)
        self._init_weights(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for name, mod in self.named_children():
            if isinstance(mod, ChebConvLayer):
                mod.weight.normal_(0.0, 0.1, generator=gen)
                if mod.bias is not None:
                    mod.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                if name in ("enc_lin", "dec_lin"):
                    mod.weight.normal_(0.0, 0.1, generator=gen)
                else:
                    mod.weight.uniform_(-bound, bound, generator=gen)
                mod.bias.uniform_(-bound, bound, generator=gen)

    def fresh(self, generator: torch.Generator) -> "MeshVAE":
        """A new MeshVAE of this configuration with weights from
        `generator` (Trainer.init_params)."""
        return MeshVAE(self.cfg, generator=generator)

    def cheb_enc(self, i: int) -> ChebConvLayer:
        return getattr(self, f"cheb_enc_{i}")

    def cheb_dec(self, i: int) -> ChebConvLayer:
        return getattr(self, f"cheb_dec_{i}")

    def posterior_mean(self, hy: torch.Tensor) -> torch.Tensor:
        """hy = concat[y, h] -> mu in the computation dtype: the z_mean
        head (an nn.Linear, so that params_from_flax maps flax's z_mean
        onto it) through the Dense rule. Callers take mu here, never from
        z_mean(hy), which would skip the bf16 roundings."""
        return dense(self.z_mean, hy, self.cfg.dtype)

    def encode(self, x: torch.Tensor, ops: ModelOperators,
               train: bool = False,
               generator: torch.Generator | None = None,
               rows: tuple | None = None) -> torch.Tensor:
        """x: [B, N, F_in] -> h: [B, num_hidden] (computation dtype)."""
        x = x.to(self.cfg.dtype)
        for i in range(self.cfg.n_layers):
            x = torch.relu(self.cheb_enc(i)(x, ops.lap[i]))
            x = pool_apply(x, ops.down[i], self.cfg.pool_method)
        h = torch.relu(dense(self.enc_lin, x.reshape(x.shape[0], -1),
                             self.cfg.dtype))
        return _dropout(h, self.cfg.dropout, train, generator, rows)

    def classify(self, h: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None,
                 rows: tuple | None = None) -> torch.Tensor:
        """h: [B, num_hidden] -> y_hat: [B, C] (softmax, in float32)."""
        h = _dropout(h, self.cfg.dropout, train, generator, rows)
        logits = dense(self.classifier_layer, h, self.cfg.dtype).float()
        return torch.softmax(logits, dim=-1)

    def decode(self, z: torch.Tensor, ops: ModelOperators,
               train: bool = False,
               generator: torch.Generator | None = None,
               rows: tuple | None = None) -> torch.Tensor:
        """z: [B, latent + C] (label-conditioned) -> recon: [B, N, F_in]
        (float32)."""
        c = self.cfg
        x = _dropout(torch.relu(dense(self.dec_lin, z, c.dtype)), c.dropout,
                     train, generator, rows)
        x = _dropout(torch.relu(dense(self.dec_lin_2, x, c.dtype)), c.dropout,
                     train, generator, rows)
        x = x.reshape(x.shape[0], c.coarse_verts, self.filters[-1])
        for i in range(c.n_layers):
            x = pool_apply(x, ops.up[-i - 1], c.pool_method)
            x = torch.relu(self.cheb_dec(i)(x, ops.lap[c.n_layers - i - 1]))
        return self.cheb_dec(len(c.filters) - 1)(x, ops.lap_final).float()

    def sample(self, y: torch.Tensor, z: torch.Tensor, ops: ModelOperators,
               train: bool = False,
               generator: torch.Generator | None = None,
               rows: tuple | None = None) -> torch.Tensor:
        """Label-conditioned decode of concat[y, z]."""
        return self.decode(torch.cat([y, z], dim=-1), ops, train, generator,
                           rows)

    def reparameterize(self, mu: torch.Tensor, logvar: torch.Tensor,
                       generator: torch.Generator | None,
                       rows: tuple | None = None) -> torch.Tensor:
        eps = _draw_buffer(mu, rows).normal_(generator=generator)
        return _own_rows(eps, mu, rows) * torch.exp(0.5 * logvar) + mu

    def forward(self, x: torch.Tensor, y: torch.Tensor, ops: ModelOperators,
                train: bool = False,
                generator: torch.Generator | None = None,
                rows: tuple | None = None) -> dict:
        """x [B, N, F_in] normalized vertices, y [B, C] one-hot labels ->
        dict(recon, y_hat, mu, logvar, z); z = mu unless training. rows:
        see the module docstring."""
        h = self.encode(x, ops, train, generator, rows)
        y_hat = self.classify(h, train, generator, rows)
        hy = torch.cat([y.to(h.dtype), h], dim=-1)
        mu = self.posterior_mean(hy).float()
        logvar = dense(self.z_log_var, hy, self.cfg.dtype).float()
        z = self.reparameterize(mu, logvar, generator, rows) if train else mu
        recon = self.sample(y, z, ops, train, generator, rows)
        return {"recon": recon, "y_hat": y_hat, "mu": mu, "logvar": logvar,
                "z": z}


# Layer names in the order the port's models register them: MeshVAE's
# convs, then its heads; ChebGCN's convs (cheb_{i}), then enc_lin and
# cls_layer; JointMeshVAE's submodels (vae, gcn), then its two heads.
_CONV_PREFIXES = ("cheb_enc_", "cheb_dec_", "cheb_")
_LAYERS = ("enc_lin", "dec_lin", "dec_lin_2", "classifier_layer", "z_mean",
           "z_log_var", "cls_layer", "vae", "gcn", "sup_head", "adv_head")


def parameter_order(names) -> list[str]:
    """state_dict names in the order the port's model registers its
    parameters (the order of ``model.parameters()``, which torch optimizer
    state follows), for a MeshVAE, a ChebGCN or a JointMeshVAE: at every
    level of the name, convs by prefix and index, then the other layers
    and submodels as ``_LAYERS`` lists them; weight before bias."""
    def rank(part: str):
        for group, prefix in enumerate(_CONV_PREFIXES):
            if part.startswith(prefix) and part[len(prefix):].isdigit():
                return group, int(part[len(prefix):])
        return len(_CONV_PREFIXES), _LAYERS.index(part)

    def key(name: str):
        *path, leaf = name.split(".")
        return tuple(rank(p) for p in path), leaf != "weight"

    return sorted(names, key=key)


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """flax param tree (``{"params": {...}}`` or its inner dict, leaves as
    numpy arrays) -> the port model's state_dict; a nested tree (the joint
    model's ``vae``, ``gcn``) gives dotted names. Chebyshev ``weight [K,
    F_in, F_out]`` and ``bias`` keep their shapes; a layer's ``kernel``
    has its axes reversed: a Dense ``[in, out]`` becomes
    ``nn.Linear.weight [out, in]``, a 1-wide Conv ``[1, in, out]``
    ``nn.Conv1d.weight [out, in, 1]``. A leaf beside submodules rather
    than inside a layer (models/experimental.py: EqualLinear's
    ``kernel``, AdaIN's ``style_kernel``, GAT's ``a_src``, DiffPool's
    ``s``, BatchNorm's ``scale``) keeps its flax name and layout. A
    ``batch_stats`` collection beside ``params`` adds its leaves under the
    same names (BatchNorm's ``mean`` and ``var`` buffers)."""
    params = tree.get("params", tree)
    arr = lambda v: torch.from_numpy(np.array(v, dtype=np.float32))
    out = {}
    if "params" in tree and "batch_stats" in tree:
        out.update(params_from_flax(tree["batch_stats"]))
    for name, leaves in params.items():
        if not isinstance(leaves, Mapping):
            out[name] = arr(leaves)
            continue
        if not any(k in leaves for k in ("kernel", "weight")):
            out.update({f"{name}.{k}": v
                        for k, v in params_from_flax(leaves).items()})
            continue
        if "kernel" in leaves:
            out[f"{name}.weight"] = arr(np.asarray(leaves["kernel"]).T)
        else:
            out[f"{name}.weight"] = arr(leaves["weight"])
        if "bias" in leaves:
            out[f"{name}.bias"] = arr(leaves["bias"])
    return out


def save_params_npz(path: str, state_dict: dict) -> None:
    """Write a flat name -> array map (the state_dict) as .npz."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in state_dict.items()})


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}
