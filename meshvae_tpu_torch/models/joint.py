"""Joint disentangled VAE + Chebyshev-GCN classifier with latent-split
supervision, BASELINE config 3 (counterpart of meshvae_tpu/models/joint.py).

  * the conditional VAE runs as usual (encode -> classify -> posterior ->
    z -> label-conditioned decode);
  * latent-split supervision: a linear head reads the sex label from
    mu[:, :split], and an adversarial head reads it from mu[:, split:]
    behind a gradient-reversal layer, which pushes the free slice toward
    label independence;
  * a ChebGCN (models/gcn.py) classifies crecon's difference features
    diff = cat(x - recon_oppo, x - recon), trained jointly: its gradient
    flows back through the decoder into the encoder.

The true-label and opposite-label decodes run as one decoder pass at 2B
rows; in train mode every row draws its own dropout masks from the
explicit generator. In a dp world (``rows``, models/vae.py) a rank's b of
those rows are two segments of the global 2B: [start, start + b) and
[B + start, B + start + b), so its masks and noise are the single-process
ones row for row. The weights come from one torch.Generator: the VAE's,
then the GCN's, then the heads' (U(+-1/sqrt(fan_in)) weights and biases).
Parameter names follow the flax tree (``vae.*``, ``gcn.*``, ``sup_head``,
``adv_head``), so ``models.vae.params_from_flax`` carries JAX weights
across. With compute_dtype=bfloat16 the posterior heads and the two
latent-split heads follow flax's Dense(dtype) rule (``vae.dense``), as the
VAE's and the GCN's layers do; build_joint_model gives both configs the
config's compute dtype.

``mark`` (a callable of a slot name, the scanned train step's phase marks,
train/phases.py) stamps ``gcn`` once the two decodes have ended and the
GCN is about to start on diff, and ``gcn_grad`` from the backward of an
identity on diff, when the gradient has come back through the GCN to its
input: on the step's stream, so a captured step stamps both at each
replay.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .gcn import ChebGCN, GCNConfig
from .losses import vae_loss
from .operators import ModelOperators
from .vae import MeshVAE, VAEConfig, dense


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


class _MarkGrad(torch.autograd.Function):
    """Identity forward; its backward stamps ``gcn_grad`` and passes the
    gradient on unchanged."""

    @staticmethod
    def forward(ctx, x, mark):
        ctx.mark = mark
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.mark("gcn_grad")
        return g, None


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, negated gradient backward (the adversarial
    gradient-reversal layer)."""
    return _GradReverse.apply(x)


class JointMeshVAE(nn.Module):
    """MeshVAE + latent-split heads + a jointly trained ChebGCN. split: the
    number of leading latent coordinates carrying the supervised (sex)
    factor; 0 < split < latent."""

    def __init__(self, cfg: VAEConfig, gcn_cfg: GCNConfig, split: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0 < split < cfg.latent:
            raise ValueError(
                f"latent_split must be in (0, num_style): got split={split} "
                f"with latent={cfg.latent}")
        gen = generator or torch.Generator().manual_seed(0)
        self.cfg, self.gcn_cfg, self.split = cfg, gcn_cfg, split
        self.vae = MeshVAE(cfg, generator=gen)
        self.gcn = ChebGCN(gcn_cfg, generator=gen)
        self.sup_head = nn.Linear(split, cfg.num_classes)
        self.adv_head = nn.Linear(cfg.latent - split, cfg.num_classes)
        with torch.no_grad():
            for head in (self.sup_head, self.adv_head):
                bound = 1.0 / math.sqrt(head.in_features)
                head.weight.uniform_(-bound, bound, generator=gen)
                head.bias.uniform_(-bound, bound, generator=gen)

    def fresh(self, generator: torch.Generator) -> "JointMeshVAE":
        """A new joint model of this configuration with weights from
        `generator` (Trainer.init_params)."""
        return JointMeshVAE(self.cfg, self.gcn_cfg, self.split, generator)

    # --- delegations: the Trainer's eval step (the sex-change
    # counterfactual) and the inference engine drive the joint model as a
    # MeshVAE ---------------------------------------------------------------
    def encode(self, x, ops: ModelOperators, train: bool = False,
               generator=None):
        return self.vae.encode(x, ops, train, generator)

    def classify(self, h, train: bool = False, generator=None):
        return self.vae.classify(h, train, generator)

    def decode(self, z, ops: ModelOperators, train: bool = False,
               generator=None):
        return self.vae.decode(z, ops, train, generator)

    def sample(self, y, z, ops: ModelOperators, train: bool = False,
               generator=None):
        return self.vae.sample(y, z, ops, train, generator)

    def posterior_mean(self, hy):
        return self.vae.posterior_mean(hy)

    def forward(self, x: torch.Tensor, y: torch.Tensor, ops: ModelOperators,
                train: bool = False,
                generator: torch.Generator | None = None,
                rows: tuple | None = None, mark=None) -> dict:
        """MeshVAE's output dict (recon, y_hat, mu, logvar, z) plus
        sup_logits, adv_logits, cls_logits (float32) and recon_oppo. rows
        = (start, total), mark: see the module docstring. In sp's row
        layout x, recon, recon_oppo and the GCN's input diff are the
        rank's rows of level 0."""
        vae, dt = self.vae, self.cfg.dtype
        h = vae.encode(x, ops, train, generator, rows)
        y_hat = vae.classify(h, train, generator, rows)
        hy = torch.cat([y.to(h.dtype), h], dim=-1)
        mu = vae.posterior_mean(hy).float()
        logvar = dense(vae.z_log_var, hy, dt).float()
        z = vae.reparameterize(mu, logvar, generator, rows) if train else mu
        sup_logits = dense(self.sup_head, mu[:, :self.split], dt).float()
        adv_logits = dense(self.adv_head, grad_reverse(mu[:, self.split:]),
                           dt).float()
        yz = torch.cat([torch.cat([y, z], dim=-1),
                        torch.cat([1.0 - y, z], dim=-1)], dim=0)
        b = x.shape[0]
        both = vae.decode(yz, ops, train, generator, None if rows is None
                          else ((rows[0], rows[1] + rows[0]), 2 * rows[1]))
        recon, recon_oppo = both[:b], both[b:]
        diff = torch.cat([x - recon_oppo, x - recon], dim=-1)
        if mark is not None:
            mark("gcn")
            diff = _MarkGrad.apply(diff, mark)
        cls_logits = self.gcn(diff, ops)
        return {"recon": recon, "y_hat": y_hat, "mu": mu, "logvar": logvar,
                "z": z, "sup_logits": sup_logits, "adv_logits": adv_logits,
                "cls_logits": cls_logits, "recon_oppo": recon_oppo}


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor | None, denom: torch.Tensor | None = None):
    """Masked-mean cross entropy and correct count: ([B, C], [B]) ->
    scalars; `denom` replaces max(mask.sum(), 1)."""
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    hits = (torch.argmax(logits, dim=-1) == labels).to(nll.dtype)
    if mask is None:
        return nll.mean(), hits.sum()
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    return torch.sum(nll * mask) / denom, torch.sum(hits * mask)


def joint_loss(x, out: dict, y, labels, mask=None, sup_weight: float = 1.0,
               adv_weight: float = 0.1, cls_weight: float = 1.0,
               denom: torch.Tensor | None = None, shard=None):
    """The VAE loss plus weighted cross entropies of the supervised slice,
    the adversarial free slice (reversed gradients) and the GCN. Returns
    (loss, aux): vae_loss's aux with correct = the GCN's correct count
    (this configuration's classifier), vae_correct the VAE head's, and
    sup_loss, adv_loss, cls_loss, sup_correct, adv_correct. `shard`
    (the level-0 RowShard) says that x and recon are the rank's rows, as
    in vae_loss."""
    base, aux = vae_loss(x, out["recon"], out["mu"], out["logvar"], y,
                         out["y_hat"], mask=mask, denom=denom, shard=shard)
    sup_loss, sup_correct = masked_ce(out["sup_logits"], labels, mask, denom)
    adv_loss, adv_correct = masked_ce(out["adv_logits"], labels, mask, denom)
    cls_loss, cls_correct = masked_ce(out["cls_logits"], labels, mask, denom)
    loss = (base + sup_weight * sup_loss + adv_weight * adv_loss
            + cls_weight * cls_loss)
    aux = dict(aux, vae_correct=aux["correct"], correct=cls_correct,
               sup_loss=sup_loss, adv_loss=adv_loss, cls_loss=cls_loss,
               sup_correct=sup_correct, adv_correct=adv_correct)
    return loss, aux


def build_joint_model(config: dict, coarse_verts: int, num_features: int = 3,
                      generator: torch.Generator | None = None
                      ) -> JointMeshVAE:
    """Config dict -> JointMeshVAE (as VAEConfig.from_config)."""
    cfg = VAEConfig.from_config(config, coarse_verts=coarse_verts,
                                num_features=num_features)
    gcn_cfg = GCNConfig.from_config(config, coarse_verts=coarse_verts,
                                    num_features=2 * num_features)
    split = int(config.get("latent_split", config.get("num_classes", 2)))
    return JointMeshVAE(cfg, gcn_cfg, split, generator=generator)
