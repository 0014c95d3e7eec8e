"""Loss / log-pdf library (counterpart of meshvae_tpu/models/losses.py):
the reference's closed forms and the cheb_VAE loss assembly."""
from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def kld(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) summed over the latent dim: [B, Z] -> [B]."""
    return -0.5 * torch.sum(1.0 + logvar - mu.square() - logvar.exp(), dim=-1)


def gaussian_nll(mu: torch.Tensor, log_sigma, x: torch.Tensor) -> torch.Tensor:
    """Per-element negative log-likelihood of x under
    N(mu, exp(log_sigma)^2). A float log_sigma becomes a device tensor by
    a fill, not a host-to-device copy (a CUDA graph can capture a fill)."""
    if isinstance(log_sigma, torch.Tensor):
        log_sigma = log_sigma.to(x.device, x.dtype)
    else:
        log_sigma = torch.full((), log_sigma, dtype=x.dtype, device=x.device)
    return (0.5 * ((x - mu) / log_sigma.exp()).square() + log_sigma
            + _HALF_LOG_2PI)


def bernoulli_nll(x_hat: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """Bernoulli negative log-likelihood of x under probabilities x_hat,
    summed over the last two axes ([B, N, F] -> [B]); eps sits inside
    both logs."""
    return -(torch.log(x_hat + eps) * x
             + torch.log(1.0 - x_hat + eps) * (1.0 - x)).sum(-1).sum(-1)


def softclip(value, min_value: float) -> torch.Tensor:
    """Soft lower clip: min + softplus(value - min); a Python number
    becomes a float32 tensor."""
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(value, dtype=torch.float32)
    return min_value + torch.nn.functional.softplus(value - min_value)


def fixed_log_sigma() -> float:
    """The reference trains with a constant observation log-sigma of
    softclip(1.0, -6) = -6 + log1p(exp(7)) ~= 1.00091."""
    return -6.0 + math.log1p(math.exp(1.0 - (-6.0)))


def vae_loss(x: torch.Tensor, recon: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, y: torch.Tensor, y_hat: torch.Tensor,
             log_sigma=None, mask: torch.Tensor | None = None,
             denom: torch.Tensor | None = None):
    """mean_B(KLD + sum_{N,3} NLL - 2 log q(y)); x, recon [B, N, 3], mu,
    logvar [B, Z], y one-hot and y_hat softmax [B, C].

    `mask` [B] (1 = real sample, 0 = batch padding) turns the batch mean
    into a masked mean; `denom` replaces its denominator max(mask.sum(), 1)
    (under data parallelism: the global batch's, so the ranks' losses sum
    to the global mean). log q(y) is log(sum(y_hat * y)) on the softmax
    output, as in the reference. Returns (loss, aux) with aux = dict(kld
    [B], rec_loss [B], correct scalar, logqy [B])."""
    if log_sigma is None:
        log_sigma = fixed_log_sigma()
    kl = kld(mu, logvar)
    rec = gaussian_nll(recon, log_sigma, x).sum(-1).sum(-1)
    logqy = torch.log(torch.sum(y_hat * y, dim=-1))
    per_sample = kl + rec - 2.0 * logqy
    hits = (torch.argmax(y_hat, dim=-1) == torch.argmax(y, dim=-1)).to(
        per_sample.dtype)
    if mask is None:
        loss = per_sample.mean()
        correct = hits.sum()
    else:
        if denom is None:
            denom = torch.clamp(mask.sum(), min=1.0)
        loss = torch.sum(per_sample * mask) / denom
        correct = torch.sum(hits * mask)
    return loss, {"kld": kl, "rec_loss": rec, "correct": correct,
                  "logqy": logqy}
