"""Inference engine (counterpart of meshvae_tpu/infer/driver.py
``InferenceEngine._step_impl``): predict the label with the classifier
head, reconstruct conditioned on the predicted label and decode the
label-swapped counterfactual from the same latent as ONE decoder pass at
batch 2B, map both back to the original pose, and score the
reconstruction when the original is given. The encoder runs once."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..mesh.procrustes import apply_inverse_similarity
from ..models.operators import ModelOperators


class InferenceEngine:
    """model: an eval-mode MeshVAE; ops: ModelOperators on the same device."""

    def __init__(self, model, ops: ModelOperators):
        self.model = model
        self.ops = ops

    @torch.inference_mode()
    def step(self, batch: dict, norm_mean: torch.Tensor,
             norm_std: torch.Tensor) -> dict:
        """batch: x [B, N, 3] normalized aligned vertices, r [B, 3, 3],
        s [B], m [B, 1, 3] (inverse similarity), optionally original
        [B, N, 3]. Returns pred [B], recon_orig / oppo_orig [B, N, 3] and,
        with original, err_mean / err_max [B]."""
        model, ops = self.model, self.ops
        x = batch["x"]
        h = model.encode(x, ops)
        y_hat = model.classify(h)
        pred = torch.argmax(y_hat, dim=-1)
        y = F.one_hot(pred, y_hat.shape[-1]).to(x.dtype)
        mu = model.z_mean(torch.cat([y, h], dim=-1))
        b = x.shape[0]
        both = model.sample(torch.cat([y, 1.0 - y], dim=0),
                            torch.cat([mu, mu], dim=0), ops)
        recon, recon_oppo = both[:b], both[b:]

        def to_orig(t):
            return apply_inverse_similarity(t * norm_std + norm_mean,
                                            batch["r"], batch["s"], batch["m"])

        out = {"pred": pred, "recon_orig": to_orig(recon),
               "oppo_orig": to_orig(recon_oppo)}
        if "original" in batch:
            err = torch.sqrt(torch.sum(
                (out["recon_orig"] - batch["original"]) ** 2, dim=-1))
            out["err_mean"] = err.mean(dim=-1)
            out["err_max"] = err.max(dim=-1).values
        return out
