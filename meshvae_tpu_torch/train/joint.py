"""Trainer of the joint disentangled VAE + classifier, BASELINE config 3
(counterpart of meshvae_tpu/train/joint.py).

A Trainer (train/loop.py) with the joint objective (models/joint.py) in
place of the VAE loss: the same train and eval steps, per-step loop,
scanned epoch and CUDA graphs, checkpoints and sex-change counterfactual
(which drives the joint model through its MeshVAE delegations).
"accuracy" is the jointly trained GCN's, this configuration's classifier;
the eval averages and history{fold}.json add ``sup_accuracy`` (the
supervised latent slice's head) and ``adv_accuracy`` (the adversarial
head on the free slice: lower is better scrubbed). In an sp world x, the
decodes, the GCN's difference features and its activations at
row-sharded levels are the rank's rows, as the VAE's (train/loop.py).

The scanned train step times two sub-phases (``sub_phases``,
train/phases.py) by two marks of its own: ``gcn`` where the two decodes
have ended and the GCN starts, ``gcn_grad`` where the backward's gradient
reaches the GCN's input (models/joint.py). ``gcn_forward`` (gcn ->
forward) is the GCN's forward and the joint loss inside the ``forward``
phase, ``gcn_backward`` (forward -> gcn_grad) the loss's and the GCN's
backward inside ``backward``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.joint import joint_loss
from . import phases
from .loop import Trainer


class JointTrainer(Trainer):
    extra_scalar_names = ("sup_accuracy", "adv_accuracy")
    sub_phases = {"gcn_forward": ("gcn", "forward"),
                  "gcn_backward": ("forward", "gcn_grad")}

    def _extra_scalars(self, aux: dict) -> list:
        return [aux["sup_correct"], aux["adv_correct"]]

    def __init__(self, model, ops, config: dict, device="cuda", dist=None):
        super().__init__(model, ops, config, device=device, dist=dist)
        self.sup_weight = float(config.get("sup_weight", 1.0))
        self.adv_weight = float(config.get("adv_weight", 0.1))
        self.cls_weight = float(config.get("cls_weight", 1.0))

    def _forward_loss(self, batch: dict, train: bool,
                      generator: torch.Generator | None,
                      mark=phases.unmarked):
        x, labels, mask = batch["x"], batch["label"], batch["mask"]
        y = F.one_hot(labels, self.num_classes).to(x.dtype)
        out = self.model(x, y, self.ops, train=train, generator=generator,
                         rows=self._rows(x, train), mark=mark)
        denom = self._denominator(mask)
        loss, aux = joint_loss(x, out, y, labels, mask=mask,
                               sup_weight=self.sup_weight,
                               adv_weight=self.adv_weight,
                               cls_weight=self.cls_weight, denom=denom,
                               shard=self.vertex_shard)
        return loss, out, aux, y, denom
