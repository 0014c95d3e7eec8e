"""Train and eval steps and the epoch loop (counterpart of
meshvae_tpu/train/loop.py, eager; one process, or one rank of a ("dp",
"sp") world).

  * one train step is forward, loss, backward, a torch.optim.Adam update
    with L2 added to the gradient before the moments (optax's
    add_decayed_weights -> scale_by_adam -> learning rate, not AdamW), and
    the original-pose per-vertex error on the device; its metrics come
    back as one packed tensor, pulled once;
  * the eval step adds the sex-change counterfactual: decode the same
    latent with the opposite label, re-encode, re-classify;
  * the epoch-granular step LR schedule is ``lr_for_epoch`` +
    ``set_learning_rate``.

With compute_dtype=bfloat16 the model computes in bf16 (models/vae.py)
while the parameters, their gradients and Adam's moments stay float32, and
the loss, the metrics and the pose error are float32.

In a world (parallel/sharding.py), as the JAX package's GSPMD step under a
mesh: each rank runs its dp rows of the global batch, with the operators
row-sharded over sp; the loss and the packed metrics are masked means over
the global batch (the mask sums are summed over dp before the division);
the dropout masks and the noise are drawn for the global batch and sliced
(models/vae.py ``rows``); the gradients are summed over the whole world in
one all-reduce and scaled by 1/sp (the sp ranks of a dp slice hold the
same gradient), so every replica applies the same bits; the metrics, the
eval sums and the eval outputs are summed or gathered over dp.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..mesh.procrustes import apply_inverse_similarity
from ..models.losses import vae_loss
from ..models.vae import MeshVAE
from ..parallel.sharding import fetch, replicate, shard_batch, shard_operators

# order of the packed per-step metrics returned by the train step
METRIC_NAMES = ("loss", "kld", "rec_loss", "error", "correct", "count")


def unpack_metrics(arr) -> dict:
    arr = np.asarray(arr, dtype=np.float64).reshape(-1)
    return dict(zip(METRIC_NAMES, arr))


def lr_for_epoch(epoch: int, base_lr: float, learning_rates: list[float],
                 learning_rates_epochs: list[float]) -> float:
    """Reference step schedule: the last threshold the epoch exceeds wins."""
    lr = base_lr
    for i, threshold in enumerate(learning_rates_epochs):
        if epoch > threshold:
            lr = learning_rates[i]
    return lr


def make_optimizer(params, learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: the same update as the JAX package's optax chain
    add_decayed_weights(wd) -> scale_by_adam(0.9, 0.999, 1e-8) -> lr."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class Trainer:
    """Owns one (model, operators, optimizer) triple on one device.

    Batches are the host dicts of data.BatchIterator (numpy); ``to_device``
    moves the keys a step reads (in a world: the rank's dp rows).
    Randomness (dropout masks, the reparameterisation noise) comes from the
    torch.Generator the caller passes, which must live on the trainer's
    device. With ``dist`` (a parallel.World) the trainer runs on the
    world's device and the operators are sharded for its sp group."""

    BATCH_KEYS = ("x", "label", "r", "s", "m", "mask")

    def __init__(self, model: MeshVAE, ops, config: dict, device="cuda",
                 dist=None):
        self.dist = dist
        self.device = dist.device if dist is not None else resolve_device(
            device)
        self.model = model.to(self.device)
        self.ops = shard_operators(ops, dist)
        self.config = config
        self.num_classes = int(config["num_classes"])
        self.optimizer = make_optimizer(self.model.parameters(),
                                        float(config["learning_rate"]),
                                        float(config["weight_decay"]))

    def init_params(self, seed: int) -> dict:
        """Fresh weights drawn from `seed` (the MeshVAE init
        distributions) and fresh Adam moments; returns the state_dict."""
        fresh = MeshVAE(self.model.cfg,
                        generator=torch.Generator().manual_seed(seed))
        self.model.load_state_dict(fresh.state_dict())
        replicate(self.model.state_dict().values(), self.dist)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        self.optimizer.param_groups[0]["lr"],
                                        float(self.config["weight_decay"]))
        return self.model.state_dict()

    def to_device(self, batch: dict) -> dict:
        batch = shard_batch({k: batch[k] for k in self.BATCH_KEYS}, self.dist)
        out = {}
        for k in self.BATCH_KEYS:
            t = torch.as_tensor(np.asarray(batch[k]))
            t = t.long() if k == "label" else t.float()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def norm_to_device(self, norm_mean, norm_std):
        """Normalisation statistics (numpy or tensors) on the device."""
        return tuple(torch.as_tensor(a, dtype=torch.float32,
                                     device=self.device)
                     for a in (norm_mean, norm_std))

    # ------------------------------------------------------------------
    def _dp_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the dp group (in place; t itself in one process)."""
        if self.dist is not None:
            self.dist.dp_group.all_reduce_(t)
        return t

    def _denominator(self, mask: torch.Tensor) -> torch.Tensor:
        """max(global mask sum, 1): the masked means' denominator."""
        return torch.clamp(self._dp_sum_(mask.sum()), min=1.0)

    def _forward_loss(self, batch: dict, train: bool,
                      generator: torch.Generator | None):
        x = batch["x"]
        y = F.one_hot(batch["label"], self.num_classes).to(x.dtype)
        rows = None
        if train and self.dist is not None and self.dist.dp > 1:
            b = x.shape[0]
            rows = (self.dist.dp_rank * b, self.dist.dp * b)
        out = self.model(x, y, self.ops, train=train, generator=generator,
                         rows=rows)
        denom = self._denominator(batch["mask"])
        loss, aux = vae_loss(x, out["recon"], out["mu"], out["logvar"], y,
                             out["y_hat"], mask=batch["mask"], denom=denom)
        return loss, out, aux, y, denom

    def _reduce_gradients(self) -> None:
        """Sum every gradient over the world in one all-reduce, scaled by
        1/sp: the result is the single-process gradient, the same bits on
        every rank."""
        if self.dist is None or self.dist.size == 1:
            return
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        self.dist.world.all_reduce_(flat)
        if self.dist.sp > 1:
            flat.mul_(1.0 / self.dist.sp)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p))
            offset += n

    @torch.no_grad()
    def _pose_error(self, recon, batch, norm_mean, norm_std):
        """Denormalize + inverse Procrustes + per-vertex euclidean error.
        The ground truth is recomputed from x through the same transforms
        (the dataset's original is aligned @ R * s + m with aligned =
        x * std + mean). Returns (recon_orig [B, N, 3], err [B, N])."""
        def to_orig(t):
            return apply_inverse_similarity(t * norm_std + norm_mean,
                                            batch["r"], batch["s"],
                                            batch["m"])
        recon_orig = to_orig(recon)
        err = torch.sqrt(torch.sum((recon_orig - to_orig(batch["x"])) ** 2,
                                   dim=-1))
        return recon_orig, err

    def train_step(self, batch: dict, generator: torch.Generator | None,
                   norm_mean: torch.Tensor,
                   norm_std: torch.Tensor) -> torch.Tensor:
        """One update from a device batch; returns the packed metrics
        [6] (METRIC_NAMES) on the device. The parameters' .grad hold this
        step's gradients afterwards. generator None makes the step
        deterministic (no dropout, z = mu), for gradient checks."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, out, aux, _, denom = self._forward_loss(
            batch, generator is not None, generator)
        loss.backward()
        self._reduce_gradients()
        self.optimizer.step()
        with torch.no_grad():
            mask = batch["mask"]
            _, err = self._pose_error(out["recon"], batch, norm_mean,
                                      norm_std)
            return self._dp_sum_(torch.stack([
                loss.detach(),
                (aux["kld"] * mask).sum() / denom,
                (aux["rec_loss"] * mask).sum() / denom,
                (err.mean(dim=-1) * mask).sum() / denom,
                aux["correct"],
                mask.sum(),
            ]))

    @torch.no_grad()
    def eval_step(self, batch: dict, norm_mean: torch.Tensor,
                  norm_std: torch.Tensor) -> dict:
        """Eval forward, loss, pose error and the sex-change
        counterfactual. ``scalars`` [7] is loss, kld, rec_loss, correct,
        count, sc_correct and the masked sum of per-mesh mean errors (over
        the global batch in a world; the other outputs are the rank's
        rows)."""
        model, ops = self.model, self.ops
        loss, out, aux, y, denom = self._forward_loss(batch, False, None)
        mask = batch["mask"]
        recon_orig, err = self._pose_error(out["recon"], batch, norm_mean,
                                           norm_std)
        oppo = 1.0 - y
        x_oppo = model.sample(oppo, out["z"], ops)
        y_hat2 = model.classify(model.encode(x_oppo, ops))
        oppo_pred = torch.argmax(y_hat2, dim=-1)
        oppo_label = torch.argmax(oppo, dim=-1)
        sc_correct = ((oppo_pred == oppo_label).to(mask.dtype) * mask).sum()
        oppo_orig, _ = self._pose_error(x_oppo, batch, norm_mean, norm_std)
        scalars = self._dp_sum_(torch.stack([
            loss,
            (aux["kld"] * mask).sum() / denom,
            (aux["rec_loss"] * mask).sum() / denom,
            aux["correct"],
            mask.sum(),
            sc_correct,
            (err.mean(dim=-1) * mask).sum(),
        ]))
        return {"scalars": scalars, "errors": err, "recon_orig": recon_orig,
                "oppo_orig": oppo_orig, "oppo_pred": oppo_pred,
                "oppo_label": oppo_label, "y_hat": out["y_hat"],
                "z": out["z"]}

    # ------------------------------------------------------------------
    def train_epoch(self, loader, generator: torch.Generator, norm_mean,
                    norm_std) -> dict:
        """One pass over the loader; returns the epoch averages."""
        totals = {"loss": 0.0, "kld": 0.0, "rec_loss": 0.0, "error": 0.0}
        correct = count = 0.0
        norm_mean, norm_std = self.norm_to_device(norm_mean, norm_std)
        for batch in loader:
            packed = self.train_step(self.to_device(batch), generator,
                                     norm_mean, norm_std)
            metrics = unpack_metrics(packed.cpu())  # one device->host pull
            n = metrics["count"]
            for k in totals:
                totals[k] += metrics[k] * n
            correct += metrics["correct"]
            count += n
        avg = {k: v / max(count, 1.0) for k, v in totals.items()}
        avg["accuracy"] = correct / max(count, 1.0)
        avg["count"] = count
        return avg

    def evaluate(self, loader, norm_mean, norm_std,
                 collect_meshes: bool = False):
        """Whole-loader eval: averages (with sex_change_success_rate and
        the mean pose error) and the [valid, N] per-vertex errors; with
        collect_meshes also the original-pose reconstructions and
        counterfactuals, their predicted and target labels and the
        dataset indices, valid rows only (the test path's mesh dumps). In
        a world every rank gets all of them: the rows are all-gathered over
        dp (parallel.fetch)."""
        totals = {"loss": 0.0, "kld": 0.0, "rec_loss": 0.0}
        correct = sc_correct = count = err_sum = 0.0
        errors = []
        meshes = {"recon": [], "oppo": [], "oppo_pred": [], "oppo_label": [],
                  "index": []}
        norm_mean, norm_std = self.norm_to_device(norm_mean, norm_std)
        for batch in loader:
            out = self.eval_step(self.to_device(batch), norm_mean, norm_std)
            sc = out["scalars"].cpu().numpy().astype(np.float64)  # one pull
            n = float(sc[4])
            for i, k in enumerate(("loss", "kld", "rec_loss")):
                totals[k] += float(sc[i]) * n
            correct += float(sc[3])
            sc_correct += float(sc[5])
            err_sum += float(sc[6])
            count += n
            keep = np.asarray(batch["mask"]) > 0
            errors.append(fetch(out["errors"], self.dist)[keep])
            if collect_meshes:
                for k, src in (("recon", "recon_orig"), ("oppo", "oppo_orig"),
                               ("oppo_pred", "oppo_pred"),
                               ("oppo_label", "oppo_label")):
                    meshes[k].append(fetch(out[src], self.dist)[keep])
                meshes["index"].append(np.asarray(batch["index"])[keep])
        avg = {k: v / max(count, 1.0) for k, v in totals.items()}
        avg["accuracy"] = correct / max(count, 1.0)
        avg["sex_change_success_rate"] = sc_correct / max(count, 1.0)
        avg["error"] = err_sum / max(count, 1.0)
        avg["count"] = count
        errors = (np.concatenate(errors, axis=0) if errors
                  else np.zeros((0, 1)))
        if collect_meshes:
            meshes = {k: (np.concatenate(v) if v else np.zeros((0,)))
                      for k, v in meshes.items()}
            return avg, errors, meshes
        return avg, errors
