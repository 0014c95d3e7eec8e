"""Second-stage reconstruction-difference classifier, crecon, BASELINE
config 2 (counterpart of meshvae_tpu/train/crecon_driver.py): the body of
``python -m meshvae_tpu_torch.crecon``.

A frozen, pretrained VAE (``checkpoint_file``: the port's ``.pt``, the
JAX package's ``.msgpack``, or a params file such as an imported reference
checkpoint, train/torch_import.py) turns each batch into difference features
diff = cat(x - recon_oppo, x - recon) [B, N, 6] (``estimate_diff``; train
mode conditions on the true label, eval mode on the prediction), and a
ChebGCN (models/gcn.py) is trained on them with cross entropy and Adam on
its own parameters only.

  * ``CreconTrainer``'s steps pack [loss, correct, count] into one tensor;
    an epoch's average loss is the sum of its batch losses over the number
    of steps, as the reference reports it;
  * ``scan_epoch`` (default True): each fold's splits are staged on the
    device once and the train split is reshuffled there every epoch; the
    steps run as CUDA graphs on a card in one process (train/graphs.py,
    as Trainer's), eagerly on the CPU and in a world. ``scan_epoch =
    False`` runs the per-step loop;
  * ``run`` always runs 5 stratified folds, whatever ``folds`` says, with
    a train/validation split of each fold's training part (the
    reference's, and the JAX driver's); an initial-weights snapshot every
    fold restarts from; per epoch a checkpoint when the validation
    accuracy is at least the best so far; the test path on the final
    weights after training, or on the fold's checkpoint without -t.

With compute_dtype bfloat16 the frozen VAE and the GCN compute in bf16
(the difference features stay float32, as the decode returns them, and
the GCN casts them); the loss, the accuracies and Adam's master weights
are float32.

In a ("dp", "sp") world (``dist``, parallel/sharding.py), as the JAX
package's CreconTrainer under a mesh and the VAE Trainer's world: each
rank runs its dp rows in sp's row layout (x staged as the rank's level-0
rows, per step and in the scanned epoch's staging, as the JAX package's
stage_batches; the frozen VAE's decodes, diff and the GCN's activations
at row-sharded levels the rank's rows); the frozen VAE's weights are
replicated from rank
0; the loss is the masked mean over the global batch, the GCN's gradients
are reduced over the world (Trainer._reduce_gradients), and the packed
[loss, correct, count] are summed over dp, so every rank reports the
single-process numbers. ``run`` enters the world as train/driver.run does
(data_parallel x seq_parallel local ranks, or ``multihost``), and only the
primary writes the initial weights, norm.npz, checkpoints and the log.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..config import parse_bool
from ..data.dataset import BatchIterator, MeshDataset, list_meshes
from ..models.gcn import ChebGCN, GCNConfig
from ..parallel.sharding import is_primary, replicate, sync_processes
from ..validate import validate_config
from .checkpoint import (checkpoint_path, find_checkpoint, load_checkpoint,
                         load_model_state, load_params, save_checkpoint,
                         save_params)
from .driver import build_model_and_ops, enter_world, names_world
from .loop import Trainer, _host
from .metrics import RunLog
from .splits import stratified_kfold, train_test_split

FOLDS = 5  # the reference's crecon.py runs five folds whatever `folds` says


@torch.no_grad()
def estimate_diff(vae, x: torch.Tensor, labels: torch.Tensor, ops,
                  train: bool):
    """Frozen-VAE difference features. x [B, N, 3] normalized, labels [B]
    -> (diff [B, N, 6], correct, pred [B]). The same-label and the
    opposite-label decodes run as one decoder pass at 2B rows. In sp's row
    layout x, the two decodes and diff are the rank's rows [B,
    rows_local, .] of level 0 (zero past N), as the GCN's first conv
    takes them."""
    h = vae.encode(x, ops)
    y_hat = vae.classify(h)
    pred = torch.argmax(y_hat, dim=-1)
    correct = (pred == labels).sum()
    onehot = F.one_hot(labels if train else pred, y_hat.shape[-1]).to(x.dtype)
    mu = vae.posterior_mean(torch.cat([onehot, h], dim=-1))
    b = x.shape[0]
    both = vae.sample(torch.cat([onehot, 1.0 - onehot], dim=0),
                      torch.cat([mu, mu], dim=0), ops)
    diff = torch.cat([x - both[b:], x - both[:b]], dim=-1)
    return diff, correct, pred


class CreconTrainer(Trainer):
    """The GCN's trainer over a frozen VAE. Of Trainer it takes the Adam
    (over the GCN's parameters), init_params, staging and the scanned
    epoch with its CUDA graphs; its steps take the batch keys x, label and
    mask and no normalisation, and ``run_epoch`` is its epoch."""

    BATCH_KEYS = ("x", "label", "mask")

    def __init__(self, gcn: ChebGCN, vae, ops, config: dict, device="cuda",
                 dist=None):
        super().__init__(gcn, ops, config, device=device, dist=dist)
        self.vae = vae.to(self.device).eval().requires_grad_(False)
        replicate(self.vae.state_dict().values(), dist)
        self.scan_epoch = parse_bool(config.get("scan_epoch", True))

    def _loss(self, diff, labels, mask):
        logits = self.model(diff, self.ops)
        nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        return torch.sum(nll * mask) / self._denominator(mask), logits

    def _packed(self, loss, logits, batch) -> torch.Tensor:
        """[loss, correct, count] over the global batch."""
        mask = batch["mask"]
        pred = torch.argmax(torch.softmax(logits, dim=-1), dim=-1)
        correct = ((pred == batch["label"]).to(mask.dtype) * mask).sum()
        return self._dp_sum_(torch.stack([loss.detach(), correct,
                                          mask.sum()]))

    def train_step(self, batch: dict, generator=None,
                   mark=None) -> torch.Tensor:
        """One Adam update of the GCN from a device batch; returns the
        packed [loss, correct, count]. The frozen VAE draws nothing, so
        the generator is unused; so is `mark` (the scanned epoch's phase
        marks): crecon's epochs stage no stamps (_scan_outs)."""
        self.optimizer.zero_grad(set_to_none=True)
        diff, _, _ = estimate_diff(self.vae, batch["x"], batch["label"],
                                   self.ops, train=True)
        loss, logits = self._loss(diff, batch["label"], batch["mask"])
        loss.backward()
        self._reduce_gradients()
        self.optimizer.step()
        with torch.no_grad():
            return self._packed(loss, logits, batch)

    @torch.no_grad()
    def eval_step(self, batch: dict, mark=None) -> dict:
        diff, _, _ = estimate_diff(self.vae, batch["x"], batch["label"],
                                   self.ops, train=False)
        loss, logits = self._loss(diff, batch["label"], batch["mask"])
        return {"scalars": self._packed(loss, logits, batch)}

    def _scan_outs(self, kind: str, staged: dict) -> dict:
        """The [S, 3] rows of the packed scalars; crecon's epochs, read by
        run_epoch without the finalizers, stage no phase stamps."""
        rows = staged["mask"].shape[0]
        return {"metrics" if kind == "train" else "scalars":
                torch.zeros((rows, 3), device=self.device)}

    @staticmethod
    def _averages(per_step: np.ndarray):
        """per_step [S, 3] of (batch loss, correct, count) -> (the sum of
        batch losses / S, correct / count)."""
        per_step = np.asarray(per_step, dtype=np.float64).reshape(-1, 3)
        steps = per_step.shape[0]
        count = float(per_step[:, 2].sum())
        return (float(per_step[:, 0].sum()) / max(steps, 1),
                float(per_step[:, 1].sum()) / max(count, 1.0))

    def run_epoch(self, loader, train: bool,
                  shuffle_generator: torch.Generator | None = None):
        """One epoch over a loader (the per-step loop, one pull per step)
        or a stage_batches dict (the scanned epoch, reshuffled on the
        device from shuffle_generator when training; one pull); None is an
        empty split. Returns (average loss, accuracy)."""
        if loader is None:
            return 0.0, 0.0
        if isinstance(loader, dict):
            if train:
                packed = self.train_epoch_scanned_async(
                    loader, None, None, None,
                    shuffle_generator=shuffle_generator)
                return self._averages(_host(packed))
            pending = self.evaluate_scanned_async(loader, None, None,
                                                  with_errors=False)
            return self._averages(_host(pending["outs"].wait()["scalars"]))
        rows = []
        for batch in loader:
            batch = self.to_device(batch)
            packed = (self.train_step(batch) if train
                      else self.eval_step(batch)["scalars"])
            rows.append(_host(packed))
        return self._averages(np.stack(rows)) if rows else (0.0, 0.0)


def _run_rank(world, config, do_train, do_test):
    return run(config, do_train, do_test, device=world.device, dist=world)


def run(config: dict, do_train: bool, do_test: bool, device="cuda",
        dist=None) -> list[dict]:
    """Train and/or test the GCN over 5 folds; returns one dict per tested
    fold: fold, test_loss, test_acc. `dist` is this rank's World; without
    it the config's data_parallel / seq_parallel / multihost decide, as
    in train/driver.run."""
    vae_ckpt = config.get("checkpoint_file")
    if not vae_ckpt or not os.path.exists(vae_ckpt):
        raise FileNotFoundError(
            f"crecon needs a pretrained VAE checkpoint; checkpoint_file="
            f"{vae_ckpt!r} not found")
    if dist is None:
        validate_config(config, device)
        if names_world(config):
            return enter_world(_run_rank, config, device,
                               (config, do_train, do_test))
    primary = is_primary(dist)
    checkpoint_dir = config["checkpoint_dir"]
    os.makedirs(checkpoint_dir, exist_ok=True)
    seed = int(config["random_seeds"])

    vae, ops, hier, template = build_model_and_ops(config, device)
    vae.load_state_dict(load_model_state(vae_ckpt))
    gcn = ChebGCN(GCNConfig.from_config(
        config, coarse_verts=hier.levels[-1],
        num_features=2 * template.v.shape[1]))
    trainer = CreconTrainer(gcn, vae, ops, config, device=device, dist=dist)

    log = RunLog(config["log_file"] if primary else None)
    try:
        log.print("model type:", config["type"])
        log.print("frozen VAE:", vae_ckpt, "matmul precision:",
                  gcn.cfg.precision, "device:", trainer.device)
        log.print("epochs:", (f"scanned epoch, staged on {trainer.device} "
                              f"and reshuffled there: {trainer.step_mode()}"
                              if trainer.scan_epoch else
                              "per-step epoch loop (scan_epoch = False)"))
        init_path = os.path.join(checkpoint_dir, "initial_weight_gcn.pt")
        init = trainer.init_params(seed)
        if primary:
            save_params(init_path, init)
        # every rank reloads the snapshot at each fold start
        sync_processes(dist)

        dataset_index, labels = list_meshes(config)
        if not dataset_index:
            raise RuntimeError(f"no meshes found under {config['root_dir']}")
        names = np.array(dataset_index)
        tv = np.asarray(template.v)
        results = []
        folds = stratified_kfold(FOLDS, np.ones(len(names)), seed)
        for n, (train_index, test_index) in enumerate(folds, start=1):
            train_names, valid_names = train_test_split(
                names[train_index], test_size=float(config["test_size"]),
                seed=seed)
            trainer.model.load_state_dict(load_params(init_path))
            trainer.reset_optimizer()
            if do_train:
                _train_fold(trainer, config, log, n, list(train_names),
                            list(valid_names), labels, tv, seed)
            if do_test:
                # the primary's checkpoint and norm.npz are read back
                sync_processes(dist)
                if not do_train:
                    trainer.model.load_state_dict(load_checkpoint(
                        find_checkpoint(checkpoint_dir, n))["model"])
                test_ds = MeshDataset(list(names[test_index]), config,
                                      labels, template=tv, dtype="test")
                te_loss, te_acc = trainer.run_epoch(
                    _loader(trainer, test_ds, config), train=False)
                log.print("test loss ", te_loss, "test acc", te_acc)
                results.append({"fold": n, "test_loss": te_loss,
                                "test_acc": te_acc})
    finally:
        log.close()
    return results


def _loader(trainer: CreconTrainer, ds: MeshDataset, config: dict,
            shuffle: bool = False, seed: int = 0):
    """A split's batches: staged on the device for the scanned epoch, else
    the host loader."""
    loader = BatchIterator(ds, int(config["batch_size"]), shuffle=shuffle,
                           seed=seed)
    return trainer.stage_batches(loader) if trainer.scan_epoch else loader


def _train_fold(trainer: CreconTrainer, config: dict, log: RunLog, n: int,
                train_names: list[str], valid_names: list[str], labels: dict,
                tv: np.ndarray, seed: int) -> None:
    checkpoint_dir = config["checkpoint_dir"]
    primary = is_primary(trainer.dist)
    train_ds = MeshDataset(train_names, config, labels, template=tv,
                           dtype="train", write_norm=primary)
    # the primary's norm.npz is read back by the validation split
    sync_processes(trainer.dist)
    valid_ds = MeshDataset(valid_names, config, labels, template=tv,
                           dtype="test")
    train_loader = _loader(trainer, train_ds, config, shuffle=True,
                           seed=seed + n)
    valid_loader = _loader(trainer, valid_ds, config)
    shuffle = (torch.Generator(device=trainer.device).manual_seed(
        seed * 7919 + n) if trainer.scan_epoch else None)
    best_val_acc = 0.0
    for epoch in range(1, int(config["epoch"]) + 1):
        tr_loss, tr_acc = trainer.run_epoch(train_loader, True, shuffle)
        va_loss, va_acc = trainer.run_epoch(valid_loader, False)
        if va_acc >= best_val_acc:
            if primary:
                save_checkpoint(checkpoint_path(checkpoint_dir, n),
                                trainer.model.state_dict(),
                                trainer.optimizer.state_dict(), epoch,
                                tr_loss, va_loss)
            best_val_acc = va_acc
        log.print("epoch ", epoch, " Train loss ", tr_loss, "train acc",
                  tr_acc, " Val loss ", va_loss, "acc ", va_acc)
