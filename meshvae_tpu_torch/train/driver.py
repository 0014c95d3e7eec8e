"""K-fold train / test driver (counterpart of meshvae_tpu/train/driver.py,
one process, eager): the body of ``python -m meshvae_tpu_torch.train``.

  * the template (a missing scaled one is generated), the hierarchy
    (cached), the operators in the config's compute dtype and the model;
  * an initial-weights snapshot that every fold restarts from;
  * stratified k-fold over the mesh listing and a train/validation split
    of each fold's training part (train/splits.py, scikit-learn's streams);
  * per epoch: the step LR, train_epoch, evaluate, a halt on a non-finite
    loss that names the last good checkpoint, and the best-validation
    checkpoint; history{fold}.json and the log;
  * resume of the first fold from ``checkpoint_file`` (the port's ``.pt``
    or the JAX package's ``.msgpack``);
  * the test path, with the sex-change .obj triples under ``vis``.

The JAX driver's scanned and pipelined epochs, multi-host barriers and
profiler hooks have no counterpart here.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.dataset import BatchIterator, MeshDataset, list_meshes
from ..device import resolve_device
from ..mesh.hierarchy import load_or_build_hierarchy
from ..mesh.io import load_obj, save_obj
from ..models.operators import build_operators
from ..models.vae import MeshVAE, VAEConfig
from ..tools.make_scaled_template import ensure_template
from .checkpoint import (checkpoint_path, find_checkpoint, load_checkpoint,
                         load_params, save_checkpoint, save_params)
from .loop import Trainer, lr_for_epoch, make_optimizer, set_learning_rate
from .metrics import RunLog, epoch_line, history_record, write_history
from .splits import stratified_kfold, train_test_split


def check_supported(config: dict) -> None:
    """Raise on settings the port does not run yet (they are queued in
    ROADMAP.md), rather than ignoring them."""
    unsupported = {
        "type": (config.get("type", "cheb_VAE"), "cheb_VAE"),
        "pool_method": (config.get("pool_method", "gather"), "gather"),
        "hierarchy_mode": (config.get("hierarchy_mode", "fast"), "fast"),
        "data_parallel": (int(config.get("data_parallel", 1)), 1),
        "seq_parallel": (int(config.get("seq_parallel", 1)), 1),
        "multihost": (bool(config.get("multihost", False)), False),
    }
    for key, (value, ported) in unsupported.items():
        if value != ported:
            raise ValueError(f"{key} = {value!r} is not ported yet; the "
                             f"port runs {key} = {ported!r}")


def build_model_and_ops(config: dict, device="cuda",
                        generator: torch.Generator | None = None):
    """Template -> hierarchy -> operators (in the config's compute dtype)
    -> MeshVAE on `device` in eval mode, weights drawn from `generator`.
    Returns (model, ops, hier, template)."""
    check_supported(config)
    device = resolve_device(device)
    ensure_template(config["template"])
    template = load_obj(config["template"])
    hier = load_or_build_hierarchy(template, config["downsampling_factors"],
                                   cache_dir=config.get("hierarchy_cache_dir")
                                   or None)
    cfg = VAEConfig.from_config(config, coarse_verts=hier.levels[-1],
                                num_features=template.v.shape[1])
    ops = build_operators(
        hier, device, cheb_method=config.get("cheb_method", "dense"),
        final_conv_adjacency=config.get("final_conv_adjacency",
                                        "reference_quirk"),
        dtype=cfg.dtype)
    model = MeshVAE(cfg, generator=generator).to(device).eval()
    return model, ops, hier, template


def _restart(trainer: Trainer, params: dict,
             optimizer_state: dict | None = None) -> None:
    """Load `params` into the model with a fresh (or the given) Adam. A
    saved param group's missing keys keep the fresh optimizer's values (a
    JAX checkpoint's group holds only lr; see train/checkpoint.py)."""
    trainer.model.load_state_dict(params)
    trainer.optimizer = make_optimizer(trainer.model.parameters(),
                                       float(trainer.config["learning_rate"]),
                                       float(trainer.config["weight_decay"]))
    if optimizer_state is not None:
        fresh = trainer.optimizer.state_dict()["param_groups"]
        groups = [{**f, **g} for f, g in
                  zip(fresh, optimizer_state["param_groups"])]
        trainer.optimizer.load_state_dict(dict(optimizer_state,
                                               param_groups=groups))


def run(config: dict, do_train: bool, do_test: bool, vis: bool = False,
        device="cuda") -> list[dict]:
    """Train and/or test every fold; returns one dict of test averages
    (and mean_error) per tested fold."""
    checkpoint_dir = config["checkpoint_dir"]
    os.makedirs(checkpoint_dir, exist_ok=True)
    seed = int(config["random_seeds"])
    n_splits = int(config["folds"])
    test_size = float(config["test_size"])
    batch_size = int(config["batch_size"])
    total_epochs = int(config["epoch"])
    base_lr = float(config["learning_rate"])

    model, ops, hier, template = build_model_and_ops(config, device)
    trainer = Trainer(model, ops, config, device=device)
    faces = np.asarray(template.f)

    log = RunLog(config["log_file"])
    try:
        log.print("model type:", config["type"])
        log.print("optimizer type", config["optimizer"])
        log.print("learning rate:", base_lr)
        log.print("compute dtype:", model.cfg.compute_dtype,
                  "matmul precision:", model.cfg.precision,
                  "device:", trainer.device)

        init_path = os.path.join(checkpoint_dir, "initial_weight.pt")
        save_params(init_path, trainer.init_params(seed))

        dataset_index, labels = list_meshes(config)
        if not dataset_index:
            raise RuntimeError(f"no meshes found under {config['root_dir']}")

        # resume restores params, Adam state and epoch into the first fold;
        # later folds start fresh from the initial snapshot
        resume = None
        if config.get("checkpoint_file"):
            resume = load_checkpoint(config["checkpoint_file"])
            log.print("resuming from", config["checkpoint_file"],
                      "at epoch", resume["epoch_num"])

        results = []
        names = np.array(dataset_index)
        folds = stratified_kfold(n_splits, np.ones(len(dataset_index)), seed)
        for n, (train_index, test_index) in enumerate(folds, start=1):
            train_names, valid_names = train_test_split(
                names[train_index], test_size=test_size, seed=seed)
            _restart(trainer, load_params(init_path))
            start_epoch = 1
            if resume is not None and n == 1:
                _restart(trainer, resume["model"], resume["optimizer"])
                start_epoch = int(resume["epoch_num"]) + 1
            if do_train:
                _train_fold(trainer, config, log, n, list(train_names),
                            list(valid_names), labels, template,
                            start_epoch, total_epochs, seed)
            if do_test:
                results.append(_test_fold(trainer, config, log, n,
                                          list(names[test_index]), labels,
                                          template, faces, vis))
    finally:
        log.close()
    return results


def _train_fold(trainer: Trainer, config: dict, log: RunLog, n: int,
                train_names: list[str], valid_names: list[str],
                labels: dict, template, start_epoch: int, total_epochs: int,
                seed: int) -> None:
    checkpoint_dir = config["checkpoint_dir"]
    batch_size = int(config["batch_size"])
    tv = np.asarray(template.v)
    train_ds = MeshDataset(train_names, config, labels, template=tv,
                           dtype="train")
    valid_ds = MeshDataset(valid_names, config, labels, template=tv,
                           dtype="test")
    train_loader = BatchIterator(train_ds, batch_size, shuffle=True,
                                 seed=seed + n)
    valid_loader = BatchIterator(valid_ds, batch_size, shuffle=False)
    mean, std = train_ds.mean, train_ds.std
    generator = torch.Generator(device=trainer.device).manual_seed(
        seed * 1000 + n)
    best_loss = float("inf")
    history = []
    for epoch in range(start_epoch, total_epochs + 1):
        begin = time.time()
        set_learning_rate(trainer.optimizer, lr_for_epoch(
            epoch, float(config["learning_rate"]), config["learning_rates"],
            config["learning_rates_epochs"]))
        train_avg = trainer.train_epoch(train_loader, generator, mean, std)
        valid_avg, errors = trainer.evaluate(valid_loader, mean, std)
        mean_val_error = float(errors.mean()) if errors.size else 0.0
        duration = time.time() - begin
        record = history_record(epoch, begin, duration, train_avg, valid_avg,
                                mean_val_error)
        if not (np.isfinite(train_avg["loss"])
                and np.isfinite(valid_avg["loss"])):
            msg = (f"non-finite loss at fold {n} epoch {epoch} (train "
                   f"{train_avg['loss']}, val {valid_avg['loss']})")
            log.print(msg)
            history.append(record)
            write_history(checkpoint_dir, n, history)
            if config.get("halt_on_nonfinite", True):
                ckpt = checkpoint_path(checkpoint_dir, n)
                hint = (f"; best checkpoint so far: {ckpt}"
                        if os.path.exists(ckpt) else
                        "; no finite epoch completed — no checkpoint was "
                        "saved")
                raise RuntimeError(msg + hint + " (set halt_on_nonfinite "
                                   "= False to keep training through it)")
            continue
        if valid_avg["loss"] <= best_loss:
            save_checkpoint(checkpoint_path(checkpoint_dir, n),
                            trainer.model.state_dict(),
                            trainer.optimizer.state_dict(), epoch,
                            train_avg["loss"], valid_avg["loss"])
            best_loss = valid_avg["loss"]
        history.append(record)
        if epoch % 10 == 0:
            log.print(epoch_line(epoch, train_avg, valid_avg,
                                 mean_val_error))
    write_history(checkpoint_dir, n, history)


def _test_fold(trainer: Trainer, config: dict, log: RunLog, n: int,
               test_names: list[str], labels: dict, template, faces,
               vis: bool) -> dict:
    checkpoint_dir = config["checkpoint_dir"]
    test_ds = MeshDataset(test_names, config, labels,
                          template=np.asarray(template.v), dtype="test")
    test_loader = BatchIterator(test_ds, int(config["batch_size"]),
                                shuffle=False)
    with np.load(os.path.join(checkpoint_dir, "norm.npz")) as norm:
        mean = norm["mean"].astype(np.float32)
        std = norm["std"].astype(np.float32)
    trainer.model.load_state_dict(
        load_checkpoint(find_checkpoint(checkpoint_dir, n))["model"])
    test_avg, errors, meshes = trainer.evaluate(test_loader, mean, std,
                                                collect_meshes=True)
    if vis:
        _save_sex_change_meshes(checkpoint_dir, n, test_ds, meshes, faces)
    log.print(
        "round {} test loss {},  mean error: {}, train sigma {}, "
        "classification acc {}, sex change rate {}".format(
            n, test_avg["loss"], float(errors.mean()), float(errors.std()),
            test_avg["accuracy"], test_avg["sex_change_success_rate"]))
    return {"fold": n, **{k: float(v) for k, v in test_avg.items()},
            "mean_error": float(errors.mean())}


def _save_sex_change_meshes(checkpoint_dir: str, fold: int,
                            dataset: MeshDataset, meshes: dict,
                            faces: np.ndarray) -> None:
    """recon / gt / oppo .obj triples into mesh{fold}/sex_change_{S,F}."""
    save_path = os.path.join(checkpoint_dir, f"mesh{fold}")
    success_path = os.path.join(save_path, "sex_change_S")
    failed_path = os.path.join(save_path, "sex_change_F")
    os.makedirs(success_path, exist_ok=True)
    os.makedirs(failed_path, exist_ok=True)
    for i in range(meshes["index"].shape[0]):
        ds_idx = int(meshes["index"][i])
        stem = os.path.basename(dataset.filenames[ds_idx]).split(".")[0]
        out_dir = (success_path if meshes["oppo_pred"][i]
                   == meshes["oppo_label"][i] else failed_path)
        save_obj(os.path.join(out_dir, stem + "_recon.obj"),
                 meshes["recon"][i], faces)
        save_obj(os.path.join(out_dir, stem + "_gt.obj"),
                 dataset.original[ds_idx], faces)
        save_obj(os.path.join(out_dir, stem + ".obj"), meshes["oppo"][i],
                 faces)
