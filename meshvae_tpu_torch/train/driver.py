"""K-fold train / test driver (counterpart of meshvae_tpu/train/driver.py):
the body of ``python -m meshvae_tpu_torch.train``.

  * the template (a missing scaled one is generated), the hierarchy
    (cached), the operators in the config's compute dtype and the model:
    the joint VAE + GCN (models/joint.py, trained by train/joint.py) for
    type = joint_VAE, else the MeshVAE; validate.py refuses a cheb_method
    = ell config whose level-0 convs cannot fit on the card;
  * an initial-weights snapshot that every fold restarts from;
  * stratified k-fold over the mesh listing and a train/validation split
    of each fold's training part (train/splits.py, scikit-learn's streams);
  * per epoch: the step LR, the train and validation passes, a halt on a
    non-finite loss that names the last good checkpoint, and the
    best-validation checkpoint; history{fold}.json and the log;
  * ``scan_epoch`` (default True), as the JAX driver's: each fold's
    train and validation splits are staged on the device once
    (Trainer.stage_batches), every epoch is reshuffled there from its own
    torch.Generator, and its steps run as replayed CUDA graphs on a card
    in one process (eager steps on the CPU and in a world, whose
    collectives are not captured; the log says which); each epoch's
    metrics are pulled once. With ``pipeline_epochs`` (default True)
    epoch N + 1 is queued before epoch N's metrics are read, so the
    halt, the checkpoint (from Trainer.snapshot, taken before the next
    epoch's steps) and the history run one epoch late; a profiled epoch
    is read inside its trace. The test path runs evaluate_scanned.
    ``scan_epoch = False`` runs the per-step loop (train_epoch,
    evaluate). The log gains one line per scanned epoch: the median ms
    per step of each phase of the train and eval steps and the mean gap
    between steps (train/phases.py);
  * resume of the first fold from ``checkpoint_file`` (the port's ``.pt``
    or the JAX package's ``.msgpack``);
  * the test path, with the sex-change .obj triples under ``vis``;
  * with ``profile_dir`` set, a torch.profiler Chrome trace of each fold's
    epoch in metrics.PROFILE_EPOCHS (its train and validation passes);
  * distribution (parallel/sharding.py): with data_parallel x
    seq_parallel > 1 ``run`` starts that many local ranks itself (rank 0
    in this process, the others spawned, meeting on a free localhost
    port), so a config runs as it does in JAX, with one command; with
    ``multihost`` this process is one rank of a world that meets over
    tcp:// at coordinator_address (num_processes, process_id) or, with
    those unset, over the env:// a launcher such as torchrun sets, as
    jax.distributed.initialize auto-detects (``enter_world``, which
    crecon's run shares). Either model type runs in a world. Every rank
    trains; only the primary (rank 0) writes the initial weights, norm
    stats, checkpoints, history, log and .obj dumps, with barriers where
    the JAX driver has them, before the other ranks read a file back.

"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import parse_bool
from ..data.dataset import BatchIterator, MeshDataset, list_meshes
from ..device import resolve_device
from ..mesh.hierarchy import load_or_build_hierarchy
from ..mesh.io import load_obj, save_obj
from ..models.joint import JointMeshVAE, build_joint_model
from ..models.operators import build_operators
from ..models.vae import MeshVAE, VAEConfig
from ..parallel.sharding import (close_world, initialize_multihost,
                                 is_primary, spawn_local, sync_processes)
from ..tools.make_scaled_template import ensure_template
from ..validate import level0_shape, validate_config
from .checkpoint import (checkpoint_path, find_checkpoint, load_checkpoint,
                         load_params, save_checkpoint, save_params)
from . import phases
from .graphs import HostCopy
from .joint import JointTrainer
from .loop import Trainer, lr_for_epoch, set_learning_rate
from .metrics import (RunLog, epoch_line, history_record, is_profiled,
                      maybe_profile, write_history)
from .splits import stratified_kfold, train_test_split


def build_model_and_ops(config: dict, device="cuda",
                        generator: torch.Generator | None = None):
    """Template -> hierarchy (hierarchy_mode "fast" or "reference") ->
    operators (in the config's compute dtype, cheb_method and
    pool_method) -> the model on `device` in eval mode, weights drawn from
    `generator`: a JointMeshVAE for type = joint_VAE, a MeshVAE for every
    other type (crecon's frozen VAE included), as the JAX driver builds
    them. Returns (model, ops, hier, template)."""
    validate_config(config, device)
    device = resolve_device(device)
    ensure_template(config["template"])
    template = load_obj(config["template"])
    hier = load_or_build_hierarchy(template, config["downsampling_factors"],
                                   cache_dir=config.get("hierarchy_cache_dir")
                                   or None,
                                   mode=config.get("hierarchy_mode", "fast"))
    validate_config(config, device, level0=level0_shape(hier.adjacency[0]),
                    num_features=template.v.shape[1])
    cfg = VAEConfig.from_config(config, coarse_verts=hier.levels[-1],
                                num_features=template.v.shape[1])
    ops = build_operators(
        hier, device, cheb_method=config.get("cheb_method", "dense"),
        final_conv_adjacency=config.get("final_conv_adjacency",
                                        "reference_quirk"),
        dtype=cfg.dtype, pool_method=cfg.pool_method)
    if config.get("type") == "joint_VAE":
        model = build_joint_model(config, hier.levels[-1],
                                  template.v.shape[1], generator=generator)
    else:
        model = MeshVAE(cfg, generator=generator)
    return model.to(device).eval(), ops, hier, template


def make_trainer(config: dict, model, ops, device="cuda",
                 dist=None) -> Trainer:
    """The model's trainer: JointTrainer for a JointMeshVAE, else
    Trainer."""
    cls = JointTrainer if isinstance(model, JointMeshVAE) else Trainer
    return cls(model, ops, config, device=device, dist=dist)


def _restart(trainer: Trainer, params: dict,
             optimizer_state: dict | None = None) -> None:
    """Load `params` into the model with a fresh (or the given) Adam. A
    saved param group's missing keys keep the fresh optimizer's values (a
    JAX checkpoint's group holds only lr; see train/checkpoint.py)."""
    trainer.model.load_state_dict(params)
    trainer.reset_optimizer(optimizer_state)


def epoch_mode(config: dict, trainer: Trainer) -> str:
    """The run log's line on how epochs run (module docstring)."""
    if not parse_bool(config.get("scan_epoch", True)):
        return "per-step epoch loop (scan_epoch = False)"
    pipelined = ("pipelined" if parse_bool(config.get("pipeline_epochs", True))
                 else "not pipelined")
    return (f"scanned epoch, staged on {trainer.device} and reshuffled "
            f"there, {pipelined}: {trainer.step_mode()}")


def maybe_init_multihost(config: dict, device="cuda"):
    """The World of this process when the config sets multihost (see the
    module docstring), else None."""
    if not config.get("multihost"):
        return None
    pid = int(config.get("process_id", -1))
    return initialize_multihost(
        int(config.get("data_parallel", 1)),
        int(config.get("seq_parallel", 1)), device,
        coordinator_address=config.get("coordinator_address") or None,
        num_processes=int(config.get("num_processes") or 0) or None,
        process_id=pid if pid >= 0 else None)


def names_world(config: dict) -> bool:
    """True when the config asks for more than one process: data_parallel
    x seq_parallel > 1, or multihost."""
    return bool(config.get("multihost")) or int(
        config.get("data_parallel", 1)) * int(
        config.get("seq_parallel", 1)) > 1


def enter_world(rank_fn, config: dict, device, args: tuple):
    """rank_fn(world, *args) as this process's part of the world the
    config names (names_world; see the module docstring): with multihost
    this process joins the world; else it starts data_parallel x
    seq_parallel local ranks, rank 0 here. Returns this process's
    result."""
    if config.get("multihost"):
        world = maybe_init_multihost(config, device)
        try:
            return rank_fn(world, *args)
        finally:
            close_world()
    return spawn_local(rank_fn, int(config.get("data_parallel", 1)),
                       int(config.get("seq_parallel", 1)), device, args=args)


def _run_rank(world, config, do_train, do_test, vis):
    return run(config, do_train, do_test, vis, device=world.device,
               dist=world)


def run(config: dict, do_train: bool, do_test: bool, vis: bool = False,
        device="cuda", dist=None) -> list[dict]:
    """Train and/or test every fold; returns one dict of test averages
    (and mean_error) per tested fold. `dist` is this rank's World; without
    it the config's data_parallel / seq_parallel / multihost decide (see
    the module docstring)."""
    if dist is None:
        validate_config(config, device)
        if names_world(config):
            return enter_world(_run_rank, config, device,
                               (config, do_train, do_test, vis))
    primary = is_primary(dist)
    checkpoint_dir = config["checkpoint_dir"]
    os.makedirs(checkpoint_dir, exist_ok=True)
    seed = int(config["random_seeds"])
    n_splits = int(config["folds"])
    test_size = float(config["test_size"])
    batch_size = int(config["batch_size"])
    total_epochs = int(config["epoch"])
    base_lr = float(config["learning_rate"])

    model, ops, hier, template = build_model_and_ops(config, device)
    trainer = make_trainer(config, model, ops, device=device, dist=dist)
    faces = np.asarray(template.f)

    log = RunLog(config["log_file"] if primary else None)
    try:
        log.print("model type:", config["type"])
        log.print("optimizer type", config["optimizer"])
        log.print("learning rate:", base_lr)
        log.print("compute dtype:", model.cfg.compute_dtype,
                  "matmul precision:", model.cfg.precision,
                  "device:", trainer.device)
        log.print("epochs:", epoch_mode(config, trainer))

        init_path = os.path.join(checkpoint_dir, "initial_weight.pt")
        init = trainer.init_params(seed)
        if primary:
            save_params(init_path, init)
        # every rank reloads the snapshot at each fold start
        sync_processes(dist)

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
                # the primary's checkpoint and norm.npz are read back
                sync_processes(dist)
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
    primary = is_primary(trainer.dist)
    profile_dir = config.get("profile_dir") if primary else None
    tv = np.asarray(template.v)
    train_ds = MeshDataset(train_names, config, labels, template=tv,
                           dtype="train", write_norm=primary)
    # the primary's norm.npz is read back by the validation split
    sync_processes(trainer.dist)
    valid_ds = MeshDataset(valid_names, config, labels, template=tv,
                           dtype="test")
    train_loader = BatchIterator(train_ds, batch_size, shuffle=True,
                                 seed=seed + n)
    valid_loader = BatchIterator(valid_ds, batch_size, shuffle=False)
    mean, std = train_ds.mean, train_ds.std
    generator = torch.Generator(device=trainer.device).manual_seed(
        seed * 1000 + n)
    scan = parse_bool(config.get("scan_epoch", True))
    pipeline = scan and parse_bool(config.get("pipeline_epochs", True))
    if scan:
        # one upload per fold; epochs reshuffle on the device
        staged_train = trainer.stage_batches(train_loader)
        staged_valid = trainer.stage_batches(valid_loader)
        shuffle = torch.Generator(device=trainer.device).manual_seed(
            seed * 7919 + n)
        norm = trainer.norm_to_device(mean, std)
    best_loss = float("inf")
    history = []
    pending = None

    def consume_pending():
        """Read the epoch in flight: its metrics, then the non-finite
        halt, the best-validation checkpoint and the history."""
        nonlocal best_loss, pending
        if pending is None:
            return
        p, pending = pending, None
        epoch = p["epoch"]
        count = phases.recorded()
        train_avg, (valid_avg, mean_val_error) = (p["train"](), p["valid"]())
        # after the pull, so it covers the epoch's device work; pipelined
        # epochs overlap by the next epoch's dispatch
        duration = time.time() - p["begin"]
        line = phases.epoch_line(epoch, phases.since(count))
        if line is not None:
            log.print(line)
        record = history_record(epoch, p["begin"], duration, train_avg,
                                valid_avg, mean_val_error)
        if not (np.isfinite(train_avg["loss"])
                and np.isfinite(valid_avg["loss"])):
            msg = (f"non-finite loss at fold {n} epoch {epoch} (train "
                   f"{train_avg['loss']}, val {valid_avg['loss']})")
            log.print(msg)
            # the failing epoch stays in the flushed history
            history.append(record)
            if primary:
                write_history(checkpoint_dir, n, history)
            if config.get("halt_on_nonfinite", True):
                ckpt = checkpoint_path(checkpoint_dir, n)
                hint = (f"; best checkpoint so far: {ckpt}"
                        if os.path.exists(ckpt) else
                        "; no finite epoch completed — no checkpoint was "
                        "saved")
                raise RuntimeError(msg + hint + " (set halt_on_nonfinite "
                                   "= False to keep training through it)")
            return
        if valid_avg["loss"] <= best_loss:
            if primary:
                state = (p["snapshot"].wait() if p["snapshot"] is not None
                         else {"model": trainer.model.state_dict(),
                               "optimizer": trainer.optimizer.state_dict()})
                save_checkpoint(checkpoint_path(checkpoint_dir, n),
                                state["model"], state["optimizer"], epoch,
                                train_avg["loss"], valid_avg["loss"])
            best_loss = valid_avg["loss"]
        history.append(record)
        if epoch % 10 == 0:
            log.print(epoch_line(epoch, train_avg, valid_avg,
                                 mean_val_error))

    for epoch in range(start_epoch, total_epochs + 1):
        begin = time.time()
        set_learning_rate(trainer.optimizer, lr_for_epoch(
            epoch, float(config["learning_rate"]), config["learning_rates"],
            config["learning_rates_epochs"]))
        with maybe_profile(profile_dir, epoch, fold=n):
            snapshot = None
            if scan:
                packed = trainer.train_epoch_scanned_async(
                    staged_train, generator, *norm, shuffle_generator=shuffle)
                # light: the validation needs only the per-mesh mean error
                # of the scalars, so no [S, B, N] error rows are written
                eval_pending = trainer.evaluate_scanned_async(
                    staged_valid, *norm, with_errors=False)
                if pipeline and primary:
                    # taken before the next epoch's steps update the
                    # state in place, and pulled as the epoch's metrics are
                    snapshot = HostCopy(trainer.snapshot())
                train = lambda pk=packed: trainer.finalize_train_metrics(pk)

                def valid(ep=eval_pending):
                    avg, _ = trainer.finalize_eval_scanned(
                        ep, with_errors=False)
                    return avg, float(avg["error"])
            else:
                train_avg = trainer.train_epoch(train_loader, generator,
                                                mean, std)
                valid_avg, errors = trainer.evaluate(valid_loader, mean, std)
                mve = float(errors.mean()) if errors.size else 0.0
                train = lambda ta=train_avg: ta
                valid = lambda va=valid_avg, e=mve: (va, e)
            consume_pending()
            pending = {"epoch": epoch, "begin": begin, "train": train,
                       "valid": valid, "snapshot": snapshot}
            # a traced epoch is read inside its trace
            if not pipeline or is_profiled(profile_dir, epoch):
                consume_pending()
    consume_pending()
    if primary:
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
    if parse_bool(config.get("scan_epoch", True)):
        test_avg, errors, meshes = trainer.evaluate_scanned(
            test_loader, *trainer.norm_to_device(mean, std),
            collect_meshes=True)
    else:
        test_avg, errors, meshes = trainer.evaluate(test_loader, mean, std,
                                                    collect_meshes=True)
    if vis and is_primary(trainer.dist):
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
