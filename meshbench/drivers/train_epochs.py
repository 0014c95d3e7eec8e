"""Driver of the training mixes: scanned, graphed epochs as the port's k-fold
driver runs them (meshvae_tpu_torch/train/driver.py ``_train_fold`` with
``scan_epoch`` and ``pipeline_epochs`` on).

Traffic parameters (traffic/<mix>.json): ``train_meshes`` and
``valid_meshes`` (the fold's training and validation splits, made from the
seed), ``check_steps`` (the first steps the reference follows),
``profile_epochs`` (the traced sub-window), ``deform_scale`` and
``class_scale`` (the synthetic meshes).

Set-up: the template, the meshes, their alignment and normalisation; the
program's model, operators and Trainer with the benchmark's weights; the
checked steps (below); then the fold's splits staged once
(``Trainer.stage_batches``) and one whole epoch, which warms up and
captures the window's train and eval step graphs.

Checked steps, through the window's own calls on a staged epoch of one
batch, each a replay of a captured step graph as the window's steps are:
the light evaluation step (``Trainer.evaluate_scanned_async``) on the
first rows of the validation split at the seed's weights, called three
times (warm-up, capture, replay) and the replay's packed scalars kept;
then the train step (``Trainer.train_epoch_scanned_async``), called twice
to warm it up and capture it, the seed's weights and a fresh Adam state
put back in place (the graph holds those tensors), and the first
``check_steps`` steps replayed, each on the next rows of the training
split copied into the staged batch. Adam's state after step 1 and the
parameters after the last step are read.

Window: epochs until ``--seconds`` have passed, each the lr for the
epoch, the scanned train epoch reshuffled on the device, the scanned
light evaluation of the validation split, and the previous epoch's
metrics pulled once it is queued (the epoch pipeline); the window closes
when the last epoch's metrics are on the host. No checkpoint, snapshot or
history is written. train_meshes_per_s is the training meshes stepped
over the window's seconds.

Check: after the window (and the traced sub-window), the program is
freed and the reference follows the checked steps from the same weights,
rows and dropout draws (a copy of the generator's state before step 1),
in float32 and, for a bfloat16 configuration, once more rounded as the
configuration computes for the first gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import data, judge, trace
from ..harness import Outcome, program_config
from ..reference import model as ref_model
from ..workcount import ModelShape
from . import common

KEYS = ("x", "label", "r", "s", "m")


def _host(copy) -> np.ndarray:
    t = copy.wait()
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _plant(fault: str | None, trainer) -> None:
    """A fault in the program, for the check's own tests and calibration:
    a step that leaves its state unchanged; a step whose loss is the mean
    over half of its batch; a step that reads the first half of its rows
    twice while it counts them all."""
    if fault is None:
        return
    if fault == "frozen_state":
        trainer.optimizer.step = lambda *a, **k: None
        return
    scan_batch = trainer._scan_batch
    if fault == "half_batch":
        def batch_of(st):
            batch = scan_batch(st)
            keep = torch.ones_like(batch["mask"])
            keep[keep.shape[0] // 2:] = 0.0
            return dict(batch, mask=batch["mask"] * keep)
    elif fault == "duplicate_rows":
        def batch_of(st):
            batch = scan_batch(st)
            half = batch["mask"].shape[0] // 2
            return {k: torch.cat([v[:half], v[:half]])
                    for k, v in batch.items()}
    else:
        raise ValueError(f"unknown training fault {fault!r}")
    trainer._scan_batch = batch_of


def _feed(staged: dict, new: dict) -> None:
    """A staged batch's rows into `staged`'s tensors, in place."""
    for k, t in staged.items():
        if isinstance(t, torch.Tensor):
            t.copy_(new[k])


def _restore(trainer, model, weights: dict) -> None:
    """The seed's weights and a fresh Adam state (moments and step count
    nought), in place."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(weights[k])
        for state in trainer.optimizer.state.values():
            for t in state.values():
                if isinstance(t, torch.Tensor):
                    t.zero_()


def _checked_eval(trainer, batch: dict, norm) -> dict:
    """The light evaluation step's loss, mean pose error and rows, read
    from a replay of its graph."""
    staged = trainer.stage_batches([batch])
    for _ in range(3):
        avg, _ = trainer.finalize_eval_scanned(
            trainer.evaluate_scanned_async(staged, *norm, with_errors=False),
            with_errors=False)
    return {"loss": avg["loss"], "error": avg["error"], "rows": avg["count"]}


def _checked_steps(trainer, model, weights, batches, gen, norm):
    """(readings, the dropout generator's state before step 1): each
    step's loss and counted rows, the norms of the first gradient as Adam
    holds it after step 1 (its first moment over 1 - beta1) and of each
    leaf's change after the last step."""
    from meshvae_tpu_torch.train.loop import METRIC_NAMES

    staged = trainer.stage_batches(batches[:1])
    for _ in range(2):
        _host(trainer.train_epoch_scanned_async(staged, gen, *norm))
    _restore(trainer, model, weights)
    gen_state = gen.get_state()
    named = dict(model.named_parameters())
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    steps, grad = [], None
    for i, batch in enumerate(batches):
        if i:
            _feed(staged, trainer.stage_batches([batch]))
        steps.append(_host(trainer.train_epoch_scanned_async(staged, gen,
                                                             *norm)))
        if i == 0:
            state = trainer.optimizer.state
            grad = {k: (float((state[p]["exp_avg"] / (1.0 - beta1))
                              .double().norm()) if p in state else 0.0)
                    for k, p in named.items()}
    update = {k: float((p.detach() - weights[k]).double().norm())
              for k, p in named.items()}
    steps = np.concatenate(steps)
    return ({"loss": [float(v) for v in steps[:, 0]],
             "rows": [float(v) for v in steps[:, METRIC_NAMES.index("count")]],
             "grad_norm": grad, "update_norm": update}, gen_state)


def run(cell) -> Outcome:
    from meshvae_tpu_torch.train.loop import (Trainer, lr_for_epoch,
                                              set_learning_rate)

    dev = torch.device(cell.device)
    config = program_config(cell)
    t = cell.traffic
    b = int(config["batch_size"])
    n_train, n_valid = int(t["train_meshes"]), int(t["valid_meshes"])
    n_check = int(t["check_steps"])

    # inputs ------------------------------------------------------------
    cell.mark("imports")
    v, f = common.template(cell)
    meshes = common.inputs(cell, v, n_train + n_valid, dev)
    mean, std = data.normalisation(meshes["aligned"][:n_train])
    host = {"x": data.normalise(meshes["aligned"], mean, std).cpu().numpy(),
            **{k: meshes[k].cpu().numpy() for k in ("label", "r", "s", "m")}}
    del meshes
    cell.mark("inputs")

    def batches(lo, hi):
        return [dict({k: host[k][i:i + b] for k in KEYS},
                     mask=np.ones(b, np.float32)) for i in range(lo, hi, b)]

    def lr(epoch):
        return lr_for_epoch(epoch, float(config["learning_rate"]),
                            config["learning_rates"],
                            config["learning_rates_epochs"])

    seed = cell.seed
    gen = torch.Generator(device=dev).manual_seed(data.derive(seed,
                                                              "dropout"))
    gen_state = gen.get_state()
    out = Outcome(end_to_end={}, context={}, numbers={}, attempted=0,
                  failed=0)
    train_rows = [batches(i, i + b)[0] for i in range(0, n_check * b, b)]
    eval_rows = batches(n_train, n_train + b)[0]

    if cell.control is None:
        # the program ------------------------------------------------------
        model, ops, _, _, weights = common.program_model(cell, config, dev)
        trainer = Trainer(model, ops, config, device=dev)
        cell.mark("program")
        _plant(cell.fault, trainer)
        norm = trainer.norm_to_device(mean, std)
        shuffle = torch.Generator(device=dev).manual_seed(
            data.derive(seed, "shuffle"))
        prog_eval = _checked_eval(trainer, eval_rows, norm)
        set_learning_rate(trainer.optimizer, lr(1))
        prog, gen_state = _checked_steps(trainer, model, weights, train_rows,
                                         gen, norm)
        prog["eval"] = prog_eval
        cell.mark("checked steps")
        if not cell.readings_only:
            out = _window(cell, trainer, batches, n_train, n_valid, b, gen,
                          shuffle, norm, lr, set_learning_rate)
        del trainer, model, ops
        common.free(dev)
    else:
        weights = None

    # the reference --------------------------------------------------------
    vae, hier = common.reference(cell, v, f, dev)
    if weights is None:
        specs = ref_model.param_specs(config, hier.levels[-1])
        weights = data.draw_weights(specs, data.derive(seed, "weights"), dev)
    as_dev = lambda a: torch.as_tensor(a, device=dev)
    rows = [(as_dev(r["x"]), as_dev(r["label"])) for r in train_rows]
    ev = [as_dev(eval_rows[k]) for k in KEYS] + [as_dev(mean), as_dev(std)]

    def follow(model_, steps):
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        return ref_model.train_steps(
            model_, weights, rows[:steps], ref_model.generator_draw(g, dev),
            lr(1), float(config["weight_decay"]))

    def check(model_):
        out_ = follow(model_, n_check)
        out_["rows"] = [float(b)] * n_check
        out_["eval"] = ref_model.evaluate(model_, weights, *ev)
        return out_

    ref = check(vae)
    if cell.control is not None:
        control, _ = common.reference(cell, v, f, dev, cell.control, hier)
        prog = check(control)
    at_dtype = None
    if config.get("compute_dtype") == "bfloat16":
        vae_dtype = common.reference(cell, v, f, dev, "bf16", hier)[0]
        at_dtype = follow(vae_dtype, 1)
        # for the calibration's look only: the eval step at bf16
        at_dtype["eval"] = ref_model.evaluate(vae_dtype, weights, *ev)
    out.numbers = judge.train_numbers(prog, ref, at_dtype)
    out.context.update(shape=ModelShape(hier, config),
                       batches=[b], peak=float(cell.config["peak"]
                                               ["flops_per_s"]),
                       device_kind=common.device_kind(dev), readings=prog,
                       reference={k: ref[k] for k in (
                           "loss", "grad_norm", "raw_grad_norm",
                           "update_norm", "eval")},
                       at_dtype=at_dtype and {k: at_dtype[k] for k in (
                           "grad_norm", "eval")})
    shape = out.context["shape"]
    if "epochs" in out.context:
        steps, vsteps = out.context["steps_per_epoch"]
        out.context["flops_window"] = out.context["epochs"] * (
            steps * shape.train_step(b) + vsteps * shape.eval_step(b))
    return out


def _window(cell, trainer, batches, n_train, n_valid, b, gen, shuffle, norm,
            lr, set_learning_rate) -> Outcome:
    dev = trainer.device
    staged_train = trainer.stage_batches(batches(0, n_train))
    staged_valid = trainer.stage_batches(batches(n_train,
                                                 n_train + n_valid))
    steps, vsteps = n_train // b, -(-n_valid // b)
    cell.mark("staged")

    def queue(epoch):
        set_learning_rate(trainer.optimizer, lr(epoch))
        with trace.span("train_epoch"):
            packed = trainer.train_epoch_scanned_async(
                staged_train, gen, *norm, shuffle_generator=shuffle)
        with trace.span("eval_epoch"):
            ev = trainer.evaluate_scanned_async(staged_valid, *norm,
                                                with_errors=False)
        return packed, ev

    def consume(pending) -> int:
        packed, ev = pending
        with trace.span("pull"):
            loss = _host(packed)[:, 0]
            trainer.finalize_train_metrics(packed)
            trainer.finalize_eval_scanned(ev, with_errors=False)
        return int((~np.isfinite(loss)).sum())

    def epochs(first_epoch, stop, done=None):
        """Pipelined epochs from first_epoch until stop(count) is true:
        (epochs, failed steps, host seconds inside the queueing calls);
        `done` gets the clock at which each epoch's metrics arrived."""
        count, failed, host_s, pending = 0, 0, 0.0, None
        while True:
            h = common.clock()
            p = queue(first_epoch + count)
            host_s += common.clock() - h
            if pending is not None:
                failed += consume(pending)
                if done is not None:
                    done.append(common.clock())
            pending, count = p, count + 1
            if stop(count):
                break
        failed += consume(pending)
        if done is not None:
            done.append(common.clock())
        return count, failed, host_s

    # warm-up: one whole epoch captures the step graphs
    epochs(1, lambda n: True)
    common.free(dev)
    cell.mark("warm-up epoch")
    setup_s = common.clock() - cell.t_start

    t0 = common.clock()
    done = [t0]
    n_epochs, failed, host_s = epochs(
        2, lambda n: common.clock() - t0 >= cell.seconds, done)
    window_s = common.clock() - t0
    # the epochs' spacing, for a look at where a slow run loses its time
    gaps = np.diff(done[1:]) * 1e3
    if len(gaps):
        cell.notes.append("epoch ms p10 %.3f p50 %.3f p90 %.3f max %.3f" % (
            *np.percentile(gaps, [10, 50, 90]), gaps.max()))
    out = Outcome(
        end_to_end={"setup_s": setup_s,
                    "train_meshes_per_s": n_epochs * n_train / window_s},
        context={"window_s": window_s, "epochs": n_epochs,
                 "steps_per_epoch": (steps, vsteps),
                 "host_s": host_s, "queued_steps": n_epochs * (steps + vsteps)},
        numbers={}, attempted=n_epochs * steps, failed=failed)
    if cell.trace:
        n_prof = int(cell.traffic["profile_epochs"])
        before = common.launches()
        res = {}
        with trace.profiled(res):
            epochs(2 + n_epochs, lambda n: n >= n_prof)
        win = res["window"]
        out.context.update(trace=win, sub_steps=n_prof * (steps + vsteps),
                           sub_launches=common.launch_delta(
                               before, common.launches()))
        out.busy_s, out.window_s = win.busy_s, win.wall_s
        out.breakdown = {"device_ops": win.top_ops(),
                         "idle_gaps": win.idle_by_host()}
    out.memory_peak_bytes = common.memory_peak(dev)
    return out
