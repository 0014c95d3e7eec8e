"""Driver of the joint training mixes: the joint disentangled VAE + GCN
(``type = joint_VAE``) trained in scanned, graphed, pipelined epochs, as the
port's k-fold driver trains it (meshvae_tpu_torch/train/driver.py
``build_model_and_ops`` -> ``JointMeshVAE``, ``make_trainer`` ->
``JointTrainer``, ``_train_fold`` with ``scan_epoch`` and
``pipeline_epochs`` on).

Everything but the model is train_epochs.py's, whose helpers it calls: the
traffic's parameters, the set-up, the checked steps on a one-batch staged
epoch (the light eval step at the seed's weights, then train steps 1 to
``check_steps``, each a replay of its captured graph), the faults, the
measured window and the traced sub-window. What it supplies:

  * the weights of the joint tree from the seed (reference/joint.py
    ``param_specs``), loaded into the program's model;
  * the reference: reference/joint.py's model on reference/model.py's
    operators, in float32, at the control's precision in the program's
    place, and once rounded to bfloat16 for the first gradient of a
    bfloat16 configuration;
  * the work count of the joint step (workcount_joint.py) at the batch and
    at twice the batch, the rows of the decodes' kernel calls.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import data, judge
from ..harness import Outcome, program_config
from ..reference import mesh as ref_mesh
from ..reference import model as ref_model
from ..reference import joint as ref_joint
from ..workcount_joint import JointShape
from . import common
from .train_epochs import (KEYS, _checked_eval, _checked_steps, _plant,
                           _window)


def _reference(cell, v, f, device, precision: str = "fp32", hier=None):
    """(joint model, hierarchy) of the reference at `precision`, on `hier`
    where one is given, else on the hierarchy it works out from (v, f)."""
    ref_model.exact_fp32()
    program = cell.config["program"]
    if hier is None:
        hier = ref_mesh.hierarchy(v, f, program["downsampling_factors"])
    prec = ref_model.Precision(precision)
    ops = ref_model.Operators(hier, device, prec)
    dtype = (torch.bfloat16 if program.get("compute_dtype") == "bfloat16"
             else torch.float32)
    return ref_joint.JointVAE(program, ops, prec, mask_dtype=dtype), hier


def run(cell) -> Outcome:
    from meshvae_tpu_torch.train.driver import (build_model_and_ops,
                                                make_trainer)
    from meshvae_tpu_torch.train.loop import (lr_for_epoch,
                                              set_learning_rate)

    dev = torch.device(cell.device)
    config = program_config(cell)
    if config.get("type") != "joint_VAE":
        raise ValueError(f"{cell.workload}: the joint driver runs type "
                         f"joint_VAE, not {config.get('type')!r}")
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
        # the program: the k-fold driver's model and trainer ---------------
        model, ops, hier, _ = build_model_and_ops(config, dev)
        specs = ref_joint.param_specs(config, hier.levels[-1])
        weights = data.draw_weights(specs, data.derive(seed, "weights"), dev)
        model.load_state_dict(weights)
        trainer = make_trainer(config, model, ops, device=dev)
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
    joint, hier = _reference(cell, v, f, dev)
    if weights is None:
        specs = ref_joint.param_specs(config, hier.levels[-1])
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
        out_["eval"] = ref_joint.evaluate(model_, weights, *ev)
        return out_

    ref = check(joint)
    if cell.control is not None:
        control, _ = _reference(cell, v, f, dev, cell.control, hier)
        prog = check(control)
    at_dtype = None
    if config.get("compute_dtype") == "bfloat16":
        joint_dtype = _reference(cell, v, f, dev, "bf16", hier)[0]
        at_dtype = follow(joint_dtype, 1)
        # for the calibration's look only: the eval step at bf16
        at_dtype["eval"] = ref_joint.evaluate(joint_dtype, weights, *ev)
    out.numbers = judge.train_numbers(prog, ref, at_dtype)
    out.context.update(shape=JointShape(hier, config), batches=[b, 2 * b],
                       peak=float(cell.config["peak"]["flops_per_s"]),
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
