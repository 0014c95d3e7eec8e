"""The port's joint VAE + GCN (models/joint.py, train/joint.py, built by
train/driver.py as the k-fold driver builds them) against the benchmark's
plain reference of it (meshbench/reference/joint.py), and a tiny joint cell
run through the benchmark's harness, on the CPU.

The size is meshbench/tests/tiny.py's: the 32 x 32 grid (1,024 -> 256 -> 64
-> 16 -> 4 vertices), the published widths, K 3, B 4; weights drawn from a
seed by the benchmark's specs, so the program and the reference share
them. float32 runs at ``matmul_precision = highest`` against the float32
reference; bfloat16 against the reference rounded to bf16 at every product
(``Precision("bf16")``), the precision the configuration computes in.

Tolerances sit between the readings of the program (lower) and those of
the reference one precision below the configuration's (upper: TF32 for
float32, 3-bit fp8 for bfloat16), which each test also reads and requires
to fail. Outputs and loss terms: the largest gap over the value's largest
magnitude. Gradients: each leaf's norm of the difference over the larger
of the reference leaf's norm and the median leaf's, as the benchmark's
check reads them (bf16 rounding moves a small leaf's gradient by a large
share of its own norm, so the elementwise gap reads noise there).
  float32   outputs and loss terms 1e-5 (read: 3.6e-7 worst, the GCN's
            logits; TF32 1.4e-3-1.9e-3), gradients 1e-4 (read: 4.2e-7;
            TF32 0.058), parameters after 3 Adam steps 5e-3 lr elementwise
            (read: 4.7e-4 lr, an entry whose tiny gradient rounds to the
            other sign; TF32 5.8 lr);
  bfloat16  outputs and loss terms 3e-2 (read: 6.6e-3, mu; fp8 0.11-0.13),
            gradients 0.25 (read: 0.117, the GCN's first conv; fp8 0.57),
            the norm of each leaf's change after 3 Adam steps within 0.05
            of the reference's (read: 0.029; fp8 0.082).
The paths of the adversarial reversal and of the GCN's gradient into the
VAE are held in float32, where they are sharp (1.2e-7 and 8.4e-7 against
1e-4); in bfloat16 the GCN's term alone reaches the final decoder conv
0.40 from the bf16-rounded reference, as far as that reference is from
the float32 one (0.20): bf16 noise, held by the whole gradient above.
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from meshbench import data as bench_data  # noqa: E402
from meshbench.harness import make_cell, run_cell  # noqa: E402
from meshbench.judge import judge  # noqa: E402
from meshbench.reference import joint as ref_joint  # noqa: E402
from meshbench.reference import mesh as ref_mesh  # noqa: E402
from meshbench.reference import model as ref_model  # noqa: E402
from meshbench.registry import Registry  # noqa: E402
from meshbench.tests.tiny import grid_obj, make_root  # noqa: E402
from meshvae_tpu_torch.config import default_config  # noqa: E402
from meshvae_tpu_torch.models.joint import joint_loss  # noqa: E402
from meshvae_tpu_torch.models.losses import vae_loss  # noqa: E402
from meshvae_tpu_torch.train import JointTrainer  # noqa: E402
from meshvae_tpu_torch.train.driver import (build_model_and_ops,  # noqa: E402
                                            make_trainer)

K, B = 3, 4
SEED = 2**31 + 3571
LOWER = {"float32": "tf32", "bfloat16": "fp8"}
OWN = {"float32": "fp32", "bfloat16": "bf16"}
TOL = {"float32": {"out": 1e-5, "grad": 1e-4, "adam": 5e-3},
       "bfloat16": {"out": 3e-2, "grad": 0.25, "adam": 0.05}}
OUTPUTS = ("recon", "recon_oppo", "mu", "logvar", "y_hat", "sup_logits",
           "adv_logits", "cls_logits")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores, and these many small products slow down by an order
    of magnitude when every process spins up a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The grid template, the joint80k configuration's program keys, the
    reference's hierarchy of the grid and 2B synthetic meshes from the
    benchmark's generator, normalised."""
    tmp = tmp_path_factory.mktemp("joint_reference")
    path = str(tmp / "grid.obj")
    grid_obj(path)
    with open(os.path.join(ROOT, "meshbench", "configs",
                           "joint80k.json")) as fp:
        program = json.load(fp)["program"]
    v, f = ref_mesh.template(path, 0)
    hier = ref_mesh.hierarchy(v, f, program["downsampling_factors"])
    meshes = bench_data.synthetic_meshes(
        v, 2 * B, bench_data.derive(SEED, "meshes"), "cpu")
    mean, std = bench_data.normalisation(meshes["aligned"])
    x = bench_data.normalise(meshes["aligned"], mean, std).float()
    return {"tmp": tmp, "path": path, "program": program, "hier": hier,
            "x": x, "label": meshes["label"]}


def _program(grid, dtype: str):
    """(config, model, ops, weights) of the port at `dtype`, the weights
    drawn by the benchmark's specs of the joint tree."""
    config = default_config()
    config.update(grid["program"])
    bf16 = dtype == "bfloat16"
    config.update(template=grid["path"], polygon_order=[K] * 5,
                  batch_size=B, compute_dtype=dtype,
                  matmul_precision="default" if bf16 else "highest",
                  hierarchy_cache_dir=str(grid["tmp"] / "cache"))
    model, ops, hier, _ = build_model_and_ops(config, "cpu")
    assert hier.levels == grid["hier"].levels
    weights = bench_data.draw_weights(
        ref_joint.param_specs(config, hier.levels[-1]),
        bench_data.derive(SEED, "weights"), "cpu")
    model.load_state_dict(weights)
    return config, model, ops, weights


def _reference(grid, config, precision: str):
    prec = ref_model.Precision(precision)
    ops = ref_model.Operators(grid["hier"], "cpu", prec)
    mask = (torch.bfloat16 if config["compute_dtype"] == "bfloat16"
            else torch.float32)
    return ref_joint.JointVAE(config, ops, prec, mask_dtype=mask)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap over the reference value's largest magnitude."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's gap as the benchmark's check reads gradients: the norm of
    the difference over the larger of the reference leaf's norm and the
    median leaf's (a leaf whose gradient is nought to rounding is read
    against the median)."""
    norms = {k: float(w.double().norm()) for k, w in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: float((got[k].double() - want[k].double()).norm())
            / max(norms[k], med, 1e-30) for k in want}


def _leaves(weights: dict) -> dict:
    return {k: w.detach().clone().requires_grad_(True)
            for k, w in weights.items()}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_outputs_and_loss_terms_match_the_reference(grid, dtype,
                                                            train):
    """recon, recon_oppo, mu, logvar, y_hat and the three heads' logits,
    and each term of the joint loss (the VAE's, the supervised, the
    adversarial and the GCN's cross entropy) and their sum, in eval mode
    and in train mode with the dropout masks and the noise drawn from the
    same generator state in the same order (the 2B decode's masks in one
    draw each)."""
    config, model, ops, weights = _program(grid, dtype)
    x, label = grid["x"][:B], grid["label"][:B]
    y = F.one_hot(label, 2).float()
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    with torch.no_grad():
        out = model(x, y, ops, train=train, generator=gen)
        loss, aux = joint_loss(x, out, y, label, sup_weight=1.0,
                               adv_weight=0.1, cls_weight=1.0)
        base, _ = vae_loss(x, out["recon"], out["mu"], out["logvar"], y,
                           out["y_hat"])
    got = dict(out, vae=base, sup=aux["sup_loss"], adv=aux["adv_loss"],
               cls=aux["cls_loss"], loss=loss)
    keys = OUTPUTS + ("vae", "sup", "adv", "cls", "loss")
    gaps = {}
    for precision in (OWN[dtype], LOWER[dtype]):
        ref = _reference(grid, config, precision)
        g = torch.Generator()
        g.set_state(state)
        draw = ref_model.generator_draw(g, "cpu") if train else None
        with torch.no_grad():
            want_loss, want = ref.forward(weights, x, label, draw)
            want.update(ref.terms(x, label, want), loss=want_loss)
        gaps[precision] = {k: _gap(got[k], want[k]) for k in keys}
    tol = TOL[dtype]["out"]
    assert max(gaps[OWN[dtype]].values()) < tol, gaps[OWN[dtype]]
    assert max(gaps[LOWER[dtype]].values()) > tol, gaps[LOWER[dtype]]


def _program_grads(trainer, x, label, gen, what: str = "loss") -> dict:
    batch = {"x": x, "label": label, "mask": torch.ones(x.shape[0])}
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, _, aux, _, _ = trainer._forward_loss(batch, True, gen)
    (loss if what == "loss" else aux[what]).backward()
    return {k: (p.grad.clone() if p.grad is not None
                else torch.zeros_like(p))
            for k, p in trainer.model.named_parameters()}


def _reference_grads(ref, weights, x, label, state, what: str = "loss",
                     reverse: bool = True) -> dict:
    p = _leaves(weights)
    g = torch.Generator()
    g.set_state(state)
    loss, out = ref.forward(p, x, label, ref_model.generator_draw(g, "cpu"))
    if what != "loss":
        loss = ref.terms(x, label, out)[what]
    if not reverse:     # the adversarial head without the reversal
        s = ref.split
        logits = ref.vae.dense(out["mu"][:, s:], p, "adv_head")
        loss = -F.log_softmax(logits, -1).gather(1, label[:, None]).mean()
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return {k: (gr if gr is not None else torch.zeros_like(p[k]))
            for k, gr in zip(p, grads)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_gradient_matches_the_reference(grid, dtype):
    """Every leaf's gradient of the joint loss in a train-mode step of the
    k-fold driver's trainer (the same draws), as the benchmark's check
    reads gradients (module docstring)."""
    config, model, ops, weights = _program(grid, dtype)
    trainer = make_trainer(config, model, ops, device="cpu")
    assert isinstance(trainer, JointTrainer)
    x, label = grid["x"][:B], grid["label"][:B]
    gen = torch.Generator().manual_seed(13)
    state = gen.get_state()
    got = _program_grads(trainer, x, label, gen)
    assert set(got) == set(weights)
    gaps = {}
    for precision in (OWN[dtype], LOWER[dtype]):
        want = _reference_grads(_reference(grid, config, precision), weights,
                                x, label, state)
        gaps[precision] = _leaf_gaps(got, want)
    tol = TOL[dtype]["grad"]
    assert max(gaps[OWN[dtype]].values()) < tol, gaps[OWN[dtype]]
    assert max(gaps[LOWER[dtype]].values()) > tol, gaps[LOWER[dtype]]


def test_the_reversal_and_the_gcn_path_reach_the_vae(grid):
    """float32: the adversarial term's gradient reaches the posterior
    reversed (the reference's z_mean gradient the negative of the
    unreversed head's, the program's equal to the reversed one); the GCN's
    term alone reaches the decoder and the encoder through the 2B decode
    (nonzero there, and the program's equal to the reference's)."""
    config, model, ops, weights = _program(grid, "float32")
    trainer = make_trainer(config, model, ops, device="cpu")
    x, label = grid["x"][:B], grid["label"][:B]
    state = torch.Generator().manual_seed(13).get_state()
    tol = TOL["float32"]["grad"]
    ref = _reference(grid, config, "fp32")
    zm = "vae.z_mean.weight"
    adv = _reference_grads(ref, weights, x, label, state, "adv")
    plain = _reference_grads(ref, weights, x, label, state, "adv",
                             reverse=False)
    assert float(adv[zm].abs().max()) > 0
    torch.testing.assert_close(adv[zm], -plain[zm], rtol=1e-6, atol=1e-12)
    g = torch.Generator().manual_seed(13)
    got_adv = _program_grads(trainer, x, label, g, "adv_loss")
    assert _leaf_gaps(got_adv, adv)[zm] < tol
    cls = _reference_grads(ref, weights, x, label, state, "cls")
    g = torch.Generator().manual_seed(13)
    cls_gaps = _leaf_gaps(_program_grads(trainer, x, label, g, "cls_loss"),
                          cls)
    for leaf in ("vae.cheb_dec_0.weight", "vae.cheb_dec_4.weight",
                 "vae.dec_lin.weight", "vae.cheb_enc_0.weight"):
        assert float(cls[leaf].abs().max()) > 0, leaf
        assert cls_gaps[leaf] < tol, (leaf, cls_gaps[leaf])


def _reference_adam(ref, weights, batches, state, lr, wd,
                    betas=(0.9, 0.999), eps=1e-8) -> dict:
    """The parameters after one Adam step with L2 per batch, as
    reference/model.py's train_steps takes them."""
    p = _leaves(weights)
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    g = torch.Generator()
    g.set_state(state)
    draw = ref_model.generator_draw(g, "cpu")
    for t, (x, label) in enumerate(batches, start=1):
        grads = torch.autograd.grad(ref.loss(p, x, label, draw),
                                    list(p.values()))
        with torch.no_grad():
            for (k, w), gr in zip(p.items(), grads):
                gr = gr + wd * w
                m[k].mul_(betas[0]).add_(gr, alpha=1 - betas[0])
                v[k].mul_(betas[1]).addcmul_(gr, gr, value=1 - betas[1])
                w.sub_(lr * (m[k] / (1 - betas[0] ** t))
                       / ((v[k] / (1 - betas[1] ** t)).sqrt() + eps))
    return {k: w.detach() for k, w in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameters_after_three_adam_steps_match_the_reference(grid, dtype):
    """Three JointTrainer.train_step updates (dropout on, one generator)
    against three Adam steps with L2 of the reference on the same draws:
    float32 every parameter within 1e-3 lr, bfloat16 the norm of each
    leaf's change within 0.3 of the reference's."""
    config, model, ops, weights = _program(grid, dtype)
    trainer = make_trainer(config, model, ops, device="cpu")
    lr, wd = float(config["learning_rate"]), float(config["weight_decay"])
    batches = [(grid["x"][i:i + B], grid["label"][i:i + B])
               for i in (0, B // 2, B)]
    gen = torch.Generator().manual_seed(17)
    state = gen.get_state()
    norm = trainer.norm_to_device(np.zeros((grid["x"].shape[1], 3)),
                                  np.ones((grid["x"].shape[1], 3)))
    eye = torch.eye(3).expand(B, 3, 3)
    for x, label in batches:
        trainer.train_step({"x": x, "label": label, "mask": torch.ones(B),
                            "r": eye, "s": torch.ones(B),
                            "m": torch.zeros(B, 1, 3)}, gen, *norm)
    got = {k: p.detach() for k, p in model.named_parameters()}
    gaps = {}
    for precision in (OWN[dtype], LOWER[dtype]):
        want = _reference_adam(_reference(grid, config, precision), weights,
                               batches, state, lr, wd)
        if dtype == "float32":
            gaps[precision] = max(float((got[k] - want[k]).abs().max()) / lr
                                  for k in want)
        else:
            gaps[precision] = max(
                abs(float((got[k] - weights[k]).norm())
                    - float((want[k] - weights[k]).norm()))
                / float((want[k] - weights[k]).norm()) for k in want)
    tol = TOL[dtype]["adam"]
    assert gaps[OWN[dtype]] < tol, gaps
    assert gaps[LOWER[dtype]] > tol, gaps


# --- the tiny joint cell through the harness --------------------------------

# the tiny joint cell's limits, set from CPU readings over eight seeds of
# the program (sound), the test's seed among them, and three of the
# control and two of each fault, as tiny.py's. float32 (matmul_precision high): sound loss 0-8e-8, grad
# 6.7e-6-2e-5, update 1e-6-4.5e-4, eval loss and eval error 0; TF32's
# 8e-8-2.4e-7, 3.1e-3-0.028, 3.6e-3-0.011, 0-7.9e-8, 4.5e-7-1.3e-6.
# bfloat16: sound loss 3.2e-7-2.2e-6, grad 0.012-0.149 (the test's seed
# 0.149; its limit is set by the faults' 0.39-0.72), update 0.012-0.074,
# grad against the bf16 reference 0.01-0.037 (median leaf 0.0011-0.0039),
# eval loss 0-1.4e-6, eval error 2.3e-7-9.9e-6; fp8's 5.4e-6-2.2e-5,
# 0.16-0.23, 0.04-0.056 (inside the sound range: update_gap's limit is set
# by the frozen state's 1), 0.16-0.21 (0.024-0.037), 2.7e-6-1.8e-5,
# 2.6e-5-1.6e-4. Half a batch or its first half read twice: loss
# 2.8e-3-6.6e-3, frozen state 7.5e-5-1.1e-4; every step counts its
# batch's rows
JOINT_LIMITS = {
    "float32": {"loss_gap": 1e-6, "grad_gap": 3e-4, "update_gap": 2e-3,
                "rows_gap": 0, "eval_loss_gap": 1e-6,
                "eval_error_gap": 3e-7, "eval_rows_gap": 0},
    "bfloat16": {"loss_gap": 4e-6, "grad_gap": 0.3, "update_gap": 0.2,
                 "rows_gap": 0, "grad_gap_dtype": 0.1,
                 "grad_gap_dtype_median": 0.012, "eval_loss_gap": 4e-6,
                 "eval_error_gap": 2e-5, "eval_rows_gap": 0}}


def make_joint_root(tmp: str, dtype: str) -> str:
    """tiny.py's root with the joint configuration ``jgrid`` (joint80k's
    program on the grid, K 3, B 4) and its cell ``jgrid.train`` on the
    joint traffic mix, listed by every metric that lists joint80k.train."""
    root = make_root(tmp, dtype)
    pkg = os.path.join(root, "meshbench")

    def load(*parts):
        with open(os.path.join(pkg, *parts)) as fp:
            return json.load(fp)

    def save(obj, *parts):
        with open(os.path.join(pkg, *parts), "w") as fp:
            json.dump(obj, fp)

    grid = load("configs", "grid.json")
    cfg = load("configs", "joint80k.json")
    cfg.update(name="jgrid", mesh=grid["mesh"], peak=grid["peak"])
    for k in ("template", "polygon_order", "batch_size", "compute_dtype",
              "matmul_precision"):
        cfg["program"][k] = grid["program"][k]
    save(cfg, "configs", "jgrid.json")
    save(dict(load("traffic", "train_joint.json"), train_meshes=16,
              valid_meshes=8, profile_epochs=1), "traffic", "jgrid_train.json")
    save(JOINT_LIMITS[dtype], "limits", "jgrid.train.json")
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    bench["configs"].append({"name": "jgrid", "source": "test",
                             "file": "meshbench/configs/jgrid.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "jgrid.train", "config": "jgrid",
                               "traffic": "jgrid_train", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "joint80k.train" in m.get("workloads", []):
            m["workloads"].append("jgrid.train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)
    return root


@pytest.fixture(scope="module")
def joint_roots(tmp_path_factory):
    return {d: make_joint_root(str(tmp_path_factory.mktemp(d)), d)
            for d in ("float32", "bfloat16")}


@pytest.mark.parametrize("planted", [None, "control", "frozen_state",
                                     "half_batch", "duplicate_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_joint_cell_is_correct_and_what_is_planted_is_not(
        joint_roots, dtype, planted):
    """The joint cell through the harness as the benchmark's command runs
    it (CPU, a short window): correct, with the joint's rate (under the
    80k cells' rate metric, which lists the cell) and a setup time. The control (the reference one precision below in the program's
    place) and each planted fault, in the checked steps without the
    window (as meshbench.calibrate reads them), fail at least one
    number."""
    reg = Registry(joint_roots[dtype])
    if planted is None:
        cell = make_cell(reg, "jgrid.train", SEED, 0.3, False, "cpu",
                         time.perf_counter())
        result, _ = run_cell(reg, cell)
        assert result["correct"], result["checks"]
        assert set(result["metrics"]) == {"setup_s",
                                          "train_meshes_per_s.vae80k"}
        assert result["attempted"] > 0 and result["failed"] == 0
        return
    kw = ({"control": LOWER[dtype]} if planted == "control"
          else {"fault": planted})
    cell = make_cell(reg, "jgrid.train", SEED, 0.0, False, "cpu",
                     time.perf_counter(), readings_only=True, **kw)
    out = reg.driver(cell.traffic["driver"]).run(cell)
    correct, checks = judge(out.numbers, cell.limits)
    assert not correct, checks
    if planted == "duplicate_rows":
        assert checks["rows_gap"]["value"] == 0
