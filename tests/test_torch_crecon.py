"""crecon (meshvae_tpu_torch/train/crecon_driver.py and ``python -m
meshvae_tpu_torch.crecon``) against the JAX package's crecon_driver on the
grid template: estimate_diff in train and eval conditioning on both
cheb_method paths at highest, the 2B decode against two B decodes, one
train step and one eval step (loss, metrics, every GCN gradient, the GCN
after Adam, the frozen VAE untouched, the kernel calls), the scanned
epoch against the per-step loop; run() end to end (5 folds whatever
`folds` says, checkpoints, the test path with and without training), a
JAX-written VAE .msgpack as the frozen VAE, the missing-checkpoint error,
the world entry, and the CLI.

Bars: difference features within 1e-4 of the mesh scale; loss and packed
metrics rtol 1e-5; gradients within 1e-4 of the layer's max|g|; params
after one Adam step within 1e-2 lr. The JAX Pallas kernels run in
interpret mode.

The JAX side and the shared set-up (tests/torch_port_utils.py, which
imports flax) are imported inside fixtures, so the card's test collects
on a machine without flax (as tests/test_torch_scan.py)."""
import copy
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from meshvae_tpu_torch.config import default_config
from meshvae_tpu_torch.crecon import main as crecon_main
from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                    generate_synthetic_dataset, list_meshes)
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, save_obj
from meshvae_tpu_torch.models import (ChebGCN, GCNConfig, MeshVAE, VAEConfig,
                                      build_operators, params_from_flax)
from meshvae_tpu_torch.ops import bsr_spmm
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.train import crecon_driver, driver
from meshvae_tpu_torch.train.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from meshvae_tpu_torch.train.crecon_driver import (CreconTrainer,
                                                   estimate_diff)

from conftest import make_grid_mesh

LR, WD = 1e-3, 5e-4
CONFIG = {"num_classes": 2, "learning_rate": LR, "weight_decay": WD}
BATCH = 4
N_MESHES = 24
TOL = 1e-4  # of the mesh scale
# torch_port_utils' widths: filters, K = 3, hidden 32, latent 6; the
# grid's two finest levels block-sparse
FILTERS, ORDERS, BSR_MIN_N = (8, 8, 8, 16, 16), (3, 3, 3, 3, 3), 128


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules and the shared set-up."""
    import jax
    import jax.numpy as jnp

    import meshvae_tpu.ops.pallas_cheb as pc
    from meshvae_tpu.train import crecon_driver as jax_crecon
    from meshvae_tpu.train.checkpoint import save_checkpoint as jax_save
    from meshvae_tpu.train import loop as jax_loop
    import torch_port_utils as utils

    return types.SimpleNamespace(jax=jax, jnp=jnp, pc=pc, crecon=jax_crecon,
                                 save=jax_save, loop=jax_loop,
                                 make_optimizer=jax_loop.make_optimizer,
                                 utils=utils)


@pytest.fixture
def interpret(ref, monkeypatch):
    monkeypatch.setattr(ref.pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The grid hierarchy (torch_port_utils.grid_hierarchy's), 24
    synthetic meshes with their normalized dataset and a batch of 4 with
    one padded row."""
    mesh = make_grid_mesh(16, jitter=0.05)
    hier = build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2, 2, 2])
    root = tmp_path_factory.mktemp("crecon")
    template = TriMesh(hier.vertices[0], hier.faces[0])
    data_dir = str(root / "data")
    generate_synthetic_dataset(template, data_dir, n_samples=N_MESHES,
                               seed=1)
    cfg = {"root_dir": data_dir, "checkpoint_dir": str(root / "norm")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    batch = next(iter(BatchIterator(ds, BATCH)))
    batch["mask"] = np.array([1, 1, 1, 0], np.float32)
    return hier, root, template, data_dir, batch


@pytest.fixture(scope="module")
def pairs(ref, env):
    """The paired VAE and GCN at highest on the block-sparse path, built
    once; tests take copies of the port models."""
    return (ref.utils.paired_models(env[0], "highest", jit_init=True),
            ref.utils.paired_gcn(env[0], "highest"))


def _port_models(hier, precision="highest"):
    """The seeded port VAE and GCN of the grid, alone."""
    vae = MeshVAE(VAEConfig(num_features=3, filters=FILTERS,
                            polygon_order=ORDERS, n_layers=4, num_hidden=32,
                            latent=6, num_classes=2, dropout=0.2,
                            coarse_verts=hier.levels[-1],
                            precision=precision),
                  generator=torch.Generator().manual_seed(0))
    gcn = ChebGCN(GCNConfig(num_features=6, filters=FILTERS,
                            polygon_order=ORDERS, n_layers=4, num_classes=2,
                            coarse_verts=hier.levels[-1],
                            precision=precision),
                  generator=torch.Generator().manual_seed(1))
    return vae, gcn


def _port_batch(batch, keys=("x", "label", "mask")):
    return {k: torch.from_numpy(np.asarray(batch[k])).to(
        torch.long if k == "label" else torch.float32) for k in keys}


@pytest.mark.parametrize("cheb_method", ["pallas", "dense"])
def test_estimate_diff_matches_jax(ref, interpret, env, pairs, cheb_method):
    """Train mode conditions on the true label, eval mode on the VAE's
    prediction; diff = cat(x - recon_oppo, x - recon), pred and correct
    as the JAX package's."""
    hier, _, _, _, batch = env
    jvae, jops, params, vae, pops = pairs[0]
    if cheb_method == "dense":
        jops, pops = ref.utils.paired_operators(hier, "dense")
        jvae = type(jvae)(dataclasses.replace(jvae.cfg, cheb_method="dense"))
    x, labels = batch["x"], batch["label"]
    scale = np.abs(x).max()
    jnp = ref.jnp
    both = ref.jax.jit(lambda p, xj, lj: [
        ref.crecon.estimate_diff(jvae, p, xj, lj, jops, train)
        for train in (True, False)])(params, jnp.asarray(x),
                                     jnp.asarray(labels))
    for train, want in zip((True, False), both):
        got = estimate_diff(vae, torch.from_numpy(x),
                            torch.from_numpy(labels).long(), pops,
                            train=train)
        assert got[0].shape == (BATCH, hier.levels[0], 6)
        assert not got[0].requires_grad
        delta = np.abs(got[0].numpy() - np.asarray(want[0])).max()
        assert delta <= TOL * scale, (train, delta)
        assert int(got[1]) == int(want[1])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_2b_decode_equals_two_b_decodes(env):
    """One decoder pass over both labels at 2B rows gives what two passes
    at B give, within float32 rounding of the mesh scale."""
    vae, _ = _port_models(env[0])
    pops = build_operators(env[0], "cpu", cheb_method="pallas",
                           bsr_min_n=BSR_MIN_N)
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((BATCH, 6)).astype(np.float32))
    y = torch.eye(2)[torch.tensor([0, 1, 1, 0])]
    with torch.no_grad():
        both = vae.sample(torch.cat([y, 1 - y]), torch.cat([z, z]), pops)
        same, oppo = vae.sample(y, z, pops), vae.sample(1 - y, z, pops)
    scale = both.abs().max()
    assert (both[:BATCH] - same).abs().max() <= 1e-6 * scale
    assert (both[BATCH:] - oppo).abs().max() <= 1e-6 * scale


def _paired_crecon(ref, pairs):
    (jvae, jops, vparams, vae, pops), (jgcn, _, gparams, gcn, _) = pairs
    jgcn = type(jgcn)(dataclasses.replace(jgcn.cfg, input_grad=False))
    jtr = ref.crecon.CreconTrainer(jgcn, jvae, jops, CONFIG)
    ptr = CreconTrainer(copy.deepcopy(gcn), copy.deepcopy(vae), pops, CONFIG,
                        device="cpu")
    return jtr, vparams, gparams, ptr


def _layer_max(named: dict, name: str) -> float:
    layer = name.rsplit(".", 1)[0]
    return max(np.abs(v).max() for k, v in named.items()
               if k.rsplit(".", 1)[0] == layer)


def test_train_and_eval_steps_match_jax(ref, interpret, env, pairs,
                                        monkeypatch):
    """CreconTrainer.train_step against _train_step_impl on the padded
    batch: [loss, correct, count]; Adam's first moment 0.1 (g + wd p),
    i.e. every GCN gradient; the GCN after Adam; the frozen VAE keeps its
    weights and gets no gradient. Kernel calls at K = 3: the VAE's enc_0,
    enc_1 and 2B dec_2, dec_3, the GCN's cheb_0, cheb_1, 2 each forward;
    backward only cheb_1's dx (the diff features are constants). Then
    eval_step against _eval_step_impl."""
    jax, batch = ref.jax, env[4]
    jtr, vparams, gparams, ptr = _paired_crecon(ref, pairs)
    jbatch = {k: ref.jnp.asarray(batch[k]) for k in ("x", "label", "mask")}
    jparams, jopt, jm = jax.jit(jtr._train_step_impl)(
        gparams, jtr.optimizer.init(gparams), vparams, jbatch, jtr.ops)
    vae_before = {k: v.clone() for k, v in ptr.vae.state_dict().items()}

    calls = ref.utils.count_kernel_calls(monkeypatch, cheb=port_cheb)
    got = ptr.train_step(_port_batch(batch)).numpy()
    assert len(calls) == 12 + 2, calls
    np.testing.assert_allclose(got, np.asarray(jm), rtol=1e-5)
    assert got[2] == 3.0
    named_np = lambda tree: {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}
    mu, after = named_np(jopt.inner_state[1].mu), named_np(jparams)
    named = dict(ptr.model.named_parameters())
    assert set(mu) == set(named)
    for name, p in named.items():
        exp_avg = ptr.optimizer.state[p]["exp_avg"].numpy()
        delta = np.abs(exp_avg - mu[name]).max()
        assert delta <= 1e-4 * _layer_max(mu, name), (name, delta)
        delta = np.abs(p.detach().numpy() - after[name]).max()
        assert delta <= 1e-2 * LR, (name, delta)
    for k, v in ptr.vae.state_dict().items():
        torch.testing.assert_close(v, vae_before[k], rtol=0, atol=0)
    assert all(p.grad is None for p in ptr.vae.parameters())

    want = jax.jit(jtr._eval_step_impl)(jparams, vparams, jbatch, jtr.ops)
    got = ptr.eval_step(_port_batch(batch))["scalars"].numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


def test_bf16_diff_and_steps_match_jax(ref, interpret, env, pairs):
    """compute_dtype bfloat16 against the JAX package's bf16 crecon, its
    fp32 result (dense path) the yardstick (torch_port_utils.closer, one
    bf16 ulp as bf16_ulp gives it): estimate_diff in train and eval
    conditioning (float32 features, the mesh scale),
    then one CreconTrainer train step (loss; Adam's first moment, i.e.
    every GCN gradient; the count) and one eval step. Predictions and
    correct counts are held equal where JAX bf16's logits are settled
    (torch_port_utils.settled_rows). Master weights and Adam stay
    float32; the frozen VAE keeps its weights."""
    jax, jnp, utils = ref.jax, ref.jnp, ref.utils
    hold = lambda name, got, j16, j32, scale: utils.closer(
        name, got, j16, j32, scale, utils.bf16_ulp(scale))
    hier, batch = env[0], env[4]
    (jvae, _, vparams, pvae, _), (jgcn, _, gparams, pgcn, _) = pairs
    # the same params in bf16, and the fp32 yardstick on the dense path
    # (within 1e-5 of the block-sparse one, test_estimate_diff_matches_jax),
    # which compiles faster
    bf16 = dict(compute_dtype="bfloat16", precision="default")
    ops16 = utils.paired_operators(hier, "pallas", None,
                                   *utils.DTYPES["bfloat16"])
    vae16 = type(pvae)(dataclasses.replace(pvae.cfg, **bf16))
    vae16.load_state_dict(pvae.state_dict())
    gcn16 = type(pgcn)(dataclasses.replace(pgcn.cfg, **bf16))
    gcn16.load_state_dict(pgcn.state_dict())
    pairs16 = ((type(jvae)(dataclasses.replace(jvae.cfg, **bf16)), ops16[0],
                vparams, vae16.eval(), ops16[1]),
               (type(jgcn)(dataclasses.replace(jgcn.cfg, **bf16)), ops16[0],
                gparams, gcn16, ops16[1]))
    dense = utils.paired_operators(hier, "dense")
    pairs32 = ((type(jvae)(dataclasses.replace(jvae.cfg, cheb_method="dense")),
                *dense[:1], vparams, pvae, dense[1]),
               (type(jgcn)(dataclasses.replace(jgcn.cfg, cheb_method="dense")),
                dense[0], gparams, pgcn, dense[1]))
    jbatch = {k: jnp.asarray(batch[k]) for k in ("x", "label", "mask")}
    x = torch.from_numpy(batch["x"])
    scale = float(np.abs(batch["x"]).max())
    out = {}
    for dtype, pr in (("bfloat16", pairs16), ("float32", pairs32)):
        jtr, vparams, gparams, _ = _paired_crecon(ref, pr)
        jvae, jgcn = jtr.vae, jtr.gcn

        def ref_fn(vp, gp, b, jvae=jvae, jgcn=jgcn, ops=jtr.ops):
            diffs = [ref.crecon.estimate_diff(jvae, vp, b["x"], b["label"],
                                              ops, train)
                     for train in (True, False)]
            h = jvae.apply(vp, b["x"], ops, method=type(jvae).encode)
            vae_logits = jvae.apply(vp, h, method=lambda m, v:
                                    m.classifier_layer(v))
            return diffs, vae_logits, [jgcn.apply(gp, d[0], ops)
                                       for d in diffs]

        diffs, vae_logits, gcn_logits = jax.jit(ref_fn)(vparams, gparams,
                                                        jbatch)
        jparams, jopt, jm = jax.jit(jtr._train_step_impl)(
            gparams, jtr.optimizer.init(gparams), vparams, jbatch, jtr.ops)
        ev = jax.jit(jtr._eval_step_impl)(jparams, vparams, jbatch, jtr.ops)
        mu = {k: v.numpy() for k, v in params_from_flax(
            jax.tree_util.tree_map(np.asarray, jopt.inner_state[1].mu)
            ).items()}
        out[dtype] = (diffs, vae_logits, gcn_logits, jm, ev, mu)
    (d16, vl16, gl16, m16, ev16, mu16) = out["bfloat16"]
    (d32, _, _, m32, ev32, mu32) = out["float32"]
    vae, pops = pairs16[0][3], pairs16[0][4]
    labels = torch.from_numpy(batch["label"]).long()
    vae_rows = utils.settled_rows(vl16)
    print(f"settled VAE rows {vae_rows.sum()} of {len(vae_rows)}")
    for i, train in enumerate((True, False)):
        diff, correct, pred = estimate_diff(vae, x, labels, pops, train)
        assert diff.dtype == torch.float32
        hold(f"diff train={train}", diff, d16[i][0], d32[i][0],
                     scale)
        np.testing.assert_array_equal(pred.numpy()[vae_rows],
                                      np.asarray(d16[i][2])[vae_rows])
        if vae_rows.all():
            assert int(correct) == int(d16[i][1])

    _, _, _, ptr = _paired_crecon(ref, pairs16)
    assert ptr.model.cfg.dtype == torch.bfloat16
    vae_before = {k: v.clone() for k, v in ptr.vae.state_dict().items()}
    got = ptr.train_step(_port_batch(batch)).numpy()
    mask = batch["mask"] > 0
    hold("train loss", got[0], m16[0], m32[0], abs(float(m32[0])))
    assert got[2] == float(m16[2]) == 3.0
    if utils.settled_rows(gl16[0])[mask].all():
        assert got[1] == float(m16[1])
    named = dict(ptr.model.named_parameters())
    assert set(named) == set(mu32)
    for name, p in named.items():
        exp_avg = ptr.optimizer.state[p]["exp_avg"]
        assert p.dtype == exp_avg.dtype == torch.float32
        hold(f"exp_avg {name}", exp_avg, mu16[name], mu32[name],
                     _layer_max(mu32, name))
    for k, v in ptr.vae.state_dict().items():
        torch.testing.assert_close(v, vae_before[k], rtol=0, atol=0)
    got = ptr.eval_step(_port_batch(batch))["scalars"].numpy()
    hold("eval loss", got[0], ev16[0], ev32[0], abs(float(ev32[0])))
    assert got[2] == float(ev16[2])
    if utils.settled_rows(gl16[1])[mask].all() and vae_rows.all():
        assert got[1] == float(ev16[1])


def test_scanned_epoch_equals_the_per_step_loop(env):
    """run_epoch over a staged split (identity order) and over its loader:
    the same averages and the same GCN afterwards; the reference's loss
    average (sum of batch losses / steps) and accuracy."""
    hier, root, template, data_dir, _ = env
    cfg = {"root_dir": data_dir, "checkpoint_dir": str(root / "norm")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index[:10], cfg, labels, template.v, dtype="test")
    ops = build_operators(hier, "cpu", cheb_method="pallas",
                          bsr_min_n=BSR_MIN_N)
    out = []
    for staged in (True, False):
        vae, gcn = _port_models(hier)
        ptr = CreconTrainer(gcn, vae, ops, CONFIG, device="cpu")
        loader = BatchIterator(ds, BATCH)
        if staged:
            loader = ptr.stage_batches(loader)
        train = ptr.run_epoch(loader, True)
        valid = ptr.run_epoch(loader, False)
        out.append((train, valid, ptr.model.state_dict()))
    (t1, v1, s1), (t2, v2, s2) = out
    assert t1 == t2 and v1 == v2
    for k in s1:
        torch.testing.assert_close(s1[k], s2[k], rtol=0, atol=0)
    per_step = np.array([[2.0, 3, 4], [4.0, 1, 4], [9.0, 2, 2]])
    assert CreconTrainer._averages(per_step) == (5.0, 0.6)
    assert ptr.run_epoch(None, False) == (0.0, 0.0)


def _config(env, name, **overrides):
    """A crecon config on the grid template (the paired VAE's widths),
    folds 2 (crecon runs 5 regardless), 2 epochs, batch 4."""
    hier, root, template, data_dir, _ = env
    path = str(root / "template.obj")
    if not os.path.exists(path):
        save_obj(path, template.v, template.f)
    ckpt = str(root / name)
    config = default_config()
    config.update({
        "type": "cheb_GCN", "template": path, "root_dir": data_dir,
        "checkpoint_dir": ckpt, "log_file": os.path.join(ckpt, "log.txt"),
        "folds": 2, "epoch": 2, "batch_size": BATCH,
        "downsampling_factors": [2, 2, 2, 2], "n_layers": 4,
        "num_conv_filters": list(FILTERS), "polygon_order": list(ORDERS),
        "num_hidden": 32, "num_style": 6, "cheb_method": "pallas",
        "hierarchy_cache_dir": str(root / "cache")})
    config.update(overrides)
    return config


@pytest.fixture(scope="module")
def vae_checkpoints(ref, env, pairs):
    """The paired VAE's weights as a port checkpoint (.pt) and as a JAX
    checkpoint (.msgpack, written by the JAX package)."""
    root = env[1]
    _, _, params, vae, _ = pairs[0]
    pt = str(root / "vae" / "checkpoint_1.pt")
    save_checkpoint(pt, vae.state_dict(), {"state": {}, "param_groups": []},
                    1, 0.0, 0.0)
    msgpack = str(root / "vae" / "checkpoint_1.msgpack")
    ref.save(msgpack, params, ref.make_optimizer(LR, WD).init(params), 1,
             0.0, 0.0)
    return pt, msgpack, vae.state_dict()


def test_run_trains_and_tests_five_folds(env, vae_checkpoints):
    """run() on 24 meshes: 5 folds whatever `folds` says, 5 finite test
    results, a checkpoint per fold and the initial GCN weights; the log
    names the scanned epoch; -s alone then tests every fold from its
    checkpoint; the per-step loop (scan_epoch False) runs too."""
    config = _config(env, "run", checkpoint_file=vae_checkpoints[0])
    results = crecon_driver.run(config, do_train=True, do_test=True,
                                device="cpu")
    assert [r["fold"] for r in results] == [1, 2, 3, 4, 5]
    for r in results:
        assert np.isfinite(r["test_loss"]) and 0.0 <= r["test_acc"] <= 1.0
    ckpt = config["checkpoint_dir"]
    for n in range(1, 6):
        state = load_checkpoint(os.path.join(ckpt, f"checkpoint_{n}.pt"))
        assert set(state["model"]) >= {"cheb_0.weight", "cls_layer.bias"}
        assert 1 <= state["epoch_num"] <= 2
    assert os.path.exists(os.path.join(ckpt, "initial_weight_gcn.pt"))
    with open(config["log_file"]) as fp:
        log = fp.read()
    assert "epochs: scanned epoch" in log and "eager steps on cpu" in log
    assert log.count("test acc") == 5

    tested = crecon_driver.run(config, do_train=False, do_test=True,
                               device="cpu")
    assert [r["fold"] for r in tested] == [1, 2, 3, 4, 5]
    eager = crecon_driver.run(_config(env, "eager", scan_epoch=False,
                                      checkpoint_file=vae_checkpoints[0]),
                              do_train=True, do_test=False, device="cpu")
    assert eager == []


def test_run_reads_a_jax_vae_checkpoint(env, vae_checkpoints, monkeypatch):
    """checkpoint_file = a JAX-written .msgpack: the frozen VAE gets its
    weights (equal to the port checkpoint's of the same params)."""
    frozen = {}
    real = CreconTrainer.__init__

    def capture(self, gcn, vae, *args, **kwargs):
        frozen.update(vae.state_dict())
        real(self, gcn, vae, *args, **kwargs)

    monkeypatch.setattr(CreconTrainer, "__init__", capture)
    config = _config(env, "from_jax", checkpoint_file=vae_checkpoints[1],
                     epoch=1)
    results = crecon_driver.run(config, do_train=True, do_test=True,
                                device="cpu")
    assert len(results) == 5
    want = vae_checkpoints[2]
    assert set(frozen) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(frozen[k], v, rtol=0, atol=0)


def test_run_trains_and_tests_in_bf16(env, vae_checkpoints):
    """run() at compute_dtype bfloat16 (the frozen VAE's fp32 checkpoint
    as its master weights), 5 folds x 1 epoch, train and test: finite
    test results, the log naming the compute dtype's precision, fp32 GCN
    checkpoints."""
    config = _config(env, "bf16", checkpoint_file=vae_checkpoints[0],
                     epoch=1, compute_dtype="bfloat16")
    results = crecon_driver.run(config, do_train=True, do_test=True,
                                device="cpu")
    assert [r["fold"] for r in results] == [1, 2, 3, 4, 5]
    for r in results:
        assert np.isfinite(r["test_loss"]) and 0.0 <= r["test_acc"] <= 1.0
    with open(config["log_file"]) as fp:
        assert "matmul precision: default" in fp.read()
    state = load_checkpoint(os.path.join(config["checkpoint_dir"],
                                         "checkpoint_1.pt"))
    assert all(v.dtype == torch.float32 for v in state["model"].values())


def test_test_path_takes_the_last_epoch_and_the_train_norm(
        ref, env, vae_checkpoints, monkeypatch):
    """The caveat both crecon drivers share on purpose (ROADMAP section
    3): under -t -s the test path of each fold evaluates the last
    epoch's in-memory GCN, not the best-validation checkpoint, and its
    test split is normalised with the fold's train-split statistics
    (norm.npz). Each package's run_epoch is wrapped so that the
    validation accuracy falls (1, then 0): the checkpoint keeps epoch 1
    and the last epoch is 2. The per-step loop (scan_epoch False) on the
    dense path, 5 folds x 2 epochs."""
    jax = ref.jax
    np_params = lambda tree: {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}
    seen = {"port": [], "jax": []}

    def forced(i, acc):
        """Calls per fold: train, valid, train, valid, test."""
        return {1: 1.0, 3: 0.0}.get(i % 5, acc)

    port_real = CreconTrainer.run_epoch

    def port_spy(self, loader, train, shuffle_generator=None):
        loss, acc = port_real(self, loader, train, shuffle_generator)
        state = {k: v.numpy().copy()
                 for k, v in self.model.state_dict().items()}
        seen["port"].append((train, loader.ds.mean, state))
        return loss, forced(len(seen["port"]) - 1, acc)

    jax_real = ref.crecon.CreconTrainer.run_epoch

    def jax_spy(self, params, opt_state, vae_params, loader, train,
                shuffle_key=None):
        out = jax_real(self, params, opt_state, vae_params, loader, train,
                       shuffle_key)
        used = out[0] if train else params
        seen["jax"].append((train, loader.ds.mean, np_params(used)))
        return (*out[:3], forced(len(seen["jax"]) - 1, out[3]))

    monkeypatch.setattr(CreconTrainer, "run_epoch", port_spy)
    monkeypatch.setattr(ref.crecon.CreconTrainer, "run_epoch", jax_spy)
    # the JAX driver draws its init targets eagerly, op by op (~20 s on
    # the CPU); under jit they take other values, which this test never
    # compares across packages
    for cls in (ref.loop.Trainer, ref.crecon.CreconTrainer):
        monkeypatch.setattr(
            cls, "init_params", lambda self, key, _init=cls.init_params:
            jax.jit(lambda k: _init(self, k))(key))
    configs = {}
    for side, run, ckpt in (
            ("port", lambda c: crecon_driver.run(c, True, True, "cpu"),
             vae_checkpoints[0]),
            ("jax", lambda c: ref.crecon.run(c, True, True),
             vae_checkpoints[1])):
        configs[side] = _config(env, f"caveat_{side}", checkpoint_file=ckpt,
                                scan_epoch=False, cheb_method="dense")
        assert len(run(configs[side])) == 5
    for side, calls in seen.items():
        assert [c[0] for c in calls] == [True, False, True, False,
                                         False] * 5, side
        for n in range(1, 6):
            (_, norm, epoch1), _, (_, _, epoch2), _, (_, test_norm,
                                                        tested) = \
                calls[5 * n - 5:5 * n]
            ext = ".pt" if side == "port" else ".msgpack"
            ckpt = load_checkpoint(os.path.join(
                configs[side]["checkpoint_dir"], f"checkpoint_{n}{ext}"))
            for k, v in ckpt["model"].items():
                np.testing.assert_array_equal(v.numpy(), epoch1[k])
                np.testing.assert_array_equal(tested[k], epoch2[k])
            assert any(not np.array_equal(epoch1[k], epoch2[k])
                       for k in epoch1), (side, n)
            np.testing.assert_array_equal(test_norm, norm)


def test_missing_checkpoint_and_refusals(env, vae_checkpoints, monkeypatch):
    """No checkpoint_file, or a missing one, raises FileNotFoundError;
    data_parallel 2 and multihost are no longer refused: run() enters the
    world they name (a local world of 2 ranks; this process's rank of a
    multihost world), whose ranks run crecon
    (tests/test_torch_world_classifiers.py)."""
    for ckpt in ("", "/nonexistent/checkpoint_1.pt"):
        with pytest.raises(FileNotFoundError, match="checkpoint_file"):
            crecon_driver.run(_config(env, "missing", checkpoint_file=ckpt),
                              do_train=True, do_test=False, device="cpu")
    seen = []
    monkeypatch.setattr(driver, "spawn_local",
                        lambda fn, dp, sp, device, args:
                        seen.append(("local", dp, sp)) or fn("world", *args))
    monkeypatch.setattr(driver, "maybe_init_multihost",
                        lambda config, device:
                        seen.append("multihost") or "world")
    monkeypatch.setattr(crecon_driver, "_run_rank",
                        lambda world, *args: [world])
    for key, value in (("data_parallel", 2), ("multihost", True)):
        assert crecon_driver.run(
            _config(env, "world", checkpoint_file=vae_checkpoints[0],
                    **{key: value}),
            do_train=True, do_test=False, device="cpu") == ["world"]
    assert seen == [("local", 2, 1), "multihost"]


def test_cli_takes_cpu_for_device_cpu(env, monkeypatch):
    """--cpu is --device cpu (crecon.py's flag); the default stays cuda."""
    seen = []
    monkeypatch.setattr(crecon_driver, "run",
                        lambda config, do_train, do_test, device:
                        seen.append(device))
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "files", "crecon.cfg")
    assert crecon_main(["-c", cfg, "-t", "--cpu"]) == 0
    assert crecon_main(["-c", cfg, "-t"]) == 0
    assert seen == ["cpu", "cuda"]


def test_cli_runs_crecon(env, vae_checkpoints, capsys):
    """python -m meshvae_tpu_torch.crecon -c CFG -t -s --device cpu."""
    hier, root = env[0], env[1]
    config = _config(env, "cli")
    cfg_path = str(root / "crecon_cli.cfg")
    with open(cfg_path, "w") as fp:
        fp.write("[Input Output]\n")
        for key in ("type", "template", "root_dir", "checkpoint_dir"):
            fp.write(f"{key} = {config[key]}\n")
        fp.write("[ChebModel  Parameters]\n"
                 f"checkpoint_file = {vae_checkpoints[0]}\n"
                 "downsampling_factors = 2, 2, 2, 2\n"
                 f"num_conv_filters = {', '.join(map(str, FILTERS))}\n"
                 f"polygon_order = {', '.join(map(str, ORDERS))}\n"
                 "num_hidden = 32\nnum_style = 6\n"
                 "[Learning Parameters]\nbatch_size = 4\nepoch = 1\n")
    assert crecon_main(["-c", cfg_path, "-t", "-s", "--device", "cpu",
                        "-p", "cheb_method", "pallas",
                        "-p", "hierarchy_cache_dir",
                        config["hierarchy_cache_dir"]]) == 0
    out = capsys.readouterr().out
    assert out.count("test acc") == 5
    for n in range(1, 6):
        assert os.path.exists(os.path.join(config["checkpoint_dir"],
                                           f"checkpoint_{n}.pt"))


@pytest.mark.cuda
def test_cuda_train_step_matches_the_cpu(env):
    """One crecon train step on the card (the kernel at the frozen VAE's
    and the GCN's shapes, the 2B decode at C = 2B x 8) against the CPU
    twin from the same weights, both precisions: loss within 1e-5
    relative, every GCN gradient within 1e-4 (highest) / 1e-3 (high) of
    the layer's max|g|; 14 launches (12 forward, cheb_1's dx)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    hier, batch = env[0], env[4]
    vae, gcn = _port_models(hier)
    cpu_ops, dev_ops = (build_operators(hier, d, cheb_method="pallas",
                                        bsr_min_n=BSR_MIN_N)
                        for d in ("cpu", "cuda"))
    for precision, bar in (("highest", 1e-4), ("high", 1e-3)):
        out = {}
        for side, ops in (("cpu", cpu_ops), ("cuda", dev_ops)):
            v = MeshVAE(dataclasses.replace(vae.cfg, precision=precision))
            v.load_state_dict(vae.state_dict())
            g = ChebGCN(dataclasses.replace(gcn.cfg, precision=precision))
            g.load_state_dict(gcn.state_dict())
            tr = CreconTrainer(g, v, ops, CONFIG, device=side)
            bsr_spmm.reset_launches()
            packed = tr.train_step(tr.to_device(batch)).cpu()
            out[side] = (packed, {k: p.grad.cpu() for k, p in
                                  tr.model.named_parameters()},
                         sum(bsr_spmm.launches().values()))
        assert out["cuda"][2] == 14, out["cuda"][2]
        loss = out["cpu"][0][0]
        assert abs(out["cuda"][0][0] - loss) <= 1e-5 * abs(loss)
        grads = out["cpu"][1]
        for name, g in grads.items():
            layer = name.rsplit(".", 1)[0]
            scale = max(v.abs().max() for k, v in grads.items()
                        if k.rsplit(".", 1)[0] == layer)
            assert (out["cuda"][1][name] - g).abs().max() <= bar * scale
