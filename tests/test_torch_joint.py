"""The joint VAE + GCN (meshvae_tpu_torch/models/joint.py and
train/joint.py, BASELINE config 3) against the JAX package's on the grid
template: grad_reverse; the eval forward on both cheb_method paths at
highest; joint_loss; one train step with the same dropout masks and noise
fed to both (loss, metrics, every gradient through Adam's first moment,
the params after Adam, the kernel calls) and one eval step with the extra
scalars; a JAX joint checkpoint loaded and one more step from it; the
driver's run() and CLI with type = joint_VAE (sup_accuracy and
adv_accuracy in the history); the latent_split check and the world
entry.

Bars (ROADMAP ground rules): recon within 1e-4, the other outputs 1e-5;
loss and metrics rtol 1e-5 (pose error 1e-4); gradients and moments within
1e-4 of the layer's max (nu 2e-4); params after Adam within 1e-2 lr. The
JAX Pallas kernels run in interpret mode.

The JAX side and the shared set-up (tests/torch_port_utils.py, which
imports flax) are imported inside fixtures, so the card's test collects
on a machine without flax (as tests/test_torch_scan.py)."""
import copy
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from meshvae_tpu_torch.config import default_config
from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                    generate_synthetic_dataset, list_meshes)
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, save_obj
from meshvae_tpu_torch.models import (GCNConfig, JointMeshVAE, VAEConfig,
                                      build_operators, grad_reverse,
                                      joint_loss, params_from_flax)
from meshvae_tpu_torch.models.vae import parameter_order
from meshvae_tpu_torch.ops import bsr_spmm
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops import graph as port_graph
from meshvae_tpu_torch.ops import pool as port_pool
from meshvae_tpu_torch.ops import pool_transpose
from meshvae_tpu_torch.train import JointTrainer, driver
from meshvae_tpu_torch.train.__main__ import main as train_main
from meshvae_tpu_torch.train.checkpoint import load_checkpoint
from meshvae_tpu_torch.train.driver import _restart

from conftest import make_grid_mesh

# torch_port_utils' widths: filters, K = 3, hidden 32, latent 6, split 2;
# the grid's two finest levels block-sparse
FILTERS, ORDERS, BSR_MIN_N, SPLIT = (8, 8, 8, 16, 16), (3,) * 5, 128, 2
LR, WD = 1e-3, 5e-4
CONFIG = {"num_classes": 2, "learning_rate": LR, "weight_decay": WD,
          "sup_weight": 1.0, "adv_weight": 0.1, "cls_weight": 1.0}
BATCH = 8      # 2B x F = 128 at F = 8: the pool backward takes P^T's kernel
TGRAD = 6      # grid up-pool fan-ins 9/7/7/5: three block-sparse P^T
KEYS = ("x", "label", "r", "s", "m", "mask")
ULP = 2.0 ** -8  # one bf16 ulp of max|y|


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules and the shared set-up."""
    import jax
    import jax.numpy as jnp

    import meshvae_tpu.ops.pallas_cheb as pc
    from meshvae_tpu.models import joint as jax_joint
    from meshvae_tpu.train.checkpoint import save_checkpoint as jax_save
    from meshvae_tpu.train.joint import JointTrainer as JaxJointTrainer
    import torch_port_utils as utils

    return types.SimpleNamespace(jax=jax, jnp=jnp, pc=pc, joint=jax_joint,
                                 save=jax_save, Trainer=JaxJointTrainer,
                                 utils=utils)


@pytest.fixture
def interpret(ref, monkeypatch):
    monkeypatch.setattr(ref.pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The grid hierarchy (torch_port_utils.grid_hierarchy's), 24
    synthetic meshes, their dataset, a batch of 8 with one padded row and
    its normalisation."""
    mesh = make_grid_mesh(16, jitter=0.05)
    hier = build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2, 2, 2])
    root = tmp_path_factory.mktemp("joint")
    template = TriMesh(hier.vertices[0], hier.faces[0])
    data_dir = str(root / "data")
    generate_synthetic_dataset(template, data_dir, n_samples=24, seed=1)
    cfg = {"root_dir": data_dir, "checkpoint_dir": str(root / "norm")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    batch = next(iter(BatchIterator(ds, BATCH)))
    batch["mask"][-1] = 0.0
    return hier, root, template, data_dir, batch, (ds.mean, ds.std)


@pytest.fixture(scope="module")
def pair(ref, env):
    """The paired joint model at highest, block-sparse, with block-sparse
    P^T for up-pools 0-2 (built once; tests copy the port model)."""
    out = ref.utils.paired_joint(env[0], "highest", tgrad_ell_max=TGRAD)
    assert [p.t_bsr is not None for p in out[4].up] == [True] * 3 + [False]
    return out


def _port_model(hier, precision="highest"):
    """The seeded port joint model of the grid, alone."""
    vae = VAEConfig(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                    n_layers=4, num_hidden=32, latent=6, num_classes=2,
                    dropout=0.2, coarse_verts=hier.levels[-1],
                    precision=precision)
    gcn = GCNConfig(num_features=6, filters=FILTERS, polygon_order=ORDERS,
                    n_layers=4, num_classes=2, coarse_verts=hier.levels[-1],
                    precision=precision)
    return JointMeshVAE(vae, gcn, SPLIT,
                        generator=torch.Generator().manual_seed(0))


def _port_ops(hier, device):
    """The grid's operators with block-sparse P^T for up-pools 0-2."""
    old = port_graph.TGRAD_ELL_MAX
    port_graph.TGRAD_ELL_MAX = TGRAD
    try:
        return build_operators(hier, device, cheb_method="pallas",
                               bsr_min_n=BSR_MIN_N)
    finally:
        port_graph.TGRAD_ELL_MAX = old


def test_grad_reverse_negates_the_gradient(ref):
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(3, 4)
    y = grad_reverse(x)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    (y * w).sum().backward()
    torch.testing.assert_close(x.grad, -w, rtol=0, atol=0)
    jnp = ref.jnp
    want = ref.jax.grad(lambda a: jnp.sum(ref.joint.grad_reverse(a)
                                          * jnp.asarray(w.numpy())))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("cheb_method", ["pallas", "dense"])
def test_eval_forward_matches_jax(ref, interpret, env, pair, cheb_method):
    """recon and recon_oppo within 1e-4; mu, logvar, y_hat, z and the
    three heads' logits within 1e-5."""
    hier, batch = env[0], env[4]
    if cheb_method == "pallas":
        jmodel, jops, params, pmodel, pops = pair
    else:
        jmodel, jops, params, pmodel, pops = ref.utils.paired_joint(
            hier, "highest", "dense")
    x, y = batch["x"], np.eye(2, dtype=np.float32)[batch["label"]]
    jnp = ref.jnp
    want = ref.jax.jit(lambda p: jmodel.apply(
        p, jnp.asarray(x), jnp.asarray(y), jops, train=False))(params)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), torch.from_numpy(y), pops)
    assert set(got) == set(want)
    for key in ("mu", "logvar", "y_hat", "z", "sup_logits", "adv_logits",
                "cls_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("recon", "recon_oppo"):
        delta = np.abs(got[key].numpy() - np.asarray(want[key])).max()
        assert delta < 1e-4, (key, delta)


def test_joint_loss_matches_jax(ref):
    """The total objective and every term of aux on masked random outputs,
    rtol 1e-5; correct = the GCN's count, vae_correct the VAE head's."""
    rng = np.random.default_rng(0)
    b, n = 6, 30
    out = {"recon": rng.standard_normal((b, n, 3)),
           "mu": 0.5 * rng.standard_normal((b, 6)),
           "logvar": 0.5 * rng.standard_normal((b, 6)),
           "sup_logits": rng.standard_normal((b, 2)),
           "adv_logits": rng.standard_normal((b, 2)),
           "cls_logits": rng.standard_normal((b, 2))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    logits = rng.standard_normal((b, 2)).astype(np.float32)
    out["y_hat"] = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    labels = rng.integers(0, 2, b)
    y = np.eye(2, dtype=np.float32)[labels]
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)
    weights = dict(sup_weight=0.7, adv_weight=0.2, cls_weight=1.3)
    t = torch.from_numpy
    loss, aux = joint_loss(t(x), {k: t(v) for k, v in out.items()}, t(y),
                           t(labels), mask=t(mask), **weights)
    jnp = ref.jnp
    jloss, jaux = ref.joint.joint_loss(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in out.items()},
        jnp.asarray(y), jnp.asarray(labels), mask=jnp.asarray(mask),
        **weights)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("sup_loss", "adv_loss", "cls_loss", "sup_correct",
              "adv_correct", "correct", "vae_correct", "kld", "rec_loss"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_steps(ref, env, pair, tmp_path_factory):
    """Two JAX train steps from the paired params with the same fed masks
    and noise (one trace), a checkpoint after the first, and the eval step
    of the params after it."""
    jax, jnp = ref.jax, ref.jnp
    jmodel, jops, params, pmodel, _ = pair
    batch, (mean, std) = env[4], env[5]
    c = pmodel.cfg
    noise = ref.utils.FedNoise(BATCH, c.num_hidden,
                               c.coarse_verts * c.filters[-1], c.latent,
                               decode_rows=2)
    jtr = ref.Trainer(jmodel, jops, CONFIG)
    jbatch = {k: jnp.asarray(batch[k]) for k in KEYS}
    args = (jbatch, jax.random.key(0), jnp.asarray(mean), jnp.asarray(std),
            jops)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref.pc, "INTERPRET", True)  # module scope: set here
        ref.utils.feed_noise(mp, noise)
        step = jax.jit(jtr._train_step_impl)
        p1, o1, m1 = step(params, jtr.init_opt_state(params), *args)
        p2, o2, _ = step(p1, o1, *args)
        ev = jax.jit(jtr._eval_step_impl)(p1, jbatch, jnp.asarray(mean),
                                          jnp.asarray(std), jops)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "checkpoint_1.msgpack")
    ref.save(path, p1, o1, 1, float(m1[0]), 0.0)
    return noise, (p1, o1, m1), (p2, o2), path, ev


def _named(tree) -> dict:
    """A flax tree (numpy-convertible leaves) as the port's names."""
    as_numpy = lambda t: ({k: as_numpy(v) for k, v in t.items()}
                          if isinstance(t, dict) else np.asarray(t))
    return {k: v.numpy() for k, v in params_from_flax(as_numpy(tree)).items()}


def _layer_max(named: dict, name: str) -> float:
    layer = name.rsplit(".", 1)[0]
    return max(np.abs(v).max() for k, v in named.items()
               if k.rsplit(".", 1)[0] == layer)


def _hold_step(trainer, params, opt_state, steps):
    """Adam's moments (so the gradients) and the params after `steps`
    against the JAX package's."""
    adam = opt_state.inner_state[1]
    mu, nu, after = _named(adam.mu), _named(adam.nu), _named(params)
    named = dict(trainer.model.named_parameters())
    assert set(mu) == set(named)
    for name, p in named.items():
        st = trainer.optimizer.state[p]
        assert int(st["step"]) == steps
        for got, ref, bar in ((st["exp_avg"], mu, 1e-4),
                              (st["exp_avg_sq"], nu, 2e-4)):
            delta = np.abs(got.numpy() - ref[name]).max()
            assert delta <= bar * _layer_max(ref, name), (name, delta)
        delta = np.abs(p.detach().numpy() - after[name]).max()
        assert delta <= 1e-2 * LR, (name, delta)


def test_train_and_eval_steps_match_jax(ref, env, pair, jax_steps,
                                        monkeypatch):
    """JointTrainer.train_step against _train_step_impl at dropout 0.2 with
    the same masks (the decoder's drawn per row of its 2B pass) and noise:
    the packed metrics, Adam's moments, the params. Kernel calls at K = 3:
    the six block-sparse convs (enc_0, enc_1, 2B dec_2, dec_3, cheb_0,
    cheb_1) twice each forward, all but enc_0 twice backward, and the
    three P^T at 2B width. Then eval_step's scalars (with sup and adv
    correct counts) against _eval_step_impl."""
    batch, (mean, std) = env[4], env[5]
    noise, (p1, o1, m1), _, _, ev = jax_steps
    trainer = JointTrainer(copy.deepcopy(pair[3]), pair[4], CONFIG,
                           device="cpu")
    ref.utils.feed_noise(monkeypatch, noise)
    noise.i = 0
    calls = ref.utils.count_kernel_calls(monkeypatch, cheb=port_cheb,
                                         pool=port_pool)
    norm = trainer.norm_to_device(mean, std)
    got = trainer.train_step(trainer.to_device(batch), torch.Generator(),
                             *norm).numpy()
    assert noise.i == 4
    names = [name for name, _ in calls]
    assert names.count("cheb") == 12 + 10 and names.count("pool") == 3
    want = np.asarray(m1)
    np.testing.assert_allclose(got[[0, 1, 2, 4, 5]], want[[0, 1, 2, 4, 5]],
                               rtol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4)
    _hold_step(trainer, p1, o1, 1)

    out = trainer.eval_step(trainer.to_device(batch), *norm)
    sc, ref = out["scalars"].numpy(), np.asarray(ev["scalars"])
    assert sc.shape == ref.shape == (9,)
    np.testing.assert_allclose(sc[:6], ref[:6], rtol=1e-5)
    np.testing.assert_allclose(sc[6], ref[6], rtol=1e-4)
    np.testing.assert_allclose(sc[7:], ref[7:], rtol=1e-5)


def test_bf16_forward_and_train_step_match_jax(ref, interpret, env,
                                              monkeypatch):
    """compute_dtype bfloat16 (bf16 operators; the VAE, the GCN and the
    four heads by the Dense rule) against the JAX package's bf16 joint
    model, its fp32 result (dense path) the yardstick
    (torch_port_utils.closer, one bf16 ulp as bf16_ulp gives it): the
    eval forward, every output key, and one deterministic train step (no dropout, z = mu): the loss and every
    gradient (scale: the layer's max|g|). Master weights and Adam stay
    float32; every kernel call runs mode bf16 (22 Laplacian, 3 P^T at 2B
    width). The P^T of the three block-sparse up-pools, the twin against
    the JAX kernel in bf16 at C = 2B x 16, within (G + 1) bf16 ulps (the
    TPU kernels' per-block rounding, ROADMAP section 3)."""
    jax, jnp, utils = ref.jax, ref.jnp, ref.utils
    hold = lambda name, got, j16, j32, scale: utils.closer(
        name, got, j16, j32, scale, utils.bf16_ulp(scale))
    hier, batch, (mean, std) = env[0], env[4], env[5]
    x, y = batch["x"], np.eye(2, dtype=np.float32)[batch["label"]]
    jbatch = {k: jnp.asarray(batch[k]) for k in KEYS}
    jmodel, jops16, params, pmodel, pops = utils.paired_joint(
        hier, "default", dropout=0.0, tgrad_ell_max=TGRAD,
        compute_dtype="bfloat16")
    # the fp32 yardstick: the same params on the dense path, which
    # compiles faster (within 1e-4 of the block-sparse one,
    # test_eval_forward_matches_jax)
    fp32 = dict(cheb_method="dense", compute_dtype="float32",
                precision="highest")
    jmodel32 = type(jmodel)(dataclasses.replace(jmodel.cfg, **fp32),
                            dataclasses.replace(jmodel.gcn_cfg, **fp32),
                            jmodel.split)
    out = {}
    for dtype, jmodel, jops in (
            ("bfloat16", jmodel, jops16),
            ("float32", jmodel32, utils.paired_operators(hier, "dense")[0])):
        jtr = ref.Trainer(jmodel, jops, CONFIG)
        (loss, (fwd, _, _)), g = jax.jit(jax.value_and_grad(
            lambda p: jtr._forward_loss(p, jbatch, None, False, jops),
            has_aux=True))(params)
        out[dtype] = (float(loss), fwd, _named(g))
    assert [p.t_bsr is not None for p in pops.up] == [True] * 3 + [False]
    (l16, f16, g16), (l32, f32, g32) = out["bfloat16"], out["float32"]
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), torch.from_numpy(y), pops)
    assert set(got) == set(f16)
    for key, v in got.items():
        assert v.dtype == torch.float32, key
        hold(f"eval {key}", v, f16[key], f32[key],
                     np.abs(np.asarray(f32[key])).max())

    trainer = JointTrainer(pmodel, pops, CONFIG, device="cpu")
    calls = ref.utils.count_kernel_calls(monkeypatch, cheb=port_cheb,
                                         pool=port_pool)
    packed = trainer.train_step(trainer.to_device(batch), None,
                                *trainer.norm_to_device(mean, std))
    names = [name for name, _ in calls]
    assert names.count("cheb") == 22 and names.count("pool") == 3
    assert {m for _, m in calls} == {"bf16"}, calls
    hold("loss", np.float32(packed[0]), np.float32(l16),
                 np.float32(l32), abs(l32))
    named = dict(trainer.model.named_parameters())
    assert set(named) == set(g32)
    for name, p in named.items():
        assert p.dtype == p.grad.dtype == torch.float32
        assert trainer.optimizer.state[p]["exp_avg"].dtype == torch.float32
        hold(f"grad {name}", p.grad, g16[name], g32[name],
                     _layer_max(g32, name))

    rng = np.random.default_rng(5)
    for i in range(3):
        pb, jb = pops.up[i].t_bsr, jops16.up[i].t_bsr
        xs = rng.standard_normal((pb.n_pad_cols, 2 * BATCH * 16))
        xs = xs.astype(np.float32)
        got = bsr_spmm.bsr_grouped_spmm_reference(
            pb, torch.from_numpy(xs).to(torch.bfloat16), "bf16", 1.0)
        want = ref.pc._bsr_matmul_impl(
            jb, jnp.asarray(xs).astype(jnp.bfloat16),
            jax.lax.Precision.DEFAULT)
        want = np.asarray(want, np.float32)
        delta = np.abs(got.float().numpy() - want).max()
        bar = (pb.g_width + 1) * ULP * np.abs(want).max()
        print(f"up-pool {i} P^T bf16: {delta / bar * (pb.g_width + 1):.2f}"
              f" ulps (bar G + 1 = {pb.g_width + 1})")
        assert got.dtype == torch.bfloat16 and delta <= bar, (i, delta)


def test_jax_joint_checkpoint_resumes_in_the_port(ref, env, pair, jax_steps,
                                                  monkeypatch):
    """The JAX checkpoint after one step loads into JointMeshVAE (nested
    vae/gcn names, Adam state in the module's parameter order) and one
    more port step from it equals the JAX package's second step."""
    batch, (mean, std) = env[4], env[5]
    noise, _, (p2, o2), path, _ = jax_steps
    state = load_checkpoint(path)
    model = copy.deepcopy(pair[3])
    order = [n for n, _ in model.named_parameters()]
    assert order[0].startswith("vae.cheb_enc_0") and order[-1] == (
        "adv_head.bias")
    assert parameter_order(sorted(state["model"])) == order
    trainer = JointTrainer(model, pair[4], CONFIG, device="cpu")
    _restart(trainer, state["model"], state["optimizer"])
    ref.utils.feed_noise(monkeypatch, noise)
    noise.i = 0
    trainer.train_step(trainer.to_device(batch), torch.Generator(),
                       *trainer.norm_to_device(mean, std))
    _hold_step(trainer, p2, o2, 2)


def test_latent_split_must_leave_both_slices(env):
    model = _port_model(env[0])
    for split in (0, model.cfg.latent):
        with pytest.raises(ValueError, match="latent_split"):
            JointMeshVAE(model.cfg, model.gcn_cfg, split)
    fresh = model.fresh(torch.Generator().manual_seed(1))
    assert type(fresh) is JointMeshVAE and fresh.split == SPLIT
    assert not torch.equal(fresh.sup_head.weight, model.sup_head.weight)


def _joint_config(env, name, **overrides):
    hier, root, template, data_dir = env[:4]
    path = str(root / "template.obj")
    if not os.path.exists(path):
        save_obj(path, template.v, template.f)
    ckpt = str(root / name)
    config = default_config()
    config.update({
        "type": "joint_VAE", "template": path, "root_dir": data_dir,
        "checkpoint_dir": ckpt, "log_file": os.path.join(ckpt, "log.txt"),
        "folds": 2, "epoch": 2, "batch_size": BATCH, "test_size": 0.25,
        "downsampling_factors": [2, 2, 2, 2], "n_layers": 4,
        "num_conv_filters": list(FILTERS), "polygon_order": list(ORDERS),
        "num_hidden": 32, "num_style": 6, "latent_split": SPLIT,
        "cheb_method": "pallas", "hierarchy_cache_dir": str(root / "cache")})
    config.update(overrides)
    return config


def test_driver_runs_the_joint_model(env):
    """run() with type = joint_VAE: a JointTrainer, 2 folds x 2 epochs with
    train, test and -v; the history's validation and the test results
    carry sup_accuracy and adv_accuracy; the per-step loop (scan_epoch
    False) reports them as the scanned epoch does."""
    config = _joint_config(env, "run")
    results = driver.run(config, do_train=True, do_test=True, vis=True,
                         device="cpu")
    assert len(results) == 2
    for r in results:
        assert 0.0 <= r["sup_accuracy"] <= 1.0
        assert 0.0 <= r["adv_accuracy"] <= 1.0
        assert all(np.isfinite(v) for v in r.values())
    ckpt = config["checkpoint_dir"]
    with open(os.path.join(ckpt, "history1.json")) as fp:
        hist = json.load(fp)
    assert [h["epoch"] for h in hist] == [1, 2]
    assert {"sup_accuracy", "adv_accuracy"} <= set(hist[0]["validation"])
    state = load_checkpoint(os.path.join(ckpt, "checkpoint_1.pt"))
    assert "gcn.cheb_0.weight" in state["model"]
    assert os.listdir(os.path.join(ckpt, "mesh1", "sex_change_S")) or (
        os.listdir(os.path.join(ckpt, "mesh1", "sex_change_F")))

    model, ops, _, _ = driver.build_model_and_ops(config, "cpu")
    trainer = driver.make_trainer(config, model, ops, "cpu")
    assert isinstance(trainer, JointTrainer)
    trainer.model.load_state_dict(state["model"])
    index, labels = list_meshes(config)
    ds = MeshDataset(index[:10], config, labels, env[2].v, dtype="test")
    loader = BatchIterator(ds, BATCH)
    eager, _ = trainer.evaluate(loader, ds.mean, ds.std)
    scanned, _ = trainer.evaluate_scanned(loader, ds.mean, ds.std)
    for k in ("loss", "accuracy", "sup_accuracy", "adv_accuracy"):
        np.testing.assert_allclose(scanned[k], eager[k], rtol=1e-6,
                                   err_msg=k)


def test_cli_trains_the_joint_config(env, capsys):
    """python -m meshvae_tpu_torch.train -c files/joint.cfg -t -s with
    overrides for the grid and --device cpu."""
    config = _joint_config(env, "cli")
    overrides = []
    for key in ("template", "root_dir", "checkpoint_dir", "log_file",
                "hierarchy_cache_dir", "cheb_method"):
        overrides += ["-p", key, config[key]]
    for key in ("folds", "epoch", "batch_size", "num_hidden", "num_style",
                "test_size"):
        overrides += ["-p", key, json.dumps(config[key])]
    for key in ("downsampling_factors", "num_conv_filters",
                "polygon_order"):
        overrides += ["-p", key, json.dumps(config[key])]
    cfg = os.path.join(os.path.dirname(os.path.dirname(__file__)), "files",
                       "joint.cfg")
    assert train_main(["-c", cfg, "-t", "-s", "--device", "cpu",
                       *overrides]) == 0
    out = capsys.readouterr().out
    assert "model type: joint_VAE" in out and out.count("round ") == 2
    assert os.path.exists(os.path.join(config["checkpoint_dir"],
                                       "checkpoint_2.pt"))


def test_driver_runs_the_joint_model_in_bf16(env):
    """run() with type = joint_VAE at compute_dtype bfloat16: 2 folds x 1
    epoch, train and test; finite test averages with sup_accuracy and
    adv_accuracy; float32 checkpoints (the master weights)."""
    config = _joint_config(env, "bf16", epoch=1, compute_dtype="bfloat16")
    results = driver.run(config, do_train=True, do_test=True, device="cpu")
    assert len(results) == 2
    for r in results:
        assert all(np.isfinite(v) for v in r.values())
        assert 0.0 <= r["sup_accuracy"] <= 1.0
    state = load_checkpoint(os.path.join(config["checkpoint_dir"],
                                         "checkpoint_1.pt"))
    assert all(v.dtype == torch.float32 for v in state["model"].values())


def test_worlds_are_entered(env, monkeypatch):
    """data_parallel, seq_parallel and multihost are no longer refused for
    type = joint_VAE: run() enters the world each names, whose ranks run
    the joint model (tests/test_torch_world_classifiers.py)."""
    seen = []
    monkeypatch.setattr(driver, "spawn_local",
                        lambda fn, dp, sp, device, args:
                        seen.append(("local", dp, sp)) or fn("world", *args))
    monkeypatch.setattr(driver, "maybe_init_multihost",
                        lambda config, device:
                        seen.append("multihost") or "world")
    monkeypatch.setattr(driver, "_run_rank", lambda world, *args: [world])
    for key, value in (("data_parallel", 2), ("seq_parallel", 2),
                       ("multihost", True)):
        assert driver.run(_joint_config(env, "world", **{key: value}),
                          do_train=True, do_test=False,
                          device="cpu") == ["world"]
    assert seen == [("local", 2, 1), ("local", 1, 2), "multihost"]


@pytest.mark.cuda
def test_cuda_train_step_matches_the_cpu(env):
    """One deterministic joint train step (dropout 0, z = mu) on the card
    against the CPU twin, both precisions: the kernel at the GCN's shapes,
    the 2B decoder's backward and the P^T at 2B width. Loss within 1e-5
    relative, every gradient within 1e-4 (highest) / 1e-3 (high) of the
    layer's max|g|; 22 bsr_grouped_spmm launches in the precision's mode
    and 3 fp32 pool_transpose (the P^T)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    hier, batch, (mean, std) = env[0], env[4], env[5]
    model = _port_model(hier)
    cpu_ops, dev_ops = _port_ops(hier, "cpu"), _port_ops(hier, "cuda")
    for precision, bar in (("highest", 1e-4), ("high", 1e-3)):
        out = {}
        for side, ops in (("cpu", cpu_ops), ("cuda", dev_ops)):
            m = JointMeshVAE(
                dataclasses.replace(model.cfg, precision=precision),
                dataclasses.replace(model.gcn_cfg, precision=precision),
                model.split)
            m.load_state_dict(model.state_dict())
            tr = JointTrainer(m, ops, CONFIG, device=side)
            bsr_spmm.reset_launches()
            pool_transpose.reset_launches()
            packed = tr.train_step(tr.to_device(batch), None,
                                   *tr.norm_to_device(mean, std)).cpu()
            out[side] = (packed, {k: p.grad.cpu() for k, p in
                                  tr.model.named_parameters()},
                         (bsr_spmm.launches(),
                          dict(pool_transpose.LAUNCHES)))
        mode = "fp32" if precision == "highest" else "bf16x3"
        lap, pool = out["cuda"][2]
        assert lap[mode] == 22 and sum(lap.values()) == 22, lap
        assert pool == {"fp32": 3, "bf16": 0}, pool
        loss = out["cpu"][0][0]
        assert abs(out["cuda"][0][0] - loss) <= 1e-5 * abs(loss)
        grads = out["cpu"][1]
        for name, g in grads.items():
            layer = name.rsplit(".", 1)[0]
            scale = max(v.abs().max() for k, v in grads.items()
                        if k.rsplit(".", 1)[0] == layer)
            assert (out["cuda"][1][name] - g).abs().max() <= bar * scale
