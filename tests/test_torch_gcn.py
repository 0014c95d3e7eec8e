"""meshvae_tpu_torch.models.gcn (the crecon classifier) against the flax
ChebGCN: GCNConfig.from_config, the init distributions, the logits and
every gradient (the input's too) with weights carried by params_from_flax,
on the block-sparse and the dense path at highest, and in bf16 against
the flax GCN's bf16 mode; the kernel calls of a
backward with and without an input gradient; a JAX GCN checkpoint (flax
params and optax Adam state) read by the port's load_checkpoint.

Bars: logits within 1e-5 of max|logit|, each gradient within 1e-4 of its
layer's max|g| (the input's of its own max), Adam moments name for name
exactly as carried; in bf16 torch_port_utils.closer, JAX's fp32 result
the yardstick. The JAX Pallas kernels run in interpret mode.

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

from meshvae_tpu_torch.config import read_config
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy
from meshvae_tpu_torch.models import (ChebGCN, GCNConfig, build_operators,
                                      params_from_flax)
from meshvae_tpu_torch.models.vae import parameter_order
from meshvae_tpu_torch.ops import bsr_spmm
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.train.checkpoint import load_checkpoint

from conftest import make_grid_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
FEATURES = 6      # 2 x the mesh's 3 coordinates
BSR_MIN_N = 128   # the grid's two finest levels block-sparse


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules and the shared set-up."""
    import jax
    import jax.numpy as jnp

    import meshvae_tpu.ops.pallas_cheb as pc
    from meshvae_tpu.config import read_config as jax_read_config
    from meshvae_tpu.models.gcn import GCNConfig as JaxGCNConfig
    from meshvae_tpu.train import loop as jax_loop
    from meshvae_tpu.train.checkpoint import save_checkpoint as jax_save
    import torch_port_utils as utils

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, pc=pc, read_config=jax_read_config,
        GCNConfig=JaxGCNConfig, loop=jax_loop, save=jax_save, utils=utils)


@pytest.fixture
def interpret(ref, monkeypatch):
    monkeypatch.setattr(ref.pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def hier():
    """The 16x16 grid's hierarchy (torch_port_utils.grid_hierarchy's)."""
    mesh = make_grid_mesh(16, jitter=0.05)
    return build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2, 2, 2])


@pytest.fixture(scope="module")
def pair(ref, hier):
    """The paired GCN at highest on the block-sparse path, built once;
    tests copy the port model before changing it."""
    return ref.utils.paired_gcn(hier, "highest")


def _inputs(hier, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((BATCH, hier.levels[0], FEATURES)).astype(
        np.float32)


def test_config_matches_jax_at_config_1(ref):
    """files/crecon.cfg at template5k's 20 coarse vertices: the JAX
    package's fields, hidden 128 (not num_hidden), flatten width 20 x 32
    = 640 (filters[-2] of the chain with the input prepended)."""
    path = os.path.join(REPO, "files", "crecon.cfg")
    got = GCNConfig.from_config(read_config(path), coarse_verts=20)
    want = ref.GCNConfig.from_config(ref.read_config(path), coarse_verts=20)
    for field in ("num_features", "filters", "polygon_order", "n_layers",
                  "num_classes", "coarse_verts", "hidden"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.hidden, got.precision) == (128, "highest")
    model = ChebGCN(got)
    assert model.enc_lin.in_features == 640
    assert [n for n, _ in model.named_children()] == [
        "cheb_0", "cheb_1", "cheb_2", "cheb_3", "enc_lin", "cls_layer"]
    assert model.cheb_0.weight.shape == (6, 6, 16)


def test_init_distributions_follow_the_generator():
    """Chebyshev weights glorot-uniform over (in, out) and zero biases;
    head weights ~ N(0, 0.1), biases within 1/sqrt(fan_in); the same seed
    repeats every weight, fresh() draws from its generator."""
    cfg = GCNConfig(num_features=6, filters=(64, 64, 64, 64, 64),
                    polygon_order=(6,) * 5, n_layers=4, num_classes=2,
                    coarse_verts=20)
    a = ChebGCN(cfg, generator=torch.Generator().manual_seed(3))
    b = a.fresh(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    c = ChebGCN(cfg, generator=torch.Generator().manual_seed(4))
    assert not torch.equal(a.cheb_1.weight, c.cheb_1.weight)
    w = a.cheb_1.weight
    bound = np.sqrt(6.0 / (64 + 64))
    assert w.abs().max() <= bound and w.abs().max() > 0.95 * bound
    assert abs(w.std().item() - bound / np.sqrt(3)) < 0.02 * bound
    assert not a.cheb_1.bias.any()
    assert abs(a.enc_lin.weight.std().item() - 0.1) < 0.005
    assert a.enc_lin.bias.abs().max() <= 1 / np.sqrt(a.enc_lin.in_features)


@pytest.mark.parametrize("cheb_method", ["pallas", "dense"])
def test_logits_and_gradients_match_jax(ref, interpret, hier, pair,
                                       cheb_method):
    """Logits, every parameter gradient and the input gradient of the
    masked-mean NLL against jax.value_and_grad of the flax GCN."""
    jax, jnp = ref.jax, ref.jnp
    jmodel, jops, params, pmodel, pops = (
        pair if cheb_method == "pallas" else ref.utils.paired_gcn(
            hier, "highest", "dense"))
    pmodel = copy.deepcopy(pmodel)
    assert (pops.lap[0].bsr is not None) == (cheb_method == "pallas")
    x = _inputs(hier)
    labels = np.array([0, 1, 1, 0])

    def loss_fn(p, xj):
        logits = jmodel.apply(p, xj, jops)
        nll = -jax.nn.log_softmax(logits)[jnp.arange(BATCH), labels]
        return nll.mean(), logits

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = pmodel(xt, pops)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)
                                      ).backward()
    assert logits.dtype == torch.float32
    want = np.asarray(want)
    delta = np.abs(logits.detach().numpy() - want).max()
    assert delta <= 1e-5 * np.abs(want).max(), delta
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, gp)).items()}
    named = dict(pmodel.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        layer = name.rsplit(".", 1)[0]
        scale = max(np.abs(v).max() for k, v in want.items()
                    if k.rsplit(".", 1)[0] == layer)
        delta = np.abs(p.grad.numpy() - want[name]).max()
        assert delta <= 1e-4 * scale, (name, delta, scale)
    gx = np.asarray(gx)
    assert np.abs(xt.grad.numpy() - gx).max() <= 1e-4 * np.abs(gx).max()


def test_bf16_logits_and_gradients_match_jax(ref, interpret, hier, pair,
                                            monkeypatch):
    """compute_dtype bfloat16 (bf16 operators, the input cast to bf16, the
    heads by the Dense rule, fp32 logits and master weights) against the
    flax GCN in bf16 on the block-sparse path, with its fp32 result as the
    yardstick (torch_port_utils.closer, one bf16 ulp as bf16_ulp gives
    it): logits, every parameter gradient and the input gradient; every
    kernel call in mode bf16. from_config in bf16 gives the JAX
    package's compute_dtype and precision."""
    jax, jnp, utils = ref.jax, ref.jnp, ref.utils
    hold = lambda name, got, j16, j32, scale: utils.closer(
        name, got, j16, j32, scale, utils.bf16_ulp(scale))
    path = os.path.join(REPO, "files", "crecon.cfg")
    cfg16 = dict(read_config(path), compute_dtype="bfloat16")
    got = GCNConfig.from_config(cfg16, coarse_verts=20)
    want = ref.GCNConfig.from_config(
        dict(ref.read_config(path), compute_dtype="bfloat16"),
        coarse_verts=20)
    assert (got.compute_dtype, got.precision) == (
        want.compute_dtype, want.precision) == ("bfloat16", "default")
    assert got.dtype == torch.bfloat16

    x = _inputs(hier)
    labels = np.array([0, 1, 1, 0])
    jmodel16, jops16, params, pmodel, pops = utils.paired_gcn(
        hier, "default", compute_dtype="bfloat16")
    outs = {}
    for dtype, (jmodel, jops, params) in (
            ("bfloat16", (jmodel16, jops16, params)), ("float32", pair[:3])):
        def loss_fn(p, xj, jmodel=jmodel, jops=jops):
            logits = jmodel.apply(p, xj, jops)
            nll = -jax.nn.log_softmax(logits)[jnp.arange(BATCH), labels]
            return nll.mean(), logits

        (_, logits), (gp, gx) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        outs[dtype] = (logits, {k: v.numpy() for k, v in params_from_flax(
            jax.tree_util.tree_map(np.asarray, gp)).items()}, gx)
    assert pops.lap[0].bsr.blocks.dtype == torch.bfloat16
    calls = utils.count_kernel_calls(monkeypatch, cheb=port_cheb)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = pmodel(xt, pops)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)
                                      ).backward()
    assert logits.dtype == torch.float32 and xt.grad.dtype == torch.float32
    assert calls == [("cheb", "bf16")] * 8, calls
    (l16, g16, x16), (l32, g32, x32) = outs["bfloat16"], outs["float32"]
    hold("logits", logits, l16, l32, np.abs(np.asarray(l32)).max())
    named = dict(pmodel.named_parameters())
    assert set(named) == set(g32)
    for name, p in named.items():
        assert p.dtype == torch.float32
        layer = name.rsplit(".", 1)[0]
        scale = max(np.abs(v).max() for k, v in g32.items()
                    if k.rsplit(".", 1)[0] == layer)
        hold(f"grad {name}", p.grad, g16[name], g32[name], scale)
    hold("grad x", xt.grad, x16, x32, np.abs(np.asarray(x32)).max())


@pytest.mark.parametrize("input_grad", [False, True])
def test_first_conv_skips_dx_when_the_input_is_constant(ref, hier, pair,
                                                        monkeypatch,
                                                        input_grad):
    """At K = 3 each block-sparse conv (cheb_0 on L0, cheb_1 on L1) runs 2
    kernel calls forward and 2 for its dx; cheb_0's dx runs only when the
    input needs a gradient (the joint model), not on crecon's constant
    difference features."""
    pmodel, pops = copy.deepcopy(pair[3]), pair[4]
    calls = ref.utils.count_kernel_calls(monkeypatch, cheb=port_cheb)
    x = torch.from_numpy(_inputs(hier)).requires_grad_(input_grad)
    pmodel(x, pops).sum().backward()
    assert len(calls) == 4 + 2 + (2 if input_grad else 0), calls
    assert (x.grad is not None) == input_grad


def test_jax_gcn_checkpoint_loads_into_the_port(ref, hier, pair, tmp_path):
    """A JAX save_checkpoint of GCN params and two optax Adam steps ->
    load_checkpoint: the params load into ChebGCN and give the same
    logits; Adam's moments, step and lr follow the module's parameter
    order (parameter_order of the names)."""
    jax, jnp = ref.jax, ref.jnp
    _, _, params, pmodel, pops = pair
    opt = ref.loop.make_optimizer(1e-4, 5e-4)
    state = opt.init(params)
    update = jax.jit(opt.update)
    rng = np.random.default_rng(1)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            params)
        _, state = update(grads, state, params)
    path = str(tmp_path / "checkpoint_1.msgpack")
    ref.save(path, params, state, 3, 0.5, 0.6)
    ck = load_checkpoint(path)
    assert (ck["epoch_num"], ck["train_loss"]) == (3, 0.5)
    order = [n for n, _ in pmodel.named_parameters()]
    assert parameter_order(sorted(ck["model"])) == order
    fresh = ChebGCN(pmodel.cfg, generator=torch.Generator().manual_seed(9))
    fresh.load_state_dict(ck["model"])
    x = torch.from_numpy(_inputs(hier, seed=2))
    with torch.no_grad():
        torch.testing.assert_close(fresh(x, pops), pmodel(x, pops), rtol=0,
                                   atol=0)
    adam = state.inner_state[1]
    mu = params_from_flax(jax.tree_util.tree_map(np.asarray, adam.mu))
    opt_state = ck["optimizer"]
    assert opt_state["param_groups"][0]["lr"] == pytest.approx(1e-4)
    for i, name in enumerate(order):
        assert opt_state["state"][i]["step"].item() == 2.0
        torch.testing.assert_close(opt_state["state"][i]["exp_avg"],
                                   mu[name], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_gcn_matches_the_cpu(hier):
    """The GCN's forward and backward (input gradient on, so cheb_0's dx
    runs at C = B x 8 = 32, F 6 padded to 8) on the card through the
    kernel against the CPU twin from seeded weights, both precisions:
    logits within 1e-5 of max|logit|, gradients within 1e-4 (highest) /
    1e-3 (high) of the layer's max|g|; 8 launches (cheb_0 and cheb_1, 2
    forward and 2 for dx each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cpu_model = ChebGCN(GCNConfig(
        num_features=FEATURES, filters=(8, 8, 8, 16, 16),
        polygon_order=(3,) * 5, n_layers=4, num_classes=2,
        coarse_verts=hier.levels[-1]),
        generator=torch.Generator().manual_seed(0))
    cpu_ops, dev_ops = (build_operators(hier, d, cheb_method="pallas",
                                        bsr_min_n=BSR_MIN_N)
                        for d in ("cpu", "cuda"))
    x = _inputs(hier)
    for precision, bar in (("highest", 1e-4), ("high", 1e-3)):
        out = {}
        for side, ops in (("cpu", cpu_ops), ("cuda", dev_ops)):
            model = ChebGCN(dataclasses.replace(cpu_model.cfg,
                                                precision=precision))
            model.load_state_dict(cpu_model.state_dict())
            model.to(side)
            xt = torch.from_numpy(x).to(side).requires_grad_(True)
            bsr_spmm.reset_launches()
            logits = model(xt, ops)
            logits.square().sum().backward()
            out[side] = (logits.detach().cpu(), {
                k: v.grad.cpu() for k, v in model.named_parameters()},
                xt.grad.cpu(), sum(bsr_spmm.launches().values()))
        assert out["cuda"][3] == 4 * 2, out["cuda"][3]
        want = out["cpu"][0]
        assert (out["cuda"][0] - want).abs().max() <= 1e-5 * want.abs().max()
        grads = out["cpu"][1]
        for name, g in grads.items():
            layer = name.rsplit(".", 1)[0]
            scale = max(v.abs().max() for k, v in grads.items()
                        if k.rsplit(".", 1)[0] == layer)
            assert (out["cuda"][1][name] - g).abs().max() <= bar * scale
        gx = out["cpu"][2]
        assert (out["cuda"][2] - gx).abs().max() <= bar * gx.abs().max()
