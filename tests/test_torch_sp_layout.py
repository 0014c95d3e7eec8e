"""sp's one activation layout for every model and every cheb_method
(parallel.sharding.shard_operators), on the CPU, with the sp ranks run as
threads of one process (torch_parallel_worker.ThreadComm) on a 24 x 24
grid at factors 4, 4 (levels 576, 144, 36) with the cutoff lowered to
bsr_min_n = 100: levels 576 and 144 are row-sharded whatever their
layout (at sp = 2 the rank's rows 384 of 768 and 128 of 256), level 36
stays whole.

  * the ELL and dense row convs (ops/cheb.py propagate_rows) in fp32 and
    bf16 against one process and against the JAX package's cheb_conv
    (ell / dense) on make_device_mesh(dp=4, sp=2) with its
    shard_operators; their backward holds every rank's terms, where
    autograd through from_rows (each rank's own terms only) misses the
    bar;
  * the VAE's Trainer step under ell and dense against one process, and
    an ell step against the JAX Trainer on the mesh;
  * CreconTrainer's train and eval steps and JointTrainer's train step
    under pallas, ell and dense against one process; crecon (ell) and the
    joint model (dense) against the JAX trainers on the mesh;
  * x, the GCN's input diff and every conv activation at a row-sharded
    level hold the rank's rows;
  * the three methods' worlds stage the same x rows and cut the same
    pools.

Bars: a conv's forward 1e-5 of max|y|, its gradients 1e-4 of their max|g|
(fp32, highest); in bf16 torch_port_utils.closer, as
tests/test_torch_bf16.py holds bf16: against one process's bf16 and the
JAX package's bf16, each within their distance to the JAX package's fp32
plus one bf16 ulp of the scale (bf16_ulp: the spacing of bf16 numbers at
the largest |value|; one process's ELL backward sums in bf16 through
index_add, the row form's gather in fp32). A step: the loss 1e-5 relative, every gradient 1e-4 of its
layer's max|g|; the eval scalars 1e-5 relative. Every JAX step is
deterministic (dropout 0, z = mu)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.models.operators import build_operators as jax_build_ops
from meshvae_tpu.ops.cheb import cheb_conv as jax_cheb_conv
from meshvae_tpu.parallel.sharding import make_device_mesh
from meshvae_tpu.parallel.sharding import shard_operators as jax_shard_ops

from meshvae_tpu_torch.mesh import build_hierarchy
from meshvae_tpu_torch.models import (ChebGCN, GCNConfig, MeshVAE, VAEConfig,
                                      build_operators, params_from_flax)
from meshvae_tpu_torch.models.joint import build_joint_model
from meshvae_tpu_torch.ops import bsr_shard, graph
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.parallel import sharding
from meshvae_tpu_torch.train import JointTrainer, Trainer
from meshvae_tpu_torch.train import crecon_driver
from meshvae_tpu_torch.train.crecon_driver import CreconTrainer

import torch_parallel_worker as W
from torch_port_utils import bf16_ulp, closer, jax_hierarchy

SP = 2
HYBRID = 100      # bsr_min_n: levels 576 and 144 row-sharded, 36 whole
METHODS = ("pallas", "ell", "dense")
VAE_CONFIG = dict(W.CONFIG, polygon_order=[3, 3, 6])
CRECON_CONFIG = dict(W.CONFIG, learning_rate=1e-4)
JOINT_CONFIG = dict(W.CONFIG, latent_split=2, sup_weight=1.0,
                    adv_weight=0.1, cls_weight=1.0)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(autouse=True)
def thread_replicate(monkeypatch):
    """CreconTrainer broadcasts rank 0's frozen VAE; the thread ranks have
    no process group, and each loads the same weights."""
    monkeypatch.setattr(crecon_driver, "replicate", lambda tensors, dist: None)


@pytest.fixture(scope="module")
def hier():
    return build_hierarchy(W.grid_mesh(24), [4, 4])


class _Solo:
    """The dp group of a world with dp = 1."""
    size = 1
    rank = 0

    def all_gather(self, t, dim=0):
        return t

    def all_reduce_(self, t):
        return t


def thread_world(rank, comm):
    """A dp = 1 x sp world whose sp group (and whole world) is the thread
    ranks' ThreadComm."""
    return sharding.World(1, SP, rank, torch.device("cpu"), "threads", comm,
                          _Solo(), comm, {})


def _ops(hier, method, dtype=torch.float32):
    return build_operators(hier, "cpu", cheb_method=method,
                           bsr_min_n=HYBRID, dtype=dtype)


def _delta(got, want):
    return (got.float() - want.float()).abs().max().item()


def _scale(t):
    return t.float().abs().max().item()


def _flax_tree(state: dict) -> dict:
    """A port state_dict as the JAX package's param tree (the inverse of
    params_from_flax): dotted names nest, a Linear weight [out, in]
    becomes a Dense kernel [in, out]."""
    tree = {}
    for name, v in state.items():
        *path, layer, leaf = name.split(".")
        a = v.numpy()
        if leaf == "weight" and not layer.startswith("cheb_"):
            leaf, a = "kernel", a.T
        node = tree
        for part in path + [layer]:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(a))
    return {"params": tree}


def _grads_from_flax(grads) -> dict:
    return params_from_flax(jax.tree_util.tree_map(np.asarray, grads))


def _grads(model) -> dict:
    return {k: v.grad.detach().clone() for k, v in model.named_parameters()}


def _hold_grads(got: dict, want: dict):
    """Every gradient within 1e-4 of its layer's max|g|."""
    assert set(got) == set(want)
    for k, gw in want.items():
        gw = torch.as_tensor(np.asarray(gw))
        d = _delta(got[k], gw)
        assert d <= 1e-4 * _scale(gw), (k, d, _scale(gw))


def _jax_ops(hier, method, dtype=jnp.float32):
    """The JAX package's operators of the grid hierarchy for `method`; its
    pallas hybrid at the same cutoff."""
    old = jax_graph.PALLAS_MIN_N
    jax_graph.PALLAS_MIN_N = HYBRID
    try:
        return jax_build_ops(jax_hierarchy(hier), dtype=dtype,
                             cheb_method=method, pool_method="gather")
    finally:
        jax_graph.PALLAS_MIN_N = old


# --- the ELL and dense row convs ------------------------------------------

def _conv_inputs(n, k=4, b=4, f_in=8, f_out=8, seed=21):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, f_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f_in, f_out))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f_out)).astype(np.float32)
    g = rng.standard_normal((b, n, f_out)).astype(np.float32)
    return x, w, bias, g


def _jax_conv(hier, method, jdt, precision, x, w, bias, g):
    """cheb_conv on the JAX package's level-0 operator sharded on
    make_device_mesh(dp=4, sp=2): (out, dx, dW, dbias) of sum(out * g)."""
    jop = jax_shard_ops(_jax_ops(hier, method, jdt),
                        make_device_mesh(dp=4, sp=SP)).lap[0]

    def loss(x_, w_, b_):
        out = jax_cheb_conv(x_.astype(jdt), jop, w_.astype(jdt),
                            b_.astype(jdt), method=method,
                            precision=precision)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    return [torch.from_numpy(np.array(a, np.float32)) for a in (out, *grads)]


def _port_conv(op, x, w, bias, g, dt):
    """(out, dx, dW, dbias) of sum(cheb_conv * g) on the port."""
    xt, wt, bt = (torch.from_numpy(np.ascontiguousarray(a)) if
                  isinstance(a, np.ndarray) else a for a in (x, w, bias))
    xt, wt, bt = (t.clone().requires_grad_(True) for t in (xt, wt, bt))
    out = port_cheb.cheb_conv(xt.to(dt), op, wt.to(dt), bt.to(dt),
                              precision="highest" if dt == torch.float32
                              else None)
    gt = g if isinstance(g, torch.Tensor) else torch.from_numpy(g)
    (out.float() * gt).sum().backward()
    return [out.detach().float(), xt.grad, wt.grad, bt.grad]


def _row_op(hier, method, dt, rank, comm):
    op = _ops(hier, method, dt).lap[0]
    return graph.shard_graph_operator(
        op, bsr_shard.RowShard.for_level(op.n, SP, rank, comm))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("method", ["ell", "dense"])
def test_row_conv_matches_single_process_and_jax(hier, method, dtype):
    """The level-0 conv (576 rows: 384 / 192 at sp = 2, K = 4, bias) on
    the rank's rows of an ELL or dense operator: forward and the
    gradients of sum(conv * g) against one process and against the JAX
    package's sharded conv."""
    fp32 = dtype == "fp32"
    dt, jdt = (torch.float32, jnp.float32) if fp32 else (torch.bfloat16,
                                                         jnp.bfloat16)
    n = hier.levels[0]
    x, w, bias, g = _conv_inputs(n)
    single = _port_conv(_ops(hier, method, dt).lap[0], x, w, bias, g, dt)
    jax_side = _jax_conv(hier, method, jdt,
                         "highest" if fp32 else "default", x, w, bias, g)
    yard = None if fp32 else _jax_conv(hier, method, jnp.float32, "highest",
                                       x, w, bias, g)

    def rank(r, comm):
        op = _row_op(hier, method, dt, r, comm)
        rows = op.rows
        got = _port_conv(op, rows.local(torch.from_numpy(x)), w, bias,
                         rows.local(torch.from_numpy(g)), dt)
        return rows, got

    for rows, got in W.run_threads(rank, SP):
        assert got[0].shape == (4, rows.rows_local, 8)
        assert not got[0][:, rows.count():].any()   # padding rows stay 0
        for i, name in enumerate(("out", "dx", "dW", "dbias")):
            local = (lambda t: rows.local(t)) if i < 2 else (lambda t: t)
            want, ref = local(single[i]), local(jax_side[i])
            if fp32:
                bar = 1e-5 if i == 0 else 1e-4
                for other, what in ((want, "one process"), (ref, "jax")):
                    d = _delta(got[i], other)
                    assert d <= bar * _scale(other), (name, what, d)
            else:
                j32 = local(yard[i])
                for other, what in ((want, "one process"), (ref, "jax")):
                    closer(f"{method} {name} vs {what}", got[i], other, j32,
                           _scale(j32), ulp=bf16_ulp(_scale(j32)))


@pytest.mark.parametrize("method", ["ell", "dense"])
def test_row_backward_holds_every_ranks_terms(hier, method):
    """dx of one propagation L @ x on the rank's rows: propagate_rows'
    backward (the sharded product on the all-gathered cotangent) within
    1e-5 of one process's; autograd through from_rows and the rank's rows
    of L keeps only the rank's own output rows' terms and misses by far
    more than the bar."""
    n = hier.levels[0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, n, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, n, 8)).astype(np.float32))
    full = _ops(hier, method).lap[0]
    xs = x.clone().requires_grad_(True)
    prop = ((lambda o, t: port_cheb.propagate_ell(o, t)) if method == "ell"
            else (lambda o, t: torch.matmul(o.dense, t)))
    (dx,) = torch.autograd.grad(prop(full, xs), xs, g)

    def rank(r, comm):
        op = _row_op(hier, method, torch.float32, r, comm)
        rows = op.rows
        xl = rows.local(x).requires_grad_(True)
        gl = rows.local(g)
        (right,) = torch.autograd.grad(port_cheb.propagate_rows(op, xl), xl,
                                       gl)
        xl2 = rows.local(x).requires_grad_(True)
        whole = bsr_shard.from_rows(xl2, rows)
        (wrong,) = torch.autograd.grad(prop(op, whole), xl2, gl)
        return rows, right, wrong

    for rows, right, wrong in W.run_threads(rank, SP):
        want = rows.local(dx)
        assert _delta(right, want) <= 1e-5 * _scale(want)
        assert _delta(wrong, want) > 1e-2 * _scale(want)


# --- the VAE's trainer ----------------------------------------------------

def _norm(n0):
    rng = np.random.default_rng(5)
    return ((0.1 * rng.standard_normal((n0, 3))).astype(np.float32),
            (1.0 + 0.1 * rng.random((n0, 3))).astype(np.float32))


def _vae_state(hier):
    cfg = VAEConfig.from_config(VAE_CONFIG, coarse_verts=hier.levels[-1])
    return cfg, MeshVAE(cfg, generator=torch.Generator().manual_seed(3)
                        ).state_dict()


def _vae_trainer(hier, method, dist=None):
    cfg, state = _vae_state(hier)
    model = MeshVAE(cfg)
    model.load_state_dict(state)
    return Trainer(model, _ops(hier, method), VAE_CONFIG, device="cpu",
                   dist=dist)


def _vae_step(tr, batch, mean, std):
    packed = tr.train_step(tr.to_device(batch), None,
                           *tr.norm_to_device(mean, std))
    return W.unpack_metrics(packed), _grads(tr.model)


def _hold_metrics(got, want, rtol=1e-5):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("method", ["ell", "dense"])
def test_vae_step_matches_single_process(hier, method):
    """A deterministic train step on a padded batch with the ELL or dense
    levels row-sharded: the metrics within 1e-5, every gradient within
    1e-4 of its layer's max|g|."""
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    batch = W.step_batch(n0, padded=True, seed=4)
    want, want_g = _vae_step(_vae_trainer(hier, method), batch, mean, std)

    def rank(r, comm):
        tr = _vae_trainer(hier, method, thread_world(r, comm))
        assert tr.vertex_shard.rows_local == 384
        return _vae_step(tr, batch, mean, std)

    for metrics, grads in W.run_threads(rank, SP):
        _hold_metrics(metrics, want)
        _hold_grads(grads, want_g)


def test_vae_ell_step_matches_jax_mesh(hier, monkeypatch):
    """One deterministic ell train step in the row layout against the JAX
    Trainer under make_device_mesh(dp=4, sp=2): the metrics within rtol
    1e-5 and every gradient within 1e-4 of its layer's max|g|."""
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
    from meshvae_tpu.train.loop import Trainer as JaxTrainer
    from meshvae_tpu.train.loop import unpack_metrics as jax_unpack

    n0 = hier.levels[0]
    mean, std = _norm(n0)
    batch = W.step_batch(n0, padded=False, seed=4)
    _, state = _vae_state(hier)
    monkeypatch.setattr(JaxMeshVAE, "reparameterize",
                        lambda self, mu, logvar: mu)
    cfg = dict(VAE_CONFIG, cheb_method="ell")
    jtr = JaxTrainer(JaxMeshVAE(JaxVAEConfig.from_config(
        cfg, coarse_verts=hier.levels[-1])), _jax_ops(hier, "ell"), cfg,
        mesh=make_device_mesh(dp=4, sp=SP))
    params = jtr.maybe_replicate(_flax_tree(state))
    put = jtr._put(batch)
    keys = {"latent": jax.random.key(0), "dropout": jax.random.key(1)}
    _, grads = jax.jit(jax.value_and_grad(
        lambda p, b, o: jtr._forward_loss(p, b, keys, True, o)[0]))(
        params, put, jtr._ops_on_device)
    _, _, metrics = jtr._train_step(
        params, jtr.maybe_replicate(jtr.init_opt_state(params)), put,
        jax.random.key(1), jtr.maybe_replicate(jnp.asarray(mean)),
        jtr.maybe_replicate(jnp.asarray(std)))
    want, want_g = jax_unpack(metrics), _grads_from_flax(grads)

    def rank(r, comm):
        return _vae_step(_vae_trainer(hier, "ell", thread_world(r, comm)),
                         batch, mean, std)

    for metrics, got_g in W.run_threads(rank, SP):
        _hold_metrics(metrics, want)
        _hold_grads(got_g, want_g)


# --- crecon and the joint model -------------------------------------------

def _classifier_states(hier):
    coarse = hier.levels[-1]
    return {
        "vae": MeshVAE(VAEConfig.from_config(CRECON_CONFIG,
                                             coarse_verts=coarse),
                       generator=torch.Generator().manual_seed(0)
                       ).state_dict(),
        "gcn": ChebGCN(GCNConfig.from_config(CRECON_CONFIG,
                                             coarse_verts=coarse),
                       generator=torch.Generator().manual_seed(1)
                       ).state_dict(),
        "joint": build_joint_model(JOINT_CONFIG, coarse,
                                   generator=torch.Generator().manual_seed(2)
                                   ).state_dict()}


def _crecon_trainer(hier, states, method, dist=None):
    coarse = hier.levels[-1]
    vae = MeshVAE(VAEConfig.from_config(CRECON_CONFIG, coarse_verts=coarse))
    vae.load_state_dict(states["vae"])
    gcn = ChebGCN(GCNConfig.from_config(CRECON_CONFIG, coarse_verts=coarse))
    gcn.load_state_dict(states["gcn"])
    return CreconTrainer(gcn, vae, _ops(hier, method), CRECON_CONFIG,
                         device="cpu", dist=dist)


def _joint_trainer(hier, states, method, dist=None):
    model = build_joint_model(JOINT_CONFIG, hier.levels[-1])
    model.load_state_dict(states["joint"])
    return JointTrainer(model, _ops(hier, method), JOINT_CONFIG,
                        device="cpu", dist=dist)


def _crecon_steps(tr, batch, eval_batch):
    """The train step's packed [loss, correct, count] and gradients, then
    the eval step's scalars from the updated GCN."""
    packed = tr.train_step(tr.to_device(batch))
    grads = _grads(tr.model)
    return packed, grads, tr.eval_step(tr.to_device(eval_batch))["scalars"]


def _joint_step(tr, batch, mean, std):
    packed = tr.train_step(tr.to_device(batch), None,
                           *tr.norm_to_device(mean, std))
    return W.unpack_metrics(packed), _grads(tr.model)


def _batches(n0):
    return (W.step_batch(n0, padded=False, seed=10),
            W.step_batch(n0, padded=True, seed=11))


def _rel(got, want):
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), (
        got, want)


@pytest.mark.parametrize("method", METHODS)
def test_crecon_steps_match_single_process(hier, method):
    """CreconTrainer's train step (full batch) and eval step (padded) in
    the row layout: the loss within 1e-5 relative, correct and count
    equal, every GCN gradient within 1e-4 of its layer's max|g|, the eval
    scalars within 1e-5 relative."""
    states = _classifier_states(hier)
    batch, eval_batch = _batches(hier.levels[0])
    want = _crecon_steps(_crecon_trainer(hier, states, method), batch,
                         eval_batch)

    def rank(r, comm):
        return _crecon_steps(_crecon_trainer(hier, states, method,
                                             thread_world(r, comm)),
                             batch, eval_batch)

    for packed, grads, scalars in W.run_threads(rank, SP):
        _rel(packed[0], want[0][0])
        assert torch.equal(packed[1:], want[0][1:])
        _hold_grads(grads, want[1])
        _rel(scalars[0], want[2][0])
        assert torch.equal(scalars[1:], want[2][1:])


@pytest.mark.parametrize("method", METHODS)
def test_joint_step_matches_single_process(hier, method):
    """JointTrainer's deterministic train step on a padded batch in the
    row layout: the metrics within 1e-5, every gradient (the VAE's, the
    GCN's, the heads') within 1e-4 of its layer's max|g|."""
    states = _classifier_states(hier)
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    batch = _batches(n0)[1]
    want, want_g = _joint_step(_joint_trainer(hier, states, method), batch,
                               mean, std)

    def rank(r, comm):
        return _joint_step(_joint_trainer(hier, states, method,
                                          thread_world(r, comm)),
                           batch, mean, std)

    for metrics, grads in W.run_threads(rank, SP):
        _hold_metrics(metrics, want)
        _hold_grads(grads, want_g)


def test_crecon_steps_match_jax_mesh(hier):
    """crecon under ell in the row layout against the JAX CreconTrainer
    under make_device_mesh(dp=4, sp=2): the train step's loss and the
    GCN's gradients (from the frozen VAE's difference features), and the
    eval step's scalars from the initial weights."""
    from meshvae_tpu.models.gcn import ChebGCN as JaxChebGCN
    from meshvae_tpu.models.gcn import GCNConfig as JaxGCNConfig
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
    from meshvae_tpu.train.crecon_driver import CreconTrainer as JaxCrecon
    from meshvae_tpu.train.crecon_driver import estimate_diff

    states = _classifier_states(hier)
    coarse = hier.levels[-1]
    batch, eval_batch = _batches(hier.levels[0])
    cfg = dict(CRECON_CONFIG, cheb_method="ell")
    jtr = JaxCrecon(
        JaxChebGCN(JaxGCNConfig.from_config(cfg, coarse_verts=coarse)),
        JaxMeshVAE(JaxVAEConfig.from_config(cfg, coarse_verts=coarse)),
        _jax_ops(hier, "ell"), cfg, mesh=make_device_mesh(dp=4, sp=SP))
    params = jtr.maybe_replicate(_flax_tree(states["gcn"]))
    vae_params = jtr.maybe_replicate(_flax_tree(states["vae"]))
    keys = ("x", "label", "mask")

    def loss(p, vp, b, ops):
        diff, _, _ = estimate_diff(jtr.vae, vp, b["x"], b["label"], ops,
                                   train=True)
        return jtr._loss(p, diff, b["label"], b["mask"], ops)[0]

    put = jtr._put({k: batch[k] for k in keys})
    want_loss, grads = jax.jit(jax.value_and_grad(loss))(
        params, vae_params, put, jtr.ops)
    want_g = _grads_from_flax(grads)
    want_eval = np.asarray(jtr._eval_step(
        params, vae_params, jtr._put({k: eval_batch[k] for k in keys}),
        jtr.ops))

    def rank(r, comm):
        tr = _crecon_trainer(hier, states, "ell", thread_world(r, comm))
        ev = tr.eval_step(tr.to_device(eval_batch))["scalars"]
        packed = tr.train_step(tr.to_device(batch))
        return packed, _grads(tr.model), ev

    for packed, got_g, ev in W.run_threads(rank, SP):
        _rel(packed[0], want_loss)
        _hold_grads(got_g, want_g)
        _rel(ev[0], want_eval[0])
        np.testing.assert_array_equal(ev[1:].numpy(), want_eval[1:])


def test_joint_step_matches_jax_mesh(hier, monkeypatch):
    """The joint model's deterministic train step under dense in the row
    layout against the JAX JointTrainer under make_device_mesh(dp=4,
    sp=2): the metrics within rtol 1e-5 and every gradient within 1e-4
    of its layer's max|g|."""
    from meshvae_tpu.models.joint import build_joint_model as jax_joint
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.train.joint import JointTrainer as JaxJointTrainer
    from meshvae_tpu.train.loop import unpack_metrics as jax_unpack

    states = _classifier_states(hier)
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    batch = _batches(n0)[0]
    monkeypatch.setattr(JaxMeshVAE, "reparameterize",
                        lambda self, mu, logvar: mu)
    cfg = dict(JOINT_CONFIG, cheb_method="dense")
    jtr = JaxJointTrainer(jax_joint(cfg, coarse_verts=hier.levels[-1]),
                          _jax_ops(hier, "dense"), cfg,
                          mesh=make_device_mesh(dp=4, sp=SP))
    params = jtr.maybe_replicate(_flax_tree(states["joint"]))
    put = jtr._put(batch)
    keys = {"latent": jax.random.key(0), "dropout": jax.random.key(1)}
    _, grads = jax.jit(jax.value_and_grad(
        lambda p, b, o: jtr._forward_loss(p, b, keys, True, o)[0]))(
        params, put, jtr._ops_on_device)
    _, _, metrics = jtr._train_step(
        params, jtr.maybe_replicate(jtr.init_opt_state(params)), put,
        jax.random.key(1), jtr.maybe_replicate(jnp.asarray(mean)),
        jtr.maybe_replicate(jnp.asarray(std)))
    want, want_g = jax_unpack(metrics), _grads_from_flax(grads)

    def rank(r, comm):
        return _joint_step(_joint_trainer(hier, states, "dense",
                                          thread_world(r, comm)),
                           batch, mean, std)

    for metrics, got_g in W.run_threads(rank, SP):
        _hold_metrics(metrics, want)
        _hold_grads(got_g, want_g)


# --- the layout itself ----------------------------------------------------

def _conv_rows(model):
    """Forward hooks on a GCN's convs: (op, rows in, rows out) per call."""
    seen = []
    for name, mod in model.named_children():
        if name.startswith("cheb_"):
            mod.register_forward_hook(
                lambda m, args, out: seen.append(
                    (args[1], args[0].shape[1], out.shape[1])))
    return seen


@pytest.mark.parametrize("method", METHODS)
def test_classifier_activations_hold_the_rank_rows(hier, method):
    """In crecon and in the joint model x is staged as the rank's level-0
    rows, the GCN's input diff has rows_local rows (zero past N), and
    every GCN conv's input and output at a row-sharded level has its
    level's rows_local rows (level 144 too, level 36 whole)."""
    states = _classifier_states(hier)
    batch = _batches(hier.levels[0])[0]

    def rank(r, comm):
        world = thread_world(r, comm)
        crecon = _crecon_trainer(hier, states, method, world)
        joint = _joint_trainer(hier, states, method, world)
        out = []
        for tr, gcn in ((crecon, crecon.model), (joint, joint.model.gcn)):
            seen = _conv_rows(gcn)
            diffs = []
            gcn.register_forward_pre_hook(
                lambda m, args: diffs.append(args[0].detach()))
            dev = tr.to_device(batch)
            if tr is crecon:
                tr.train_step(dev)
            else:
                tr.train_step(dev, None, *tr.norm_to_device(*_norm(576)))
            out.append((tr.vertex_shard, dev["x"], diffs[0], seen))
        return out

    for per_trainer in W.run_threads(rank, SP):
        for shard, x, diff, seen in per_trainer:
            assert shard.rows_local == 384
            np.testing.assert_array_equal(
                x.numpy(), shard.local(torch.from_numpy(batch["x"])).numpy())
            assert diff.shape == (8, 384, 6)
            assert not diff[:, shard.count():].any()
            assert [op.n for op, _, _ in seen] == [576, 144]
            for op, n_in, n_out in seen:
                assert op.rows is not None
                assert n_in == n_out == op.rows.rows_local


def test_methods_place_the_same_rows(hier):
    """In an sp = 2 world every level of at least bsr_min_n vertices is
    row-sharded under pallas, ell and dense, and the three cut the same
    RowShard per level, the same pools (P's rows of the output shard,
    P^T's gather and CSR rows of the input shard) and stage the same x
    rows; the embedded final operator takes level 0's rows."""
    batch = W.step_batch(hier.levels[0], padded=False, seed=3)

    def rank(r, comm):
        world = thread_world(r, comm)
        out = {}
        for method in METHODS:
            tr = _vae_trainer(hier, method, world)
            out[method] = (tr.ops, tr.to_device(batch)["x"])
        return out

    fields = lambda s: (s.n, s.n_pad_global, s.row0, s.rows_local)
    for r, worlds in enumerate(W.run_threads(rank, SP)):
        ops, x = worlds["pallas"]
        assert [fields(op.rows) if op.rows else None for op in ops.lap] == [
            (576, 768, 384 * r, 384), (144, 256, 128 * r, 128), None]
        assert ops.lap_final.rows is ops.lap[0].rows
        for method in ("ell", "dense"):
            other, other_x = worlds[method]
            assert torch.equal(other_x, x)
            for a, b in zip(ops.lap, other.lap):
                assert (fields(a.rows) if a.rows else None) == (
                    fields(b.rows) if b.rows else None)
            assert fields(other.lap_final.rows) == fields(
                ops.lap_final.rows)
            for p, q in zip(ops.down + ops.up, other.down + other.up):
                for k in ("idx", "w", "t_idx", "t_w", "t_ptr", "t_col",
                          "t_val"):
                    a, b = getattr(p, k), getattr(q, k)
                    assert (a is None) == (b is None), k
                    if a is not None:
                        assert torch.equal(a, b), k
                assert (p.x_rows, p.g_rows) == (q.x_rows, q.g_rows)
        ell = worlds["ell"][0]
        assert ell.lap[0].ell_idx.shape[0] == 384
        assert ell.lap[2].ell_idx.shape[0] == 36      # under the cutoff
        assert worlds["dense"][0].lap[1].dense.shape == (128, 144)


@pytest.mark.parametrize("sp", [2, 4])
def test_level_rows_are_the_block_sparse_shards(sp):
    """RowShard.for_level, the rows an ELL or dense level is cut into,
    equals the block-sparse shard's rows at every rank, also where the
    operator's padded rows round up to a multiple of 8 blocks (79,968
    vertices: 632 blocks, not 625)."""
    import scipy.sparse as sps

    from meshvae_tpu_torch.ops.block_sparse import to_block_sparse
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    for n in (79, 576, 1250, 79968):
        chain = sps.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])
        bsr = to_block_sparse(normalized_neg_adjacency(chain), "cpu")
        for r in range(sp):
            shard = bsr_shard.shard_block_sparse(bsr, sp, r)
            rows = bsr_shard.RowShard.for_level(n, sp, r, None)
            assert (rows.n, rows.n_pad_global, rows.row0, rows.rows_local) \
                == (n, shard.n_pad_global, shard.row0, shard.rows_local), n
