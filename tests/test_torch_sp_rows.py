"""seq_parallel's row layout (parallel.sharding.shard_operators):
activations at a row-sharded level hold only the rank's rows of it, on the CPU, with the sp ranks run as threads of one process
(torch_parallel_worker.ThreadComm) on a 24 x 24 grid at factors 4, 4
(levels 576, 144, 36; at sp = 2 the level-0 rows split 384 / 192):

  * the pools at every level transition (row-sharded to row-sharded, to a
    whole level, from a whole level), in both backward branches (the P^T
    gathers, and the CSR twin of pool_transpose above TGRAD_ELL_MAX): the
    rank's forward and backward rows bit-equal to the single process's in
    fp32, within one bf16 ulp of the scale in bf16; the dense pool too;
  * the row-in / row-out conv against the earlier whole-tensor form of
    cheb_conv_bsr_sharded (a copy kept here) and against the JAX
    package's cheb_conv_pallas_sharded on make_device_mesh(dp=4, sp=2),
    at tests/test_torch_parallel.py's bars;
  * the embedded final conv, its corner dense or its own row shard (a
    corner spanning both ranks' rows);
  * the VAE's Trainer (train step, evaluate, the scanned epoch) and
    InferenceEngine on a hybrid hierarchy (bsr_min_n makes the coarse
    level dense) and an all-block-sparse one against one process: the
    loss within 1e-5, every gradient within 1e-4 of its layer's max|g|;
    x and every activation at a row-sharded level hold the rank's
    rows_local rows;
  * one train step on the hybrid hierarchy against the JAX Trainer under
    make_device_mesh(dp=4, sp=2), at tests/test_torch_parallel.py's bars.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.ops import block_sparse as jax_bs
from meshvae_tpu.ops import pallas_shard as jax_shard
from meshvae_tpu.parallel.sharding import make_device_mesh

from meshvae_tpu_torch.infer.driver import InferenceEngine
from meshvae_tpu_torch.mesh import build_hierarchy, vertex_adjacency
from meshvae_tpu_torch.models import (MeshVAE, VAEConfig, build_operators,
                                      params_from_flax)
from meshvae_tpu_torch.ops import block_sparse, bsr_shard, graph
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops.bsr_spmm import pad_features
from meshvae_tpu_torch.ops.graph import (GraphOperator, embed_operator,
                                         normalized_neg_adjacency)
from meshvae_tpu_torch.ops.pool import pool_apply
from meshvae_tpu_torch.parallel import sharding
from meshvae_tpu_torch.train import Trainer, unpack_metrics

import torch_parallel_worker as W

SP = 2
ULP = 2.0 ** -8   # one bf16 ulp of the scale (tests/test_torch_bf16.py)
BF = torch.bfloat16
HYBRID = 100      # bsr_min_n: levels 576 and 144 block-sparse, 36 dense
CONFIG = dict(W.CONFIG, polygon_order=[3, 3, 6])
DTYPES = {"fp32": torch.float32, "bf16": BF}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


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


def thread_world(rank, comm, sp=SP):
    """A dp = 1 x sp world whose sp group (and whole world) is the thread
    ranks' ThreadComm."""
    return sharding.World(1, sp, rank, torch.device("cpu"), "threads", comm,
                          _Solo(), comm, {})


def _hold(got, want, dtype, what):
    if dtype == "fp32":
        assert torch.equal(got, want), what
    else:
        delta = (got.float() - want.float()).abs().max().item()
        assert delta <= ULP * want.float().abs().max().item(), (what, delta)


def _randn(rng, shape, dt):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dt)


# --- the pools --------------------------------------------------------------

# (row-sharded input level, row-sharded output level) on the hybrid grid
TRANSITIONS = {"down0": (True, True), "down1": (True, False),
               "up0": (True, True), "up1": (False, True)}


def _pool_case(hier, which, dt, method="gather"):
    ops = build_operators(hier, "cpu", cheb_method="pallas", bsr_min_n=HYBRID,
                          dtype=dt, pool_method=method)
    kind, i = which[:-1], int(which[-1])
    return ops, kind, i


def _pool_rows(ops, kind, i, x, g, method):
    """Every thread rank's (pool, output rows, input-gradient rows)."""
    def rank(r, comm):
        sh = sharding.shard_operators(ops, thread_world(r, comm))
        p = getattr(sh, kind)[i]
        xl = (p.in_rows.local(x) if p.in_rows else x).requires_grad_(True)
        gl = p.out_rows.local(g) if p.out_rows else g
        out = pool_apply(xl, p, method)
        (dx,) = torch.autograd.grad(out, xl, gl)
        return p, out.detach(), dx

    return W.run_threads(rank, SP)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("branch", ["gather", "csr"])
@pytest.mark.parametrize("which", sorted(TRANSITIONS))
def test_pool_rows_equal_single_process(hier, monkeypatch, which, branch,
                                        dtype):
    """The sharded pool's forward rows and its input gradient's rows
    against the single process's (B * F = 128, one column panel, so the
    CSR branch runs where P^T is built in CSR; TGRAD_ELL_MAX 0 builds it
    for every pool, a huge one for none)."""
    monkeypatch.setattr(graph, "TGRAD_ELL_MAX",
                        0 if branch == "csr" else 10 ** 6)
    dt = DTYPES[dtype]
    ops, kind, i = _pool_case(hier, which, dt)
    pool = getattr(ops, kind)[i]
    assert (pool.t_ptr is not None) == (branch == "csr")
    rng = np.random.default_rng(7)
    x = _randn(rng, (8, pool.n_in, 16), dt)
    g = _randn(rng, (8, pool.n_out, 16), dt)
    xs = x.clone().requires_grad_(True)
    out = pool_apply(xs, pool)
    (dx,) = torch.autograd.grad(out, xs, g)
    rows_seen = []
    for p, o, d in _pool_rows(ops, kind, i, x, g, "gather"):
        assert (p.in_rows is not None, p.out_rows is not None) == \
            TRANSITIONS[which]
        assert o.shape[1] == (p.out_rows.rows_local if p.out_rows
                              else pool.n_out)
        assert d.shape[1] == p.x_rows
        want_o = p.out_rows.local(out.detach()) if p.out_rows else out
        want_d = p.in_rows.local(dx) if p.in_rows else dx
        _hold(o, want_o.detach(), dtype, "forward")
        _hold(d, want_d, dtype, "backward")
        if p.in_rows is not None and p.t_ptr is not None:
            # P^T's CSR row shard: rebased, the rank's rows only
            assert p.t_ptr.shape[0] == p.in_rows.rows_local + 1
            assert int(p.t_ptr[0]) == 0
            assert int(p.t_ptr[-1]) == p.t_col.shape[0]
            rows_seen.append(p.t_col.shape[0])
    if rows_seen:   # the shards together hold P^T's entries once
        assert sum(rows_seen) == pool.t_col.shape[0]


@pytest.mark.parametrize("which", ["down1", "up1"])
def test_dense_pool_rows_equal_single_process(hier, which):
    """pool_method dense under the row layout: the product on the whole
    input, the rank's output rows, bit-equal in fp32."""
    ops, kind, i = _pool_case(hier, which, torch.float32, "dense")
    pool = getattr(ops, kind)[i]
    rng = np.random.default_rng(8)
    x = _randn(rng, (4, pool.n_in, 8), torch.float32)
    g = _randn(rng, (4, pool.n_out, 8), torch.float32)
    xs = x.clone().requires_grad_(True)
    out = pool_apply(xs, pool, "dense")
    (dx,) = torch.autograd.grad(out, xs, g)
    for p, o, d in _pool_rows(ops, kind, i, x, g, "dense"):
        want_o = p.out_rows.local(out.detach()) if p.out_rows else out
        want_d = p.in_rows.local(dx) if p.in_rows else dx
        _hold(o, want_o.detach(), "fp32", "forward")
        _hold(d, want_d, "fp32", "backward")


# --- the conv ---------------------------------------------------------------

class _OldLocalRows(torch.autograd.Function):
    """The earlier whole-tensor form's input cut: replicated
    [n_pad_global, ...] -> the rank's rows, the gradient all-gathered."""

    @staticmethod
    def forward(ctx, t, group, row0, rows):
        ctx.group = group
        return t[row0:row0 + rows].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous()), None, None, None


class _OldGatherRows(torch.autograd.Function):
    """Its output gather: the rank's rows -> replicated, the gradient
    sliced to the rank's rows."""

    @staticmethod
    def forward(ctx, t, group, row0):
        ctx.row0, ctx.rows = row0, t.shape[0]
        return group.all_gather(t.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g[ctx.row0:ctx.row0 + ctx.rows].contiguous(), None, None


def _old_conv(x, op, weight, bias, precision):
    """cheb_conv_bsr_sharded as it was before the row layout: whole x in,
    whole result out."""
    sbsr, group = op.bsr_sp, op.sp_group
    mode = port_cheb._KERNEL_MODE[port_cheb.resolve_precision(
        precision, sbsr.op.blocks.dtype)]
    b, n, f_in = x.shape
    f_pad = pad_features(b, f_in)
    xt = F.pad(x.transpose(0, 1),
               (0, f_pad - f_in, 0, 0, 0, sbsr.n_pad_global - n))
    w = F.pad(weight, (0, 0, 0, f_pad - f_in))
    xt_local = _OldLocalRows.apply(xt, group, sbsr.row0, sbsr.rows_local)
    out_local = bsr_shard._BasisMixSharded.apply(xt_local, w, sbsr, group,
                                                 mode)
    out = _OldGatherRows.apply(out_local, group, sbsr.row0)[:n].transpose(
        0, 1)
    return out if bias is None else out + bias


@pytest.mark.parametrize("case", ["fp32", "fp32-lazy", "bf16"])
def test_row_conv_matches_whole_form_and_jax(monkeypatch, case):
    """The row-in / row-out conv on a 23 x 23 grid (529 rows: 384 / 145 of
    768 at sp = 2), K = 3, b = 32, f = 16 (a square mix: the lazy branch
    runs under FUSED_SEED_DOT): forward, dx and dW bit-equal to the
    earlier whole-tensor form's rows, dbias (now summed per rank, then
    over the group) within the bars; all of them against
    cheb_conv_pallas_sharded at 1e-5 of the max in fp32, one bf16 ulp in
    bf16 (no bias in bf16, as tests/test_torch_parallel.py)."""
    fp32 = case.startswith("fp32")
    lazy = case.endswith("lazy")
    monkeypatch.setattr(pc, "FUSED_SEED_DOT", lazy)
    monkeypatch.setattr(port_cheb, "FUSED_SEED_DOT", lazy)
    tdt, jdt = (torch.float32, jnp.float32) if fp32 else (BF, jnp.bfloat16)
    precision = "highest" if fp32 else "default"
    mesh = W.grid_mesh(23)
    lap = normalized_neg_adjacency(vertex_adjacency(mesh.v.shape[0],
                                                    mesh.f))
    n = lap.shape[0]
    bsr = block_sparse.to_block_sparse(lap, "cpu", dtype=tdt)
    shards = bsr_shard.shard_block_sparse_all(bsr, SP)
    rng = np.random.default_rng(43)
    k, b, f = 3, 32, 16
    x = rng.standard_normal((b, n, f)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f, f))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    g = rng.standard_normal((b, n, f)).astype(np.float32)

    jop = types.SimpleNamespace(
        bsr_sp=jax_shard.shard_block_sparse(
            jax_bs.to_block_sparse(lap, dtype=jdt), SP),
        mesh=make_device_mesh(dp=4, sp=SP))

    def jax_loss(x_, w_, b_):
        out = jax_shard.cheb_conv_pallas_sharded(
            x_.astype(jdt), jop, w_.astype(jdt),
            b_.astype(jdt) if fp32 else None,
            precision=(jax.lax.Precision.HIGHEST if fp32
                       else jax.lax.Precision.DEFAULT))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    jax_side = [np.array(a, np.float32) for a in (jout, *jgrads)]

    def run(xt, op, gt, conv):
        wt, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (w, bias))
        xt = xt.requires_grad_(True)
        out = conv(xt.to(tdt), op, wt.to(tdt), bt.to(tdt) if fp32 else None,
                   precision)
        (out.float() * gt).sum().backward()
        return [out.detach().float(), xt.grad, wt.grad, bt.grad]

    def rank(r, comm):
        s = shards[r]
        rows = bsr_shard.RowShard.of(s, comm)
        op = GraphOperator(dense=None, bsr=None, n=n, active_n=n, bsr_sp=s,
                           sp_group=comm)
        new = run(rows.local(torch.from_numpy(x)), op,
                  rows.local(torch.from_numpy(g)), port_cheb.cheb_conv)
        old = run(torch.from_numpy(x), op, torch.from_numpy(g), _old_conv)
        return rows, new, old

    bar = 1e-5 if fp32 else ULP
    for rows, new, old in W.run_threads(rank, SP):
        assert new[0].shape == (b, rows.rows_local, f)
        for i, name in enumerate(("out", "dx")):
            _hold(new[i], rows.local(old[i]), "fp32", name)
            ref = rows.local(torch.from_numpy(jax_side[i]))
            delta = (new[i] - ref).abs().max().item()
            assert delta <= bar * ref.abs().max().item(), (name, delta)
        assert torch.equal(new[2], old[2]), "dW"
        for i, name in ((2, "dW"), (3, "dbias")):
            if new[i] is None:
                continue
            ref = jax_side[i]
            for got in (new[i], old[i]):
                delta = np.abs(got.numpy() - ref).max()
                assert delta <= bar * np.abs(ref).max(), (name, delta)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("corner", ["dense", "row-sharded"])
def test_embedded_final_conv_rows(hier, corner, dtype):
    """The embedded operator on level-0 rows (576 at sp = 2: 384 / 192):
    the grid's coarsest level (36 rows, all on rank 0) as a dense corner,
    or a 20 x 20 grid's Laplacian (400 rows, spanning both ranks' level-0
    rows) as a block-sparse corner with its own row shard (256 rows per
    rank); K = 6, bias included. Forward and gradients against the single
    process at 1e-5 of the max in fp32, one bf16 ulp in bf16."""
    dt = DTYPES[dtype]
    n0 = hier.levels[0]
    if corner == "dense":
        op = embed_operator(hier.adjacency[-1], n0, "cpu", bsr_min_n=HYBRID,
                            dtype=dt)
        assert op.bsr is None
    else:
        m = W.grid_mesh(20)
        op = embed_operator(vertex_adjacency(m.v.shape[0], m.f), n0, "cpu",
                            bsr_min_n=0, dtype=dt)
        assert op.bsr is not None and op.active_n > n0 // 2
    level0 = block_sparse.to_block_sparse(
        normalized_neg_adjacency(hier.adjacency[0]), "cpu")
    rng = np.random.default_rng(11)
    k, b, f_in, f_out = 6, 4, 16, 3
    x = _randn(rng, (b, n0, f_in), torch.float32)
    g = _randn(rng, (b, n0, f_out), torch.float32)
    w = _randn(rng, (k, f_in, f_out), torch.float32) * 0.1
    bias = _randn(rng, (f_out,), torch.float32) * 0.1

    def run(xt, op_, gt):
        xt, wt, bt = (t.clone().requires_grad_(True) for t in (xt, w, bias))
        out = port_cheb.cheb_conv(xt.to(dt), op_, wt.to(dt), bt.to(dt),
                                  precision=None)
        (out.float() * gt).sum().backward()
        return [out.detach().float(), xt.grad, wt.grad, bt.grad]

    want = run(x, op, g)

    def rank(r, comm):
        rows = bsr_shard.RowShard.of(
            bsr_shard.shard_block_sparse(level0, SP, r), comm)
        sop = dataclasses.replace(op, row_shard=rows)
        if op.bsr is not None:
            sop = dataclasses.replace(
                sop, bsr=None, sp_group=comm,
                bsr_sp=bsr_shard.shard_block_sparse(op.bsr, SP, r))
        return rows, run(rows.local(x), sop, rows.local(g))

    bar = 1e-5 if dtype == "fp32" else ULP
    for rows, got in W.run_threads(rank, SP):
        for i, name in enumerate(("out", "dx", "dW", "dbias")):
            ref = rows.local(want[i]) if i < 2 else want[i]
            delta = (got[i] - ref).abs().max().item()
            assert delta <= bar * ref.abs().max().item(), (name, delta)


# --- the VAE's trainer and engine -------------------------------------------

LAYOUTS = {"hybrid": HYBRID, "all-bsr": 0}


def _model_state(hier):
    cfg = VAEConfig.from_config(CONFIG, coarse_verts=hier.levels[-1])
    return cfg, MeshVAE(cfg, generator=torch.Generator().manual_seed(3)
                        ).state_dict()


def _trainer(hier, bsr_min_n, dist=None, config=CONFIG):
    cfg, state = _model_state(hier)
    model = MeshVAE(cfg)
    model.load_state_dict(state)
    ops = build_operators(hier, "cpu", cheb_method="pallas",
                          bsr_min_n=bsr_min_n)
    return Trainer(model, ops, config, device="cpu", dist=dist)


def _norm(n0):
    rng = np.random.default_rng(5)
    return ((0.1 * rng.standard_normal((n0, 3))).astype(np.float32),
            (1.0 + 0.1 * rng.random((n0, 3))).astype(np.float32))


def _grads(tr):
    return {k: v.grad.detach().clone() for k, v in tr.model.named_parameters()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_trainer_step_rows_match_single_process(hier, layout):
    """A deterministic train step on a padded batch: the loss and the
    packed metrics within 1e-5, every gradient within 1e-4 of its layer's
    max|g|, the ranks' parameters bit-equal after Adam."""
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    batch = W.step_batch(n0, padded=True, seed=4)
    one = _trainer(hier, LAYOUTS[layout])
    want = one.train_step(one.to_device(batch), None,
                          *one.norm_to_device(mean, std))
    want_g = _grads(one)

    def rank(r, comm):
        tr = _trainer(hier, LAYOUTS[layout], thread_world(r, comm))
        packed = tr.train_step(tr.to_device(batch), None,
                               *tr.norm_to_device(mean, std))
        return packed, _grads(tr), {k: v.detach().clone() for k, v in
                                    tr.model.state_dict().items()}

    res = W.run_threads(rank, SP)
    for packed, grads, _ in res:
        np.testing.assert_allclose(packed.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        for k, gw in want_g.items():
            delta = (grads[k] - gw).abs().max().item()
            assert delta <= 1e-4 * gw.abs().max().item(), (k, delta)
    for k, v in res[0][2].items():
        assert torch.equal(res[1][2][k], v), k


def test_trainer_step_rows_match_jax_mesh(hier, monkeypatch):
    """One deterministic train step (z = mu, no dropout) on the hybrid
    hierarchy in the row layout (576 rows: 384 / 192) against the JAX
    Trainer under make_device_mesh(dp=4, sp=2), whose PALLAS_MIN_N =
    HYBRID makes the same levels block-sparse (the distributed kernel in
    interpret mode): the metrics within rtol 1e-5, the parameters after
    Adam within rtol 1e-4 (tests/test_torch_parallel.py's bars)."""
    # flax is imported here, as in tests/test_torch_parallel.py
    import meshvae_tpu.ops.graph as jax_graph
    from meshvae_tpu.mesh.hierarchy import MeshHierarchy as JaxHierarchy
    from meshvae_tpu.models.operators import build_operators as jax_build_ops
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
    from meshvae_tpu.train.loop import Trainer as JaxTrainer
    from meshvae_tpu.train.loop import unpack_metrics as jax_unpack

    n0 = hier.levels[0]
    mean, std = _norm(n0)
    batch = W.step_batch(n0, padded=False, seed=4)
    _, state = _model_state(hier)
    monkeypatch.setattr(jax_graph, "PALLAS_MIN_N", HYBRID)
    monkeypatch.setattr(JaxMeshVAE, "reparameterize",
                        lambda self, mu, logvar: mu)
    jops = jax_build_ops(JaxHierarchy(hier.vertices, hier.faces,
                                      hier.adjacency, hier.downsample,
                                      hier.upsample),
                         cheb_method="pallas", pool_method="gather")
    jtr = JaxTrainer(JaxMeshVAE(JaxVAEConfig.from_config(
        CONFIG, coarse_verts=hier.levels[-1])), jops, CONFIG,
        mesh=make_device_mesh(dp=4, sp=SP))
    params = jtr.maybe_replicate(jax.tree_util.tree_map(
        jnp.asarray, W.flax_tree(state)))
    opt_state = jtr.maybe_replicate(jtr.init_opt_state(params))
    params, _, metrics = jtr._train_step(
        params, opt_state, jtr._put(batch), jax.random.key(1),
        jtr.maybe_replicate(jnp.asarray(mean)),
        jtr.maybe_replicate(jnp.asarray(std)))
    want = jax_unpack(metrics)
    want_params = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          params))

    def rank(r, comm):
        tr = _trainer(hier, HYBRID, thread_world(r, comm))
        assert tr.vertex_shard.rows_local == 384
        packed = tr.train_step(tr.to_device(batch), None,
                               *tr.norm_to_device(mean, std))
        return unpack_metrics(packed), W.params_of(tr.model)

    for metrics, got_params in W.run_threads(rank, SP):
        for k in want:
            np.testing.assert_allclose(metrics[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        for k, v in want_params.items():
            np.testing.assert_allclose(got_params[k], v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_activations_hold_the_rank_rows(hier):
    """In the row layout x is staged as the rank's level-0 rows and every
    conv's input and output at a row-sharded level has rows_local rows
    (the dense coarse level, h and z whole); recon is the rank's rows."""
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    batch = W.step_batch(n0, padded=False, seed=6)

    def rank(r, comm):
        tr = _trainer(hier, HYBRID, thread_world(r, comm))
        seen = []
        for name, mod in tr.model.named_children():
            if name.startswith("cheb_"):
                mod.register_forward_hook(
                    lambda m, args, out, name=name: seen.append(
                        (name, args[1], args[0].shape[1], out.shape[1])))
        dev = tr.to_device(batch)
        y = F.one_hot(dev["label"], 2).float()
        out = tr.model(dev["x"], y, tr.ops)
        return tr, dev, seen, out

    for r, (tr, dev, seen, out) in enumerate(W.run_threads(rank, SP)):
        shard = tr.vertex_shard
        assert (shard.row0, shard.rows_local) == (r * 384, 384)
        np.testing.assert_array_equal(dev["x"].numpy(),
                                      shard.local(torch.from_numpy(
                                          batch["x"]), dim=1).numpy())
        assert dev["x"].shape == (8, 384, 3)
        assert len(seen) == 5
        for name, op, n_in, n_out in seen:
            want = op.rows.rows_local if op.rows is not None else op.n
            assert n_in == n_out == want, name
        assert sum(op.rows is not None for _, op, _, _ in seen) == 5
        assert out["recon"].shape == (8, 384, 3)
        assert out["z"].shape == (8, CONFIG["num_style"])
        # the padding rows hold zeros
        valid = shard.count()
        assert not out["recon"][:, valid:].any()


def test_trainer_evaluate_rows_match_single_process(hier):
    """evaluate(collect_meshes=True) over a full and a padded batch: the
    averages within 1e-5, the per-vertex errors and the meshes gathered
    over sp (to all 576 rows) within the world test's bars."""
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    loader = [W.step_batch(n0, False, seed=1), W.step_batch(n0, True, seed=2)]
    one = _trainer(hier, HYBRID)
    avg, errors, meshes = one.evaluate(loader, mean, std, collect_meshes=True)

    def rank(r, comm):
        tr = _trainer(hier, HYBRID, thread_world(r, comm))
        return tr.evaluate(loader, mean, std, collect_meshes=True)

    for got_avg, got_err, got_meshes in W.run_threads(rank, SP):
        for k, v in avg.items():
            np.testing.assert_allclose(got_avg[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        assert got_err.shape == errors.shape == (14, n0)
        np.testing.assert_allclose(got_err, errors, rtol=1e-4, atol=1e-6)
        for k, v in meshes.items():
            np.testing.assert_allclose(got_meshes[k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_scanned_epoch_rows_match_single_process(hier):
    """stage_batches stages x as the rank's vertex rows [S, B, 384, 3];
    a scanned train epoch (identity order, no dropout) and a scanned eval
    with the meshes against one process, both given norm_to_device's
    statistics (the [N, 3] ones are refused)."""
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    loader = [W.step_batch(n0, False, seed=1), W.step_batch(n0, True, seed=2)]
    loader = [dict(b, index=np.arange(8) + 8 * i)
              for i, b in enumerate(loader)]

    def epoch(tr):
        staged = tr.stage_batches(loader, with_index=True)
        norm = tr.norm_to_device(mean, std)
        if tr.vertex_shard is not None:   # the [N, 3] statistics: refused
            with pytest.raises(ValueError, match="norm_to_device"):
                tr.train_epoch_scanned(staged, None, mean, std)
        train = tr.train_epoch_scanned(staged, None, *norm)
        return staged["x"].shape, train, tr.evaluate_scanned(
            staged, *norm, collect_meshes=True)

    shape, train, (avg, errors, meshes) = epoch(_trainer(hier, HYBRID))
    assert shape == (2, 8, n0, 3)
    res = W.run_threads(
        lambda r, comm: epoch(_trainer(hier, HYBRID, thread_world(r, comm))),
        SP)
    for got_shape, got_train, (got_avg, got_err, got_meshes) in res:
        assert got_shape == (2, 8, 384, 3)
        for k, v in train.items():
            np.testing.assert_allclose(got_train[k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        for k, v in avg.items():
            np.testing.assert_allclose(got_avg[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(got_err, errors, rtol=1e-4, atol=1e-5)
        for k, v in meshes.items():
            np.testing.assert_allclose(got_meshes[k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_rows_match_single_process(hier, layout):
    """InferenceEngine.run_dataset in the row layout: pred equal, the
    per-mesh error mean and max (reduced over sp) within 1e-5 relative,
    the meshes gathered over sp within 1e-5 of their scale."""
    n0 = hier.levels[0]
    mean, std = _norm(n0)
    loader = [W.step_batch(n0, False, seed=1), W.step_batch(n0, True, seed=2)]
    cfg, state = _model_state(hier)

    def run(dist):
        model = MeshVAE(cfg)
        model.load_state_dict(state)
        ops = build_operators(hier, "cpu", cheb_method="pallas",
                              bsr_min_n=LAYOUTS[layout])
        engine = InferenceEngine(model.eval(), ops, dist=dist)
        norm = engine.norm_to_device(mean, std, "cpu")
        return engine.run_dataset(loader, *norm)

    want = run(None)
    for got in W.run_threads(lambda r, comm: run(thread_world(r, comm)), SP):
        np.testing.assert_array_equal(got["packed"][:, 0],
                                      want["packed"][:, 0])
        np.testing.assert_allclose(got["packed"], want["packed"], rtol=1e-5)
        for k in ("recon_orig", "oppo_orig"):
            assert got[k].shape == want[k].shape == (2, 8, n0, 3)
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 1e-5 * scale, k


def test_shard_batch_stages_vertex_keys():
    """shard_batch: the dp rows of every array, and of VERTEX_KEYS the
    rank's vertex rows, zero past N; vertex_dim_shardable needs sp > 1
    and a row-sharded level 0."""
    rows = bsr_shard.RowShard(n=5, n_pad_global=8, row0=4, rows_local=4,
                              group=None)
    world = sharding.World(2, 2, 3, torch.device("cpu"), "gloo", None,
                           None, None, {})
    batch = {"x": np.arange(4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3),
             "original": np.ones((4, 5, 3), np.float32),
             "r": np.arange(4 * 9).reshape(4, 3, 3)}
    out = sharding.shard_batch(batch, world, rows)
    assert out["x"].shape == out["original"].shape == (2, 4, 3)
    np.testing.assert_array_equal(out["x"][:, 0], batch["x"][2:, 4])
    assert not out["x"][:, 1:].any() and not out["original"][:, 1:].any()
    np.testing.assert_array_equal(out["r"], batch["r"][2:])
    assert sharding.VERTEX_KEYS == ("x", "original")
    fake = lambda r: types.SimpleNamespace(
        lap=(types.SimpleNamespace(rows=r),))
    assert sharding.vertex_dim_shardable(fake(rows), world)
    assert not sharding.vertex_dim_shardable(fake(None), world)
    assert not sharding.vertex_dim_shardable(fake(rows), None)
    assert sharding.vertex_rows(fake(rows), world) is rows
