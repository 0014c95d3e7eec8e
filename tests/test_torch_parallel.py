"""The port's distribution (meshvae_tpu_torch/parallel, ops/bsr_shard.py)
against the JAX package's (parallel/sharding.py, ops/pallas_shard.py), on
the CPU.

  * the shard layout: shard_block_sparse against the JAX package's at
    sp in {2, 3, 4}, fp32 and bf16, on test_pallas.py's 23x23 grid and the
    template5k L0/L1 Laplacians (the same dense rows per shard,
    n_pad_global, rows_per; tile_mask and row_order recomputed);
  * the sharded products, stacked over the sp ranks run as threads of one
    process (torch_parallel_worker.ThreadComm): the shards' rows bit-equal
    to the unsharded twin in fp32 and bf16; bsr_matmul_sharded and
    cheb_step_sharded, forward and VJP, against the JAX package's on
    make_device_mesh(dp=4, sp=2) at 1e-5 (bf16: one bf16 ulp of the scale,
    tests/test_torch_bf16.py's bar); cheb_conv_bsr_sharded forward and
    gradients against cheb_conv_pallas_sharded with FUSED_SEED_DOT on and
    off (test_pallas.py:170-214), at tests/test_torch_seed_dot.py's bars;
  * a dp=2 x sp=2 gloo world of four CPU ranks (one spawned run) in the
    row layout (x staged as each rank's level-0 shard rows): Trainer
    steps against the port's single-process step and against the JAX
    Trainer under make_device_mesh(dp=2, sp=2) (test_parallel.py's
    test_pallas_method_under_mesh: metrics rtol 1e-5, params rtol 1e-4 and
    atol 1e-5), a padded batch, dropout drawn from a seeded generator,
    every rank's parameters bit-equal, evaluate, the kernel calls per rank
    equal to the single-process calls, and MeshServer.handle against the
    single-process server (TestServeParallel's bars);
  * the train and inference CLIs with -p data_parallel 2 -p seq_parallel 2
    --device cpu against the single-process CLIs;
  * the multihost plumbing (init_process_group monkeypatched), the
    preflight errors and the backend rule;
  * on a card (marked cuda, skipped here): the kernel at the shard shapes
    bit-equal to the unsharded kernel.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.mesh.hierarchy import MeshHierarchy as JaxHierarchy
from meshvae_tpu.ops import block_sparse as jax_bs
from meshvae_tpu.ops import pallas_shard as jax_shard
from meshvae_tpu.parallel.sharding import make_device_mesh

from meshvae_tpu_torch import validate
from meshvae_tpu_torch.data import generate_synthetic_dataset
from meshvae_tpu_torch.mesh import (build_hierarchy, load_obj, save_obj,
                                    vertex_adjacency)
from meshvae_tpu_torch.models import MeshVAE, VAEConfig, params_from_flax
from meshvae_tpu_torch.ops import block_sparse, bsr_shard, bsr_spmm
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops.graph import (GraphOperator,
                                         normalized_neg_adjacency)
from meshvae_tpu_torch.parallel import sharding
from meshvae_tpu_torch.train import driver as port_driver

import torch_parallel_worker as W
from conftest import TEMPLATE_PATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP = 2.0 ** -8   # one bf16 ulp of the scale (tests/test_torch_bf16.py)
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


def _laplacian(mesh):
    return normalized_neg_adjacency(vertex_adjacency(mesh.v.shape[0],
                                                     mesh.f))


@pytest.fixture(scope="module")
def laplacians():
    """test_pallas.py's 23x23 grid and the template5k L0 and L1."""
    hier = build_hierarchy(load_obj(TEMPLATE_PATH), [4])
    return {"grid23": _laplacian(W.grid_mesh(23)),
            "t5k_L0": normalized_neg_adjacency(hier.adjacency[0]),
            "t5k_L1": normalized_neg_adjacency(hier.adjacency[1])}


def _shard_dense(op) -> np.ndarray:
    out = np.zeros((op.n_pad, op.n_pad_cols), np.float32)
    blocks = op.blocks.float().numpy()
    for i, (r, c) in enumerate(zip(op.block_row.tolist(),
                                   op.block_col.tolist())):
        out[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] += blocks[i]
    return out


def _jax_shard_dense(sbsr, s) -> np.ndarray:
    rows = sbsr.rows_per_shard
    out = np.zeros((rows, sbsr.n_pad), np.float32)
    blocks = np.asarray(sbsr.blocks[s].astype(jnp.float32))
    for i, (r, c) in enumerate(zip(np.asarray(sbsr.block_row[s]),
                                   np.asarray(sbsr.block_col[s]))):
        out[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] += blocks[i]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sp", [2, 3, 4])
@pytest.mark.parametrize("which", ["grid23", "t5k_L0", "t5k_L1"])
def test_shard_layout_matches_jax(laplacians, which, sp, dtype):
    lap = laplacians[which]
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (BF, jnp.bfloat16))
    bsr = block_sparse.to_block_sparse(lap, "cpu", dtype=tdt)
    jbsr = jax_bs.to_block_sparse(lap, dtype=jdt)
    jsh = jax_shard.shard_block_sparse(jbsr, sp)
    shards = bsr_shard.shard_block_sparse_all(bsr, sp)
    for s, shard in enumerate(shards):
        op = shard.op
        assert shard.n_pad_global == jsh.n_pad
        assert shard.rows_per == jsh.rows_per_shard // 128
        assert (op.n_pad, op.n_pad_cols) == (jsh.rows_per_shard, jsh.n_pad)
        assert op.blocks.dtype == tdt
        np.testing.assert_array_equal(_shard_dense(op),
                                      _jax_shard_dense(jsh, s))
        mask = block_sparse.tile_mask(op.blocks.float())
        assert torch.equal(op.tile_mask, mask)
        assert torch.equal(op.row_order, torch.from_numpy(
            block_sparse.row_order(mask.numpy(), op.g_idx.numpy(),
                                   op.g_bcol.numpy(),
                                   op.n_pad_cols // 128)))
        # every local row is present; placeholder rows have no slot
        assert op.g_idx.shape[0] == shard.rows_per
        assert sorted(op.row_order.tolist()) == list(range(shard.rows_per))
    # the shards together hold exactly the operator's rows
    stacked = np.concatenate([_shard_dense(s.op) for s in shards])
    full = block_sparse.bsr_to_dense(bsr)
    np.testing.assert_array_equal(stacked[:bsr.n, :bsr.n_pad], full)
    assert not stacked[bsr.n:].any() and not stacked[:, bsr.n_pad:].any()


def _seeds(kind, n_rows, c, rng, dt, f=16):
    """The kernel's seed arguments of a call kind, [n_rows, C] each."""
    t = lambda: torch.from_numpy(
        rng.standard_normal((n_rows, c)).astype(np.float32)).to(dt)
    if kind == "none":
        return {}
    if kind == "prev":
        return {"t_prev": t()}
    if kind == "plus":
        return {"t_plus": t()}
    if kind == "both":
        return {"t_plus": t(), "t_prev": t()}
    wt = torch.from_numpy((0.1 * rng.standard_normal((f, f))).astype(
        np.float32)).to(dt)
    return {"t_plus_dot": (t(), wt), "t_prev": t()}


def _rows(seeds, r0, r1):
    out = {}
    for k, v in seeds.items():
        out[k] = (v[0][r0:r1], v[1]) if k == "t_plus_dot" else v[r0:r1]
    return out


@pytest.mark.parametrize("mode", ["fp32", "bf16x3", "bf16"])
@pytest.mark.parametrize("sp", [2, 4])
def test_shard_rows_equal_unsharded(laplacians, sp, mode):
    """Each shard's product on the full x equals the same rows of the
    unsharded product, for every seed case (the lazy seed outside bf16x3,
    where it is eager): bit for bit in fp32 and bf16, since a row depends
    only on its blocks, their columns and x; within 1e-5 of max|y| in
    bf16x3, whose hi/lo split is also exact per row (bit-equal here)."""
    dt = bsr_spmm.MODE_DTYPE[mode]
    bsr = block_sparse.to_block_sparse(laplacians["grid23"], "cpu", dtype=dt)
    shards = bsr_shard.shard_block_sparse_all(bsr, sp)
    n_glob = shards[0].n_pad_global
    rng = np.random.default_rng(sp)
    c = 128
    x = torch.from_numpy(rng.standard_normal((n_glob, c)).astype(
        np.float32)).to(dt)
    x[bsr.n_pad:] = 0  # the padding rows of the global layout
    for kind in ("none", "prev", "plus", "both", "dot"):
        seeds = _seeds(kind, n_glob, c, rng, dt)
        full = bsr_spmm.bsr_grouped_spmm(bsr, x[:bsr.n_pad], mode, 2.0,
                                         **_rows(seeds, 0, bsr.n_pad))
        got = torch.cat([
            bsr_spmm.bsr_grouped_spmm(
                s.op, x, mode, 2.0,
                **_rows(seeds, s.row0, s.row0 + s.rows_local))
            for s in shards])
        assert torch.equal(got[:bsr.n_pad], full), kind
        # placeholder rows: alpha * 0 + t_plus - t_prev
        rest = _rows(seeds, bsr.n_pad, n_glob)
        want = torch.zeros_like(got[bsr.n_pad:]).float()
        if "t_plus" in rest:
            want += rest["t_plus"].float()
        if "t_prev" in rest:
            want -= rest["t_prev"].float()
        if "t_plus_dot" in rest:
            want += bsr_spmm._seed_dot(rest["t_plus_dot"][0].float(),
                                       rest["t_plus_dot"][1].float())
        torch.testing.assert_close(got[bsr.n_pad:].float(), want,
                                   rtol=0, atol=0 if mode != "bf16" else
                                   ULP * want.abs().max().item())


def _sharded_op(op, shard, comm):
    return dataclasses.replace(op, bsr=None, bsr_sp=shard, sp_group=comm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_products_match_jax(laplacians, dtype):
    """bsr_matmul_sharded and cheb_step_sharded, forward and VJP, stacked
    over two thread ranks, against the JAX package's on a dp4 x sp2
    mesh."""
    fp32 = dtype == "float32"
    tdt, jdt = (torch.float32, jnp.float32) if fp32 else (BF, jnp.bfloat16)
    mode = "fp32" if fp32 else "bf16"
    lap = laplacians["grid23"]
    jsh = jax_shard.shard_block_sparse(jax_bs.to_block_sparse(lap, dtype=jdt),
                                       2)
    shards = bsr_shard.shard_block_sparse_all(
        block_sparse.to_block_sparse(lap, "cpu", dtype=tdt), 2)
    n_glob = shards[0].n_pad_global
    rng = np.random.default_rng(0)
    x, t0, g = (rng.standard_normal((n_glob, 512)).astype(np.float32)
                for _ in range(3))
    x[lap.shape[0]:] = t0[lap.shape[0]:] = 0
    dmesh = make_device_mesh(dp=4, sp=2)
    @jax.jit  # eager shard_map in interpret mode is ~5x slower
    def jax_side(jx, jt0, jg):
        y_mm, vjp_mm = jax.vjp(
            lambda t: jax_shard.bsr_matmul_sharded(
                jsh, t, dmesh, precision=jax.lax.Precision.HIGHEST), jx)
        y_st, vjp_st = jax.vjp(
            lambda a, b: jax_shard.cheb_step_sharded(
                jsh, a, b, dmesh, precision=jax.lax.Precision.HIGHEST),
            jx, jt0)
        return [y_mm, vjp_mm(jg)[0], y_st, *vjp_st(jg)]

    want = jax_side(*(jnp.asarray(a, jdt) for a in (x, t0, g)))

    def rank(r, comm):
        s = shards[r]
        loc = lambda a: torch.from_numpy(
            a[s.row0:s.row0 + s.rows_local]).to(tdt).requires_grad_(True)
        xl, tl, gl = loc(x), loc(t0), loc(g).detach()
        y1 = bsr_shard.bsr_matmul_sharded(s, xl, comm, mode)
        (dx1,) = torch.autograd.grad(y1, xl, gl)
        y2 = bsr_shard.cheb_step_sharded(s, xl, tl, comm, mode)
        dx2, dt2 = torch.autograd.grad(y2, (xl, tl), gl)
        return [t.detach() for t in (y1, dx1, y2, dx2, dt2)]

    res = W.run_threads(rank, 2)
    bar = 1e-5 if fp32 else ULP
    for i, name in enumerate(("matmul", "matmul vjp", "step", "step dx",
                              "step dt0")):
        got = torch.cat([r[i] for r in res]).float().numpy()
        ref = np.asarray(want[i], np.float32)
        assert np.abs(got - ref).max() <= bar * np.abs(ref).max(), name


@pytest.mark.parametrize("case", ["fp32", "fp32-lazy", "bf16", "bf16-lazy"])
def test_sharded_conv_matches_jax(laplacians, monkeypatch, case):
    """cheb_conv_bsr_sharded (two thread ranks; the whole x cut to the
    rank's rows by to_rows, the rows gathered whole by from_rows) forward
    and the gradients of sum(conv * g) against cheb_conv_pallas_sharded
    on dp4 x sp2, with
    FUSED_SEED_DOT off and on in both packages (b = 32, f = 16: a square
    mix, so the lazy branch runs in both), K = 3;
    1e-5 of the max in fp32, one bf16 ulp in bf16 (no bias in bf16:
    tests/test_torch_seed_dot.py)."""
    import types

    fp32 = case.startswith("fp32")
    lazy = case.endswith("lazy")
    monkeypatch.setattr(pc, "FUSED_SEED_DOT", lazy)
    monkeypatch.setattr(port_cheb, "FUSED_SEED_DOT", lazy)
    tdt, jdt = (torch.float32, jnp.float32) if fp32 else (BF, jnp.bfloat16)
    precision = "highest" if fp32 else "default"
    lap = laplacians["grid23"]
    n = lap.shape[0]
    jsh = jax_shard.shard_block_sparse(jax_bs.to_block_sparse(lap, dtype=jdt),
                                       2)
    jop = types.SimpleNamespace(bsr_sp=jsh, mesh=make_device_mesh(dp=4, sp=2))
    bsr = block_sparse.to_block_sparse(lap, "cpu", dtype=tdt)
    op = GraphOperator(dense=None, bsr=bsr, n=n, active_n=n)
    shards = bsr_shard.shard_block_sparse_all(bsr, 2)
    rng = np.random.default_rng(41)
    k, b, f = 3, 32, 16
    x = rng.standard_normal((b, n, f)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f, f))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    g = rng.standard_normal((b, n, f)).astype(np.float32)

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

    def rank(r, comm):
        sop = _sharded_op(op, shards[r], comm)
        xt, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, w, bias))
        rows = sop.rows
        out = bsr_shard.from_rows(port_cheb.cheb_conv(
            bsr_shard.to_rows(xt.to(tdt), rows), sop, wt.to(tdt),
            bt.to(tdt) if fp32 else None, precision=precision), rows)
        (out.float() * torch.from_numpy(g)).sum().backward()
        return out.detach().float(), xt.grad, wt.grad, bt.grad

    bar = 1e-5 if fp32 else ULP
    for got in W.run_threads(rank, 2):
        for name, a, ref in zip(("out", "dx", "dW", "dbias"), got,
                                (jout, *jgrads)):
            if a is None:
                continue
            ref = np.asarray(ref, np.float32)
            delta = np.abs(a.numpy() - ref).max()
            assert delta <= bar * np.abs(ref).max(), (name, delta)


# --- a dp=2 x sp=2 gloo world of four CPU ranks --------------------------

def _jax_hierarchy(h):
    return JaxHierarchy(h.vertices, h.faces, h.adjacency, h.downsample,
                        h.upsample)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX-initialised weights; the spawned 2 x 2 world's rank results; the
    port's single-process results; the kernel calls of one deterministic
    step in one process, by operator shape."""
    root = str(tmp_path_factory.mktemp("torch_parallel"))
    hier = W.hierarchy()
    state = MeshVAE(VAEConfig.from_config(
        W.CONFIG, coarse_verts=hier.levels[-1]),
        generator=torch.Generator().manual_seed(0)).state_dict()
    params = W.flax_tree(state)
    assert all(torch.equal(v, state[k])
               for k, v in params_from_flax(params).items())
    params_path = os.path.join(root, "params.pt")
    torch.save(state, params_path)
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(W.grid_mesh(), data_dir,
                               n_samples=W.SERVE_MESHES, seed=2)
    sharding.spawn_local(W.world_rank, 2, 2, "cpu",
                         args=(params_path, data_dir, root), timeout=300)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    single = W.train_scenario(None, params_path)
    single_serve = W.serve_scenario(None, params_path, data_dir)
    return dict(params=params, hier=hier, ranks=ranks, single=single,
                single_serve=single_serve)


def _close_metrics(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _close_params(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("tag", ["full", "padded", "dropout"])
def test_world_step_matches_single_process(world, tag):
    """dp=2 x sp=2 steps against the port's single-process steps from the
    same weights: a full batch, a batch whose last two rows are padding
    (mask 0), and a step with dropout 0.2 and the noise drawn from a
    seeded generator for the global batch."""
    want = world["single"]
    for r in world["ranks"]:
        _close_metrics(r["train"][f"metrics_{tag}"], want[f"metrics_{tag}"])
        _close_params(r["train"][f"params_{tag}"], want[f"params_{tag}"])


def test_world_replicas_bit_equal(world):
    first = world["ranks"][0]["train"]
    for r in world["ranks"][1:]:
        for tag in ("full", "padded", "dropout"):
            for k, v in first[f"params_{tag}"].items():
                np.testing.assert_array_equal(r["train"][f"params_{tag}"][k],
                                              v, err_msg=f"{tag} {k}")


def test_world_step_matches_jax_mesh(world, monkeypatch):
    """The world's first step against the JAX Trainer under
    make_device_mesh(dp=2, sp=2), cheb_method pallas with PALLAS_MIN_N = 0
    (the distributed kernel in interpret mode), z = mu and no dropout."""
    # the JAX model and trainer need flax, which the card's machine lacks:
    # imported here, so that the file's cuda test collects there
    from meshvae_tpu.models.operators import build_operators as jax_build_ops
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
    from meshvae_tpu.train.loop import Trainer as JaxTrainer
    from meshvae_tpu.train.loop import unpack_metrics as jax_unpack

    hier = world["hier"]
    monkeypatch.setattr(jax_graph, "PALLAS_MIN_N", 0)
    monkeypatch.setattr(JaxMeshVAE, "reparameterize",
                        lambda self, mu, logvar: mu)
    jops = jax_build_ops(_jax_hierarchy(hier), cheb_method="pallas",
                         pool_method="gather")
    model = JaxMeshVAE(JaxVAEConfig.from_config(
        W.CONFIG, coarse_verts=hier.levels[-1]))
    trainer = JaxTrainer(model, jops, W.CONFIG,
                         mesh=make_device_mesh(dp=2, sp=2))
    params = trainer.maybe_replicate(
        jax.tree_util.tree_map(jnp.asarray, world["params"]))
    opt_state = trainer.maybe_replicate(trainer.init_opt_state(params))
    n0 = hier.levels[0]
    m = trainer.maybe_replicate(jnp.zeros((n0, 3), jnp.float32))
    s = trainer.maybe_replicate(jnp.ones((n0, 3), jnp.float32))
    params, _, metrics = trainer._train_step(
        params, opt_state, trainer._put(W.step_batch(n0, False)),
        jax.random.key(1), m, s)
    want = jax_unpack(metrics)
    want_params = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          params))
    for r in world["ranks"]:
        _close_metrics(r["train"]["metrics_full"], want)
        _close_params(r["train"]["params_full"],
                      {k: v.numpy() for k, v in want_params.items()})


def test_world_evaluate_matches_single_process(world):
    want = world["single"]
    for r in world["ranks"]:
        got = r["train"]
        _close_metrics(got["eval_avg"], want["eval_avg"])
        np.testing.assert_allclose(got["eval_errors"], want["eval_errors"],
                                   rtol=1e-4, atol=1e-6)
        for k, v in want["eval_meshes"].items():
            np.testing.assert_allclose(got["eval_meshes"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_world_kernel_calls_per_rank(world):
    """Per rank, one deterministic step makes as many Laplacian kernel
    calls as the single-process step, in the same order, each at its
    operator's shard shape [rows_per * 128, n_pad_global]; each call
    all-gathers its input over sp."""
    want = world["single"]["calls_full"]
    for r in world["ranks"]:
        got = r["train"]["calls_full"]
        assert len(got) == len(want) > 0
        for (rows, cols), (n_pad, n_pad_cols) in zip(got, want):
            assert n_pad == n_pad_cols
            n_glob = -(-n_pad // 256) * 256
            assert (rows, cols) == (n_glob // 2, n_glob)
        assert r["train"]["gathers_full"] >= len(got)


def test_world_stages_x_as_the_level0_shard_rows(world):
    """Each rank's staged x is its dp rows of the batch and, of those, the
    rank's level-0 shard rows [row0, row0 + rows_local), zero past the
    level's n (the 8 x 8 grid's 64 vertices in 256 padded rows: rank
    sp 0 holds them all, sp 1 only padding)."""
    n0 = world["hier"].levels[0]
    host = W.step_batch(n0, False)["x"]
    assert world["single"]["x_shard"] is None
    np.testing.assert_array_equal(world["single"]["x_staged"], host)
    for r in world["ranks"]:
        row0, rows, n = r["train"]["x_shard"]
        assert (row0, rows, n) == (r["sp_rank"] * 128, 128, n0)
        b = host.shape[0] // 2
        want = np.zeros((b, rows, 3), np.float32)
        own = host[r["dp_rank"] * b:(r["dp_rank"] + 1) * b, row0:row0 + rows]
        want[:, :own.shape[1]] = own
        np.testing.assert_array_equal(r["train"]["x_staged"], want)


def test_world_serve_matches_single_process(world):
    """MeshServer.handle (12 meshes at batch 8: two pipelined chunks, the
    second padded) in the 2 x 2 world against the single-process server,
    as test_parallel.py's TestServeParallel."""
    want = world["single_serve"]
    for r in world["ranks"]:
        got = r["serve"]
        assert [a["file"] for a in got] == [b["file"] for b in want]
        for a, b in zip(got, want):
            assert a["sex"] == b["sex"]
            for key in ("mean", "max"):
                np.testing.assert_allclose(a["reconstruction_error"][key],
                                           b["reconstruction_error"][key],
                                           rtol=1e-4)


# --- the CLIs --------------------------------------------------------------

def _cli(root, module, *args):
    cmd = [sys.executable, "-m", module, "-c", os.path.join(root, "grid.cfg"),
           "--device", "cpu", *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train CLI on a 32x32 grid (level 0 at the block-sparse cutoff, so
    sp shards it) in one process and with -p data_parallel 2 -p
    seq_parallel 2 (four local gloo ranks started by the CLI)."""
    root = str(tmp_path_factory.mktemp("torch_parallel_cli"))
    template = W.grid_mesh(32)
    tpath = os.path.join(root, "template.obj")
    save_obj(tpath, template.v, template.f)
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(template, data_dir, n_samples=16, seed=1)
    with open(os.path.join(root, "grid.cfg"), "w") as fp:
        fp.write(f"[I/O]\nroot_dir = {data_dir}\ntemplate = {tpath}\n"
                 f"hierarchy_cache_dir = {root}/cache\n"
                 "[Model]\nn_layers = 2\ndownsampling_factors = 2, 2\n"
                 "num_conv_filters = 8, 16, 16\npolygon_order = 3, 3, 3\n"
                 "num_hidden = 16\nnum_style = 4\nbatch_size = 4\n"
                 "epoch = 1\nfolds = 2\ntest_size = 0.25\n"
                 "cheb_method = pallas\nmatmul_precision = highest\n")
    out = {"root": root, "data": data_dir}
    for tag, extra in (("single", ()), ("world", ("-p", "data_parallel", "2",
                                                  "-p", "seq_parallel",
                                                  "2"))):
        ckpt = os.path.join(root, tag)
        out[tag] = (ckpt, _cli(root, "meshvae_tpu_torch.train", "-t", "-s",
                               "-p", "checkpoint_dir", ckpt + "/", "-p",
                               "log_file", os.path.join(ckpt, "log.txt"),
                               *extra))
    return out


def test_train_cli_world_matches_single_process(cli_runs):
    """The train CLI's 2 x 2 world against one process: the history within
    the step bars, the checkpoint's params within rtol 1e-4 / atol 1e-5 (an
    epoch of Adam steps), one log (only rank 0 prints and writes it) and
    one copy of every artifact."""
    (one, _), (many, out_many) = cli_runs["single"], cli_runs["world"]
    assert sorted(os.listdir(one)) == sorted(os.listdir(many))
    assert out_many.count("model type:") == 1
    assert sum(f"rank {r}: " in out_many for r in range(4)) == 4
    assert "backend gloo" in out_many
    for fold in (1, 2):
        with open(os.path.join(one, f"history{fold}.json")) as fp:
            h1 = json.load(fp)
        with open(os.path.join(many, f"history{fold}.json")) as fp:
            h4 = json.load(fp)
        assert len(h1) == len(h4) == 1
        for a, b in zip(h1, h4):
            for part in ("training", "validation"):
                for k, v in a[part].items():
                    np.testing.assert_allclose(b[part][k], v, rtol=1e-4,
                                               atol=1e-6,
                                               err_msg=f"{part} {k}")
        p1 = torch.load(os.path.join(one, f"checkpoint_{fold}.pt"),
                        weights_only=True)["model"]
        p4 = torch.load(os.path.join(many, f"checkpoint_{fold}.pt"),
                        weights_only=True)["model"]
        for k, v in p1.items():
            np.testing.assert_allclose(p4[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    with open(os.path.join(many, "log.txt")) as fp:
        assert fp.read().count("model type:") == 1


def test_infer_cli_world_matches_single_process(cli_runs):
    """python -m meshvae_tpu_torch.infer on the single run's fold-1
    checkpoint, in one process and in a 2 x 2 world: the same pred.json,
    errors within 1e-5 relative, and the same .obj triples written once."""
    root, ckpt = cli_runs["root"], cli_runs["single"][0]
    outs = {}
    for tag, extra in (("one", ()), ("world", ("-p", "data_parallel", "2",
                                               "-p", "seq_parallel", "2"))):
        outs[tag] = os.path.join(root, f"infer_{tag}")
        _cli(root, "meshvae_tpu_torch.infer", "-d", cli_runs["data"], "-o",
             outs[tag], "-n", "1", "-p", "checkpoint_dir", ckpt, *extra)
    read = lambda tag, name: json.load(open(os.path.join(outs[tag], name)))
    assert read("one", "pred.json") == read("world", "pred.json")
    one, world = read("one", "inference.json"), read("world",
                                                     "inference.json")
    assert list(one) == list(world)
    for name, r in one.items():
        for key in ("mean", "max"):
            np.testing.assert_allclose(
                world[name]["reconstruction_error"][key],
                r["reconstruction_error"][key], rtol=1e-5)
    assert (sorted(os.listdir(os.path.join(outs["one"], "sex_change")))
            == sorted(os.listdir(os.path.join(outs["world"], "sex_change"))))


# --- config, preflight, backend ------------------------------------------

@pytest.fixture
def init_calls(monkeypatch):
    """init_process_group and make_world recorded instead of run."""
    calls = []
    monkeypatch.setattr(sharding.dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            dict(kw, backend=backend)))
    monkeypatch.setattr(sharding, "make_world",
                        lambda dp, sp, device, backend: sharding.World(
                            dp, sp, calls[-1]["rank"], device, backend,
                            None, None, None, {}))
    return calls


def test_multihost_off_by_default(init_calls):
    assert port_driver.maybe_init_multihost({"multihost": False}) is None
    assert init_calls == []


def test_multihost_auto_detect(init_calls, monkeypatch):
    """Coordinator fields unset: env:// (a launcher's RANK, WORLD_SIZE,
    MASTER_ADDR/PORT), as jax.distributed.initialize auto-detects."""
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    world = port_driver.maybe_init_multihost(
        {"multihost": True, "coordinator_address": "", "num_processes": 0,
         "process_id": -1, "data_parallel": 2, "seq_parallel": 2}, "cpu")
    [call] = init_calls
    assert call["init_method"] == "env://"
    assert (call["rank"], call["world_size"], call["backend"]) == (3, 4,
                                                                   "gloo")
    assert (world.dp_rank, world.sp_rank) == (1, 1)


def test_multihost_env_world_size_must_match(init_calls, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="WORLD_SIZE 8"):
        port_driver.maybe_init_multihost(
            {"multihost": True, "data_parallel": 2, "seq_parallel": 2},
            "cpu")
    assert init_calls == []


def test_multihost_explicit(init_calls):
    world = port_driver.maybe_init_multihost(
        {"multihost": True, "coordinator_address": "10.0.0.1:1234",
         "num_processes": 4, "process_id": 2, "data_parallel": 4,
         "seq_parallel": 1}, "cpu")
    [call] = init_calls
    assert call["init_method"] == "tcp://10.0.0.1:1234"
    assert (call["rank"], call["world_size"]) == (2, 4)
    assert (world.dp_rank, world.sp_rank) == (2, 0)


def test_multihost_config_keys_parse(tmp_path):
    from meshvae_tpu_torch.config import read_config

    cfg = tmp_path / "mh.cfg"
    cfg.write_text("[Input Output]\nmultihost = true\n"
                   "coordinator_address = host:9999\n"
                   "num_processes = 8\nprocess_id = 3\n"
                   "data_parallel = 4\nseq_parallel = 2\n")
    config = read_config(str(cfg))
    assert config["multihost"] is True
    assert config["coordinator_address"] == "host:9999"
    assert (config["num_processes"], config["process_id"]) == (8, 3)
    assert (config["data_parallel"], config["seq_parallel"]) == (4, 2)


def test_check_supported_takes_the_distribution_keys():
    """The distribution keys name a world (driver.names_world) for any
    model type: nothing refuses them since the classifiers run in a world
    (tests/test_torch_world_classifiers.py)."""
    for config in ({"data_parallel": 2, "seq_parallel": 2, "multihost": True},
                   {"data_parallel": 2}, {"seq_parallel": 2},
                   {"multihost": True, "type": "joint_VAE"}):
        assert port_driver.names_world(config), config
    assert not port_driver.names_world({"data_parallel": 1,
                                        "seq_parallel": 1, "multihost": False})


@pytest.mark.parametrize("config,device,cards,match", [
    ({"batch_size": 6, "data_parallel": 4}, "cpu", None, "divisible"),
    ({"data_parallel": 0}, "cpu", None, ">= 1"),
    ({"batch_size": 8, "data_parallel": 2, "seq_parallel": 2}, "cuda", 2,
     "4 local rank"),
    ({"batch_size": 8, "data_parallel": 2, "multihost": True,
      "coordinator_address": "h:1", "num_processes": 4}, "cpu", None,
     "num_processes"),
])
def test_validate_errors(config, device, cards, match):
    with pytest.raises(validate.ConfigError, match=match):
        validate.validate_config(config, device, n_devices=cards)


def test_validate_accepts():
    validate.validate_config({"batch_size": 8, "data_parallel": 2,
                              "seq_parallel": 2}, "cpu")
    validate.validate_config({"batch_size": 8, "data_parallel": 2,
                              "seq_parallel": 2}, "cuda", n_devices=4)


def test_backend_rule_on_the_cpu():
    backend, dev = sharding.choose_backend("cpu", 3)
    assert (backend, dev.type) == ("gloo", "cpu")


def test_shard_batch_and_rows():
    batch = {"x": np.arange(8 * 2).reshape(8, 2), "mask": np.ones(8)}
    world = sharding.World(2, 2, 3, torch.device("cpu"), "gloo", None,
                           None, None, {})
    rows = sharding.shard_batch(batch, world)
    np.testing.assert_array_equal(rows["x"], batch["x"][4:])
    assert sharding.shard_batch(batch, None) is batch


# --- on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16x3", "bf16"])
def test_cuda_shard_products_equal_unsharded(laplacians, mode):
    """The kernel at the shard shapes (sp 2 and 4, template5k L0) against
    its twin, and its stacked rows bit-equal to the unsharded kernel in
    fp32 and bf16 (within 1e-5 of max|y| in bf16x3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = bsr_spmm.MODE_DTYPE[mode]
    bsr = block_sparse.to_block_sparse(laplacians["t5k_L0"], "cuda",
                                       dtype=dt)
    for sp in (2, 4):
        shards = bsr_shard.shard_block_sparse_all(bsr, sp)
        n_glob = shards[0].n_pad_global
        x = torch.zeros(n_glob, 256, device="cuda", dtype=dt)
        x[:bsr.n_pad] = torch.randn(bsr.n_pad, 256, device="cuda").to(dt)
        tp = torch.randn(n_glob, 256, device="cuda").to(dt)
        full = bsr_spmm.bsr_grouped_spmm(bsr, x[:bsr.n_pad], mode, 2.0,
                                         t_plus=tp[:bsr.n_pad])
        parts = []
        for s in shards:
            seed = tp[s.row0:s.row0 + s.rows_local]
            y = bsr_spmm.bsr_grouped_spmm(s.op, x, mode, 2.0, t_plus=seed)
            ref = bsr_spmm.bsr_grouped_spmm_reference(s.op, x, mode, 2.0,
                                                      t_plus=seed)
            bar = 1e-5 if mode != "bf16" else ULP
            assert ((y.float() - ref.float()).abs().max()
                    <= bar * ref.float().abs().max())
            parts.append(y)
        got = torch.cat(parts)[:bsr.n_pad]
        if mode == "bf16x3":
            assert ((got - full).abs().max() / full.abs().max()) < 1e-5
        else:
            assert torch.equal(got, full)
