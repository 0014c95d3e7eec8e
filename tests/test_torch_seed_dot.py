"""The lazy mix-cotangent seed (TPU kernel #4b, ``t_plus_dot``) in
meshvae_tpu_torch against the JAX package, whose Pallas kernels run in
interpret mode:

  * the twin of ``bsr_grouped_spmm(t_plus_dot=)`` against
    ``_bsr_matmul_impl(..., t_plus_dot=)`` (the in-kernel ``_seed_dot_fn``)
    in fp32 (1e-5 of max|y|) and bf16 (one bf16 ulp, 2^-8 max|y|; both
    round once), f in {8, 16, 32, 128}, with and without t_prev, and the
    eager fallback (mode bf16x3, f not dividing the panel);
  * ``cheb_conv`` gradients with ``FUSED_SEED_DOT`` on in both packages
    against ``_basis_mix``'s lazy branch, and "high" running exactly the
    flag-off backward;
  * one train step at a scaled20k-like config (K = 10, fp32 highest, a
    batch that makes the mixes square) with both flags on, at
    tests/test_torch_train.py's bars;
  * ``python -m meshvae_tpu_torch.train`` with files/scaled20k.cfg's own
    settings on a grid template, the flag on."""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.ops.block_sparse import to_block_sparse as jax_to_bsr
from meshvae_tpu.ops.cheb import cheb_conv as jax_cheb_conv
from meshvae_tpu.train import loop as jax_loop

from meshvae_tpu_torch.config import read_config
from meshvae_tpu_torch.data import generate_synthetic_dataset
from meshvae_tpu_torch.mesh import TriMesh, save_obj, vertex_adjacency
from meshvae_tpu_torch.ops import bsr_spmm, graph
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops.block_sparse import to_block_sparse
from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm_reference
from meshvae_tpu_torch.ops.cheb import cheb_conv
from meshvae_tpu_torch.train import Trainer, unpack_metrics
from meshvae_tpu_torch.train.__main__ import main as train_main

from conftest import make_grid_mesh
from torch_port_utils import (FedNoise, feed_noise, grid_hierarchy,
                              paired_models, write_requests)

BF = torch.bfloat16
ULP = 2.0 ** -8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_PREC = {"fp32": jax.lax.Precision.HIGHEST,
             "bf16x3": jax.lax.Precision.HIGH,
             "bf16": jax.lax.Precision.DEFAULT}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


def _flags(monkeypatch, on: bool):
    monkeypatch.setattr(pc, "FUSED_SEED_DOT", on)
    monkeypatch.setattr(port_cheb, "FUSED_SEED_DOT", on)


def _spy_seed_dot(monkeypatch):
    """Record, per bsr_grouped_spmm call made by ops/cheb.py, whether it
    passed the lazy seed."""
    calls = []
    real = port_cheb.bsr_grouped_spmm

    def spied(*args, **kwargs):
        calls.append(kwargs.get("t_plus_dot") is not None)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_cheb, "bsr_grouped_spmm", spied)
    return calls


def _spy_jax_seed_dot(monkeypatch):
    """Record, per call of the JAX kernels' _seed_dot_fn, whether it got
    the lazy seed's operands (pd not None)."""
    seen = []
    real = pc._seed_dot_fn

    def spied(pd, precision):
        seen.append(pd is not None)
        return real(pd, precision)

    monkeypatch.setattr(pc, "_seed_dot_fn", spied)
    return seen


@pytest.fixture(scope="module")
def grid_lap():
    mesh = make_grid_mesh(32, jitter=0.05)
    return graph.normalized_neg_adjacency(
        vertex_adjacency(mesh.num_vertices, mesh.f))


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("f", [8, 16, 32, 128])
@pytest.mark.parametrize("t_prev,alpha", [(False, 2.0), (True, 1.0)])
def test_twin_seed_dot_matches_jax(monkeypatch, grid_lap, mode, f, t_prev,
                                   alpha):
    """y = alpha L x + gm @ kron(I, wt) [- t_prev] at C = 256 (f = 128: an
    item spans two 64-column tiles of the CUDA kernel), against the grouped
    TPU kernel's lazy seed; the JAX side must take the in-kernel seed."""
    dt, jdt = ((torch.float32, jnp.float32) if mode == "fp32"
               else (BF, jnp.bfloat16))
    ref_bsr = jax_to_bsr(grid_lap, dtype=jdt)
    port_bsr = to_block_sparse(grid_lap, "cpu", dtype=dt)
    seen = _spy_jax_seed_dot(monkeypatch)
    rng = np.random.default_rng(f)
    c = 256
    x, gm = (rng.standard_normal((port_bsr.n_pad, c)).astype(np.float32)
             for _ in range(2))
    wt = (0.3 * rng.standard_normal((f, f))).astype(np.float32)
    tm = rng.standard_normal((port_bsr.n_pad, c)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dt)
    j = lambda a: jnp.asarray(a).astype(jdt)
    got = bsr_grouped_spmm_reference(
        port_bsr, t(x), mode, alpha, t_prev=t(tm) if t_prev else None,
        t_plus_dot=(t(gm), t(wt)))
    want = pc._bsr_matmul_impl(
        ref_bsr, j(x), _JAX_PREC[mode], alpha=alpha,
        t_prev=j(tm) if t_prev else None, t_plus_dot=(j(gm), j(wt)))
    assert seen and all(seen)
    assert got.dtype == dt
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    bar = 1e-5 if mode == "fp32" else ULP
    assert np.abs(got - want).max() <= bar * np.abs(want).max()
    # the seed really is the mix cotangent: the same as an eager t_plus
    eager = np.einsum("rie,eo->rio", gm.reshape(-1, c // f, f), wt)
    plain = bsr_grouped_spmm_reference(
        port_bsr, t(x), mode, alpha, t_prev=t(tm) if t_prev else None,
        t_plus=torch.from_numpy(eager.reshape(-1, c)).to(dt))
    assert np.abs(plain.float().numpy() - got).max() <= (
        2 * bar * np.abs(want).max())


@pytest.mark.parametrize("mode,f,c", [("bf16x3", 16, 256),
                                      ("fp32", 24, 384)])
def test_twin_seed_dot_eager_fallback(monkeypatch, grid_lap, mode, f, c):
    """Mode bf16x3 (HIGH's pre-split kernels) and an f that does not
    divide the 128-column panel compute the seed eagerly and pass it as
    t_plus, in both packages (pallas_cheb.py:669-677)."""
    ref_bsr = jax_to_bsr(grid_lap)
    port_bsr = to_block_sparse(grid_lap, "cpu")
    seen = _spy_jax_seed_dot(monkeypatch)
    rng = np.random.default_rng(5)
    x, gm, tm = (rng.standard_normal((port_bsr.n_pad, c)).astype(np.float32)
                 for _ in range(3))
    wt = (0.3 * rng.standard_normal((f, f))).astype(np.float32)
    t = torch.from_numpy
    got = bsr_grouped_spmm_reference(port_bsr, t(x), mode, 2.0, t_prev=t(tm),
                                     t_plus_dot=(t(gm), t(wt))).numpy()
    want = np.asarray(pc._bsr_matmul_impl(
        ref_bsr, jnp.asarray(x), _JAX_PREC[mode], alpha=2.0,
        t_prev=jnp.asarray(tm), t_plus_dot=(jnp.asarray(gm),
                                            jnp.asarray(wt))))
    assert not any(seen)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="exclusive"):
        bsr_grouped_spmm_reference(port_bsr, t(x), mode, t_plus=t(tm),
                                   t_plus_dot=(t(gm), t(wt)))


@pytest.fixture(scope="module")
def conv_ops():
    """A 1024-vertex grid level as BSR, fp32 and bf16, in both packages."""
    mesh = make_grid_mesh(32, jitter=0.05)
    adj = vertex_adjacency(mesh.num_vertices, mesh.f)
    return {dt: (graph.cheb_operator(adj, "cpu", bsr_min_n=1, dtype=pdt),
                 jax_graph.cheb_operator(adj, layouts=("bsr",), dtype=jdt))
            for dt, pdt, jdt in (("float32", torch.float32, jnp.float32),
                                 ("bfloat16", BF, jnp.bfloat16))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_grads_lazy_seed_match_jax(conv_ops, monkeypatch, dtype):
    """dx and dW of sum(conv(x) * g) with FUSED_SEED_DOT on in both
    packages, a square 16 -> 16 mix at B = 8 (f_pad = 16), K = 5: every
    backward kernel call carries the lazy seed, and the gradients meet
    jax.grad through _basis_mix's lazy branch within 1e-5 (fp32) or one
    bf16 ulp (bf16) of their max. The fp32 case adds the bias; in bf16
    the bias gradient is a bf16 reduction outside the kernel path (see
    tests/test_torch_bf16.py), so it is left out."""
    _flags(monkeypatch, True)
    port_op, jax_op = conv_ops[dtype]
    fp32 = dtype == "float32"
    jdt, pdt = (jnp.float32, torch.float32) if fp32 else (jnp.bfloat16, BF)
    precision = "highest" if fp32 else "default"
    n, k, b, f = port_op.n, 5, 8, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, n, f)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f, f))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    g = rng.standard_normal((b, n, f)).astype(np.float32)
    seen = _spy_jax_seed_dot(monkeypatch)

    def jax_loss(x_, w_, b_):
        out = jax_cheb_conv(x_.astype(jdt), jax_op, w_.astype(jdt),
                            b_.astype(jdt) if fp32 else None,
                            method="pallas", precision=precision)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    assert any(seen)
    calls = _spy_seed_dot(monkeypatch)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, bias))
    out = cheb_conv(xt.to(pdt), port_op, wt.to(pdt),
                    bt.to(pdt) if fp32 else None, precision=precision)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert calls == [False] * (k - 1) + [True] * (k - 1)
    bar = 1e-5 if fp32 else ULP
    for name, got, ref in zip(("dx", "dW", "dbias"), (xt, wt, bt), want):
        if got.grad is None:
            continue
        ref = np.asarray(ref, np.float32)
        delta = np.abs(got.grad.numpy() - ref).max()
        print(f"{dtype} {name}: {delta:.3e} of max {np.abs(ref).max():.3e}")
        assert delta <= bar * np.abs(ref).max(), (name, delta)


def test_high_ignores_the_flag(conv_ops, monkeypatch):
    """At "high" (mode bf16x3) the flag changes nothing: the backward is
    the eager one, bit for bit."""
    port_op = conv_ops["float32"][0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, port_op.n, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 16, 16))).astype(np.float32)

    def run(flag):
        _flags(monkeypatch, flag)
        calls = _spy_seed_dot(monkeypatch)
        xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
        (cheb_conv(xt, port_op, wt, None, precision="high") ** 2
         ).sum().backward()
        monkeypatch.setattr(port_cheb, "bsr_grouped_spmm",
                            bsr_spmm.bsr_grouped_spmm)
        assert not any(calls)
        return xt.grad, wt.grad

    for got, want in zip(run(True), run(False)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


SCALED_ORDERS = (10,) * 5
BATCH = 16  # B * 8 = 128: f_pad = 8 = f_out on enc_1, dec_2, dec_3


def test_train_step_scaled20k_like_lazy_seed(monkeypatch, tmp_path):
    """One Trainer.train_step against _train_step_impl at K = 10, fp32
    highest, dropout 0.2 with the same masks and eps, both flags on: the
    three square block-sparse convs' backwards (enc_1, dec_2, dec_3) run
    9 lazy-seed calls each; loss rtol 1e-5, every gradient within 1e-4 of
    its layer's max|g|, params after Adam within 1e-2 lr."""
    _flags(monkeypatch, True)
    _, hier = grid_hierarchy()
    template = TriMesh(hier.vertices[0], hier.faces[0])
    from meshvae_tpu_torch.data import BatchIterator, MeshDataset, list_meshes

    cfg = {"root_dir": write_requests(template, str(tmp_path), n=16),
           "checkpoint_dir": str(tmp_path / "ckpt")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    batch = next(iter(BatchIterator(ds, BATCH)))
    jmodel, jops, params, pmodel, pops = paired_models(
        hier, "highest", orders=SCALED_ORDERS)
    config = {"num_classes": 2, "learning_rate": 1e-3, "weight_decay": 5e-4}
    jtrainer = jax_loop.Trainer(jmodel, jops, config)
    ptrainer = Trainer(pmodel, pops, config, device="cpu")
    noise = FedNoise(BATCH, pmodel.cfg.num_hidden,
                     pmodel.cfg.coarse_verts * pmodel.cfg.filters[-1],
                     pmodel.cfg.latent)
    feed_noise(monkeypatch, noise)
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("x", "label", "r", "s", "m", "mask")}
    jparams, _, jmetrics = jax.jit(jtrainer._train_step_impl)(
        params, jtrainer.init_opt_state(params), jbatch, jax.random.key(0),
        jnp.asarray(ds.mean), jnp.asarray(ds.std), jops)
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer._forward_loss(p, jbatch, None, True, jops),
        has_aux=True))(params)
    noise.i = 0
    calls = _spy_seed_dot(monkeypatch)
    packed = ptrainer.train_step(ptrainer.to_device(batch), torch.Generator(),
                                 *ptrainer.norm_to_device(ds.mean, ds.std))
    assert noise.i == 4
    assert sum(calls) == 3 * 9, calls
    got, want = unpack_metrics(packed), unpack_metrics(jmetrics)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    from meshvae_tpu_torch.models import params_from_flax

    named = lambda tree: {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}
    grads, after = named(jgrads), named(jparams)
    for name, p in ptrainer.model.named_parameters():
        layer = name.rsplit(".", 1)[0]
        scale = max(np.abs(v).max() for k, v in grads.items()
                    if k.rsplit(".", 1)[0] == layer)
        assert np.abs(p.grad.numpy() - grads[name]).max() <= 1e-4 * scale, (
            name)
        assert np.abs(p.detach().numpy() - after[name]).max() <= 1e-5, name


def test_cli_scaled20k_settings_on_a_grid(monkeypatch, tmp_path):
    """``python -m meshvae_tpu_torch.train -c files/scaled20k.cfg -t -s``
    with the flag on and overrides for paths, folds and epochs only: fp32
    at highest, K = 10, filters 16/16/16/32/32, hidden 512, batch 64 on a
    32x32 grid template (1024 -> 256 -> 64 -> 16 -> 4 vertices; level 0
    block-sparse). Two folds train and test with finite results, and the
    square convs' backwards take the lazy seed."""
    _flags(monkeypatch, True)
    calls = _spy_seed_dot(monkeypatch)
    mesh = make_grid_mesh(32, jitter=0.05)
    template = str(tmp_path / "template.obj")
    save_obj(template, mesh.v, mesh.f)
    data = str(tmp_path / "data")
    generate_synthetic_dataset(TriMesh(mesh.v, mesh.f), data, n_samples=12,
                               seed=2)
    ckpt = str(tmp_path / "ckpt")
    cfg_path = os.path.join(REPO, "files", "scaled20k.cfg")
    config = read_config(cfg_path)
    assert (config["polygon_order"], config["batch_size"],
            config["matmul_precision"], config["num_hidden"]) == (
                [10] * 5, 64, "highest", 512)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_main([
            "-c", cfg_path, "-t", "-s", "-p", "template", template,
            "-p", "root_dir", data, "-p", "checkpoint_dir", ckpt,
            "-p", "log_file", os.path.join(ckpt, "log.txt"),
            "-p", "hierarchy_cache_dir", str(tmp_path / "cache"),
            "-p", "folds", "2", "-p", "epoch", "1",
            "--device", "cpu"]) == 0
    stdout = out.getvalue()
    assert "compute dtype: float32 matmul precision: highest" in stdout
    assert len([l for l in stdout.splitlines() if "test loss" in l]) == 2
    for fold in (1, 2):
        with open(os.path.join(ckpt, f"history{fold}.json")) as fp:
            hist = json.load(fp)
        assert [h["epoch"] for h in hist] == [1]
        assert all(np.isfinite(v) for v in hist[0]["training"].values())
    # level 0 is the only block-sparse level: cheb_dec_3 (16 -> 16) is
    # square, cheb_enc_0's input is data; one train step per fold
    assert sum(calls) == 2 * 9, sum(calls)
