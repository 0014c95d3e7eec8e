"""Backward passes of meshvae_tpu_torch.ops against the JAX package: the
pool transposes (built layouts, the block-sparse and gather backward vs
jax.grad of pool_apply, atol 2e-5), the Chebyshev conv gradients (BSR,
dense and the active_n corner, vs jax.grad of cheb_conv(method="pallas")
with the Pallas kernel in interpret mode), and the block-sparse twin held
against the TPU kernels it also stands in for: the column-major kernels
#7/#8 (``_colmajor_matmul``) and the per-block kernels #5/#6."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.ops.block_sparse import to_block_sparse as jax_to_bsr
from meshvae_tpu.ops.cheb import cheb_conv as jax_cheb_conv
from meshvae_tpu.ops.pool import pool_apply as jax_pool_apply

from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, vertex_adjacency
from meshvae_tpu_torch.ops import graph
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops import pool as port_pool
from meshvae_tpu_torch.ops.block_sparse import to_block_sparse
from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm_reference
from meshvae_tpu_torch.ops.cheb import cheb_conv
from meshvae_tpu_torch.ops.pool import pool_apply

from conftest import make_grid_mesh
from torch_port_utils import count_kernel_calls, grid_hierarchy

TGRAD = 6  # grid up-pool fan-ins 9/7/7/5: three block-sparse P^T, one ELL
_PRECISIONS = {"fp32": jax.lax.Precision.HIGHEST,
               "bf16x3": jax.lax.Precision.HIGH}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """(upsample + downsample matrices, port operators, JAX operators)
    built at the fan-in cutoff TGRAD on both sides."""
    _, hier = grid_hierarchy()
    mats = list(hier.upsample) + list(hier.downsample)
    old = jax_graph.TGRAD_ELL_MAX, graph.TGRAD_ELL_MAX
    jax_graph.TGRAD_ELL_MAX = graph.TGRAD_ELL_MAX = TGRAD
    try:
        port = [graph.pool_operator(m, "cpu") for m in mats]
        ref = [jax_graph.pool_operator(m, pool_method="gather") for m in mats]
    finally:
        jax_graph.TGRAD_ELL_MAX, graph.TGRAD_ELL_MAX = old
    return mats, port, ref


def test_pool_transposes_match_jax(pools):
    """t_idx / t_w array for array; t_bsr exactly where JAX builds one
    (fan-in above the cutoff), with the same blocks and row groups."""
    mats, port, ref = pools
    assert [p.t_bsr is not None for p in port] == [True] * 3 + [False] * 5
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.t_idx.numpy(), np.asarray(r.t_idx))
        np.testing.assert_array_equal(p.t_w.numpy(), np.asarray(r.t_w))
        assert (p.t_bsr is None) == (r.t_bsr is None)
        if p.t_bsr is not None:
            assert (p.t_bsr.n_pad, p.t_bsr.n_pad_cols, p.t_bsr.g_width) == (
                r.t_bsr.n_pad, r.t_bsr.n_pad_cols, r.t_bsr.g_width)
            np.testing.assert_array_equal(p.t_bsr.blocks.numpy(),
                                          np.asarray(r.t_bsr.blocks))
            np.testing.assert_array_equal(p.t_bsr.g_idx.numpy(),
                                          np.asarray(r.t_bsr.g_idx))


@pytest.mark.parametrize("b,f,branch", [(16, 8, "bsr"), (2, 5, "ell")])
def test_pool_backward_matches_jax(pools, monkeypatch, b, f, branch):
    """dx = P^T g for every pool: B * F = 128 takes the kernel on the
    block-sparse transposes (fp32 twin here) and gathers elsewhere; below
    one panel every pool gathers. atol 2e-5 (test_pallas.py's bar)."""
    mats, port, ref = pools
    calls = count_kernel_calls(monkeypatch, pool=port_pool)
    rng = np.random.default_rng(3)
    for mat, p, r in zip(mats, port, ref):
        x = rng.standard_normal((b, mat.shape[1], f)).astype(np.float32)
        g = rng.standard_normal((b, mat.shape[0], f)).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_(True)
        (pool_apply(xt, p) * torch.from_numpy(g)).sum().backward()
        want = jax.grad(lambda a: jnp.sum(jax_pool_apply(a, r)
                                          * jnp.asarray(g)))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(
            xt.grad.numpy(), np.einsum("mn,bmf->bnf", mat.toarray(), g),
            rtol=0, atol=2e-5)
    assert calls == ([("pool", "fp32")] * 3 if branch == "bsr" else [])


@pytest.fixture(scope="module")
def conv_ops():
    """A 1024-vertex grid level as BSR and dense, and the embedded
    final-conv operator (a 256-vertex corner of a 512 index space)."""
    mesh = make_grid_mesh(32, jitter=0.05)
    adj = vertex_adjacency(mesh.num_vertices, mesh.f)
    small = make_grid_mesh(16, jitter=0.05)
    coarse = build_hierarchy(TriMesh(small.v, small.f), [2]).adjacency[0]
    return {
        "bsr": (graph.cheb_operator(adj, "cpu", bsr_min_n=1),
                jax_graph.cheb_operator(adj, layouts=("bsr",)), "pallas"),
        "dense": (graph.cheb_operator(adj, "cpu", bsr_min_n=None),
                  jax_graph.cheb_operator(adj, layouts=("dense",)), "dense"),
        "corner": (graph.embed_operator(coarse, 512, "cpu", bsr_min_n=1),
                   jax_graph.embed_operator(coarse, 512, layouts=("bsr",)),
                   "pallas"),
    }


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("layout", ["bsr", "dense", "corner"])
def test_cheb_conv_grads_match_jax(conv_ops, monkeypatch, layout, precision):
    """dx, dW and dbias of sum(conv(x) * g) against jax.grad: max |delta| <=
    1e-4 max |grad| at highest, 1e-3 at high. K = 4: the BSR backward
    makes K-1 kernel calls for dx (t_plus alone, then both seeds), and none
    when x needs no gradient."""
    port_op, jax_op, method = conv_ops[layout]
    n, k, b, f_in, f_out = port_op.n, 4, 4, 8, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, n, f_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f_in, f_out))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f_out)).astype(np.float32)
    g = rng.standard_normal((b, n, f_out)).astype(np.float32)

    def jax_loss(x_, w_, b_):
        out = jax_cheb_conv(x_, jax_op, w_, b_, method=method,
                            precision=precision)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    calls = count_kernel_calls(monkeypatch, cheb=port_cheb)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, bias))
    out = cheb_conv(xt, port_op, wt, bt, precision=precision)
    n_fwd = len(calls)
    (out * torch.from_numpy(g)).sum().backward()
    bar = 1e-4 if precision == "highest" else 1e-3
    for name, got, ref in zip(("dx", "dW", "dbias"), (xt, wt, bt), want):
        ref = np.asarray(ref)
        delta = np.abs(got.grad.numpy() - ref).max()
        assert delta <= bar * np.abs(ref).max(), (name, delta)
    n_kernel = (k - 1) if layout != "dense" else 0
    assert n_fwd == n_kernel and len(calls) == 2 * n_kernel

    # the first encoder conv's case: x is data, so no dx recurrence
    del calls[:]
    wt.grad = None
    out = cheb_conv(torch.from_numpy(x), port_op, wt, bt, precision=precision)
    (out * torch.from_numpy(g)).sum().backward()
    assert len(calls) == n_kernel
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]),
                               rtol=0, atol=bar * np.abs(want[1]).max())


def _wide_rect(seed=21, shape=(300, 1500), density=0.02):
    """A random rectangular operator whose row blocks each span all 12
    column blocks: more than MAX_GROUP = 8, so the JAX BSR has no grouped
    view and _bsr_matmul_impl takes the column-major or per-block kernels."""
    return sp.random(*shape, density=density, format="csr",
                     random_state=np.random.default_rng(seed),
                     dtype=np.float32)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(pc, name)

    def spied(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(pc, name, spied)
    return calls


def _jax_vs_twin(port_bsr, ref_bsr, mode, c, seeds, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((port_bsr.n_pad_cols, c)).astype(np.float32)
    extra = {k: rng.standard_normal((port_bsr.n_pad, c)).astype(np.float32)
             for k in seeds}
    alpha = 2.0 if seeds else 1.0
    got = bsr_grouped_spmm_reference(
        port_bsr, torch.from_numpy(x), mode, alpha,
        **{k: torch.from_numpy(v) for k, v in extra.items()}).numpy()
    want = np.asarray(pc._bsr_matmul_impl(
        ref_bsr, jnp.asarray(x), _PRECISIONS[mode], alpha=alpha,
        **{k: jnp.asarray(v) for k, v in extra.items()}))
    return got, want


@pytest.mark.parametrize("c,seeds", [(128, ()), (256, ()),
                                     (256, ("t_plus", "t_prev"))])
def test_twin_matches_colmajor_kernel(monkeypatch, c, seeds):
    """TPU kernel #7 (_make_colmajor_kernel via _colmajor_matmul, f32 at
    HIGHEST): the pool-backward P^T of config 1's two finest up-pools,
    whose rows span more than 8 column blocks. The port runs it as
    bsr_grouped_spmm[fp32] (any G); its twin must equal the TPU kernel's
    output within 1e-5."""
    monkeypatch.setattr(pc, "FORCE_COLMAJOR", True)
    mat = _wide_rect()
    ref_bsr = jax_to_bsr(mat, allow_rect=True)
    port_bsr = to_block_sparse(mat, "cpu", allow_rect=True)
    assert ref_bsr.g_idx is None and port_bsr.g_width == 12
    calls = _spy(monkeypatch, "_make_colmajor_kernel")
    got, want = _jax_vs_twin(port_bsr, ref_bsr, "fp32", c, seeds)
    assert calls == ["_make_colmajor_kernel"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["_make_colmajor_kernel_bf16x3",
                                    "_make_spmm_kernel",
                                    "_make_spmm_kernel_bf16x3"])
def test_twin_matches_other_tpu_kernels(monkeypatch, kernel):
    """The remaining single-operator TPU kernels, each forced on the
    JAX side and held against the twin in the matching mode within 1e-5:
    #8, the column-major kernel's HIGH (bf16x3) form, on the wide-row
    operator; #5 / #6, the per-block row-major kernels (GROUPED off and
    no column-major budget), f32 and bf16x3, on a 1024-vertex grid
    Laplacian, with both seeds."""
    if kernel == "_make_colmajor_kernel_bf16x3":
        monkeypatch.setattr(pc, "FORCE_COLMAJOR", True)
        mat, seeds = _wide_rect(seed=5), ()
        ref_bsr = jax_to_bsr(mat, allow_rect=True)
        port_bsr = to_block_sparse(mat, "cpu", allow_rect=True)
    else:
        monkeypatch.setattr(pc, "GROUPED", False)
        monkeypatch.setattr(pc, "COLMAJOR_VMEM_BUDGET", 0)
        mesh = make_grid_mesh(32, jitter=0.05)
        mat = graph.normalized_neg_adjacency(
            vertex_adjacency(mesh.num_vertices, mesh.f))
        seeds = ("t_plus", "t_prev")
        ref_bsr = jax_to_bsr(mat)
        port_bsr = to_block_sparse(mat, "cpu")
    mode = "bf16x3" if kernel.endswith("bf16x3") else "fp32"
    calls = _spy(monkeypatch, kernel)
    got, want = _jax_vs_twin(port_bsr, ref_bsr, mode, 256, seeds, seed=4)
    assert calls == [kernel]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
