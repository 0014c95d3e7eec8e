"""meshvae_tpu_torch.ops.cheb.cheb_conv and pool_apply against the JAX
package: the dense path, the block-sparse path (JAX's Pallas kernel in
interpret mode), the active_n corner of the embedded final-conv operator,
at matmul_precision highest and high; atol 1e-5 on O(1) outputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.ops import graph as jax_graph
from meshvae_tpu.ops.cheb import cheb_conv as jax_cheb_conv
from meshvae_tpu.ops.pool import pool_apply as jax_pool_apply

from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, vertex_adjacency
from meshvae_tpu_torch.ops import graph
from meshvae_tpu_torch.ops.cheb import cheb_conv, resolve_precision
from meshvae_tpu_torch.ops.pool import pool_apply

from conftest import make_grid_mesh

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def grid():
    mesh = make_grid_mesh(32, jitter=0.05)  # 1024 verts, 8 block-rows
    return mesh, vertex_adjacency(mesh.num_vertices, mesh.f)


def _inputs(n, b=4, f_in=3, f_out=16, k=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, f_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f_in, f_out))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f_out)).astype(np.float32)
    return x, w, bias


def _both(port_op, jax_op, method, precision, n, **kw):
    x, w, bias = _inputs(n, **kw)
    got = cheb_conv(torch.from_numpy(x), port_op, torch.from_numpy(w),
                    torch.from_numpy(bias), precision=precision).numpy()
    ref = np.asarray(jax_cheb_conv(jnp.asarray(x), jax_op, jnp.asarray(w),
                                   jnp.asarray(bias), method=method,
                                   precision=precision))
    return got, ref


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_dense_matches_jax(grid, precision):
    _, adj = grid
    port_op = graph.cheb_operator(adj, "cpu", bsr_min_n=None)
    jax_op = jax_graph.cheb_operator(adj, layouts=("dense",))
    got, ref = _both(port_op, jax_op, "dense", precision, adj.shape[0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("b,f_in", [(4, 3), (2, 16)])
def test_bsr_matches_pallas(grid, precision, b, f_in):
    """[N_pad, B, F_pad] layout: F_in = 3 pads to 32 at B = 4 (C = 128);
    B = 2, F_in = 16 pads to 64."""
    _, adj = grid
    port_op = graph.cheb_operator(adj, "cpu", bsr_min_n=1)
    assert port_op.bsr is not None
    jax_op = jax_graph.cheb_operator(adj, layouts=("bsr",))
    got, ref = _both(port_op, jax_op, "pallas", precision, adj.shape[0],
                     b=b, f_in=f_in)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", ["dense", "bsr"])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_active_n_corner_matches_jax(precision, layout):
    """The embedded final-conv operator: the recurrence on the coarse
    corner, one closed-form product on the rest (K = 6 covers T_k(0) =
    1, 0, -1, 0, 1, 0)."""
    mesh = make_grid_mesh(16, jitter=0.05)
    hier = build_hierarchy(TriMesh(mesh.v, mesh.f), [2])  # 256 -> 128
    coarse = hier.adjacency[-1]
    port_op = graph.embed_operator(coarse, 256, "cpu",
                                   bsr_min_n=1 if layout == "bsr" else None)
    jax_op = jax_graph.embed_operator(coarse, 256, layouts=(layout,))
    assert port_op.active_n == jax_op.active_n == 128 and port_op.n == 256
    got, ref = _both(port_op, jax_op,
                     "pallas" if layout == "bsr" else "dense", precision, 256)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_pool_matches_jax():
    """Down-pools are one-hot gathers, up-pools weighted 3-entry gathers."""
    mesh = make_grid_mesh(12, jitter=0.05)
    hier = build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2])
    rng = np.random.default_rng(1)
    for mats in (hier.downsample, hier.upsample):
        for mat in mats:
            port = graph.pool_operator(mat, "cpu")
            ref = jax_graph.pool_operator(mat, pool_method="gather")
            x = rng.standard_normal((3, mat.shape[1], 5)).astype(np.float32)
            got = pool_apply(torch.from_numpy(x), port).numpy()
            want = np.asarray(jax_pool_apply(jnp.asarray(x), ref))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got, np.einsum("mn,bnf->bmf",
                                                      mat.toarray(), x),
                                       rtol=1e-5, atol=1e-5)


def test_resolve_precision():
    assert resolve_precision(None) == resolve_precision("") == "highest"
    assert resolve_precision("HIGH") == "high"
    with pytest.raises(ValueError, match="not supported"):
        resolve_precision("default")
