"""meshvae_tpu_torch operators and the block-sparse SpMM twin against the
JAX package: operator layouts array for array, and the kernel's plain
PyTorch twin against pallas_cheb._bsr_matmul_impl run in interpret mode."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.mesh.hierarchy import MeshHierarchy as JaxHierarchy
from meshvae_tpu.models.operators import build_operators as jax_build_ops
from meshvae_tpu.ops.block_sparse import to_block_sparse as jax_to_bsr

from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, vertex_adjacency
from meshvae_tpu_torch.models import build_operators
from meshvae_tpu_torch.ops.block_sparse import (block_sparse_arrays,
                                                bsr_to_dense, to_block_sparse)
from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                            bsr_grouped_spmm_reference)
from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

from conftest import make_grid_mesh

BSR_MIN_N = 200  # low enough that every level of the 1024-vertex grid is BSR


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)
    monkeypatch.setattr(jax_graph, "PALLAS_MIN_N", BSR_MIN_N)


@pytest.fixture(scope="module")
def grid_hier():
    mesh = make_grid_mesh(32, jitter=0.05)  # 1024 verts -> 8 block-rows
    return build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2])


def _jax_hier(h):
    return JaxHierarchy(h.vertices, h.faces, h.adjacency, h.downsample,
                        h.upsample)


def _assert_same_bsr(port, ref):
    assert (port.n, port.n_pad, port.n_pad_cols, port.g_width) == (
        ref.n, ref.n_pad, ref.n_pad_cols, ref.g_width)
    np.testing.assert_array_equal(port.blocks.numpy(), np.asarray(ref.blocks))
    for name in ("block_row", "block_col", "g_idx", "g_bcol"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("final", ["reference_quirk", "finest"])
def test_build_operators_matches_jax(grid_hier, final):
    port = build_operators(grid_hier, "cpu", cheb_method="pallas",
                           final_conv_adjacency=final, bsr_min_n=BSR_MIN_N)
    ref = jax_build_ops(_jax_hier(grid_hier), cheb_method="pallas",
                        pool_method="gather", final_conv_adjacency=final)
    assert port.num_nodes == ref.num_nodes
    for p, r in zip(port.lap + (port.lap_final,), ref.lap + (ref.lap_final,)):
        assert (p.n, p.active_n) == (r.n, r.active_n)
        assert p.dense is None and r.dense is None
        _assert_same_bsr(p.bsr, r.bsr)
    for p, r in zip(port.down + port.up, ref.down + ref.up):
        assert (p.n_in, p.n_out) == (r.n_in, r.n_out)
        np.testing.assert_array_equal(p.idx.numpy(), np.asarray(r.idx))
        np.testing.assert_array_equal(p.w.numpy(), np.asarray(r.w))


@pytest.mark.parametrize("method", ["pallas", "dense"])
def test_hybrid_rule_and_dense_levels(grid_hier, monkeypatch, method):
    """At the default cutoff (1024) the finest level is BSR and the coarser
    ones, with the 256-vertex final-conv corner, are dense, as in JAX;
    cheb_method="dense" keeps every level dense."""
    monkeypatch.setattr(jax_graph, "PALLAS_MIN_N", 1024)
    port = build_operators(grid_hier, "cpu", cheb_method=method)
    ref = jax_build_ops(_jax_hier(grid_hier), cheb_method=method,
                        pool_method="gather")
    assert (port.lap[0].bsr is not None) == (method == "pallas")
    for p, r in zip(port.lap + (port.lap_final,), ref.lap + (ref.lap_final,)):
        assert (p.n, p.active_n) == (r.n, r.active_n)
        if p.bsr is not None:
            _assert_same_bsr(p.bsr, r.bsr)
        else:
            np.testing.assert_array_equal(p.dense.numpy(),
                                          np.asarray(r.dense))


def test_row_padding_rule_matches_jax():
    """Row counts pad to a multiple of 8 when that adds <= 5% rows (157
    block-rows -> 160) and never on small operators (10 rows)."""
    for rows, expect in ((157, 160), (10, 10)):
        mat = sp.eye(rows * 128, format="csr") * 0.5
        port = block_sparse_arrays(mat)
        ref = jax_to_bsr(mat)
        assert port["n_pad"] == ref.n_pad == expect * 128
        np.testing.assert_array_equal(port["g_idx"], np.asarray(ref.g_idx))
        np.testing.assert_array_equal(port["g_bcol"], np.asarray(ref.g_bcol))


def test_rectangular_layout_matches_jax():
    mat = _rect_operator()
    port = to_block_sparse(mat, "cpu", allow_rect=True)
    _assert_same_bsr(port, jax_to_bsr(mat, allow_rect=True))
    np.testing.assert_allclose(bsr_to_dense(port)[:, :mat.shape[1]],
                               mat.toarray(), atol=1e-7)


def _rect_operator():
    """A banded [300, 700] operator: rectangular blocks, a row of 3 blocks
    beside rows of 2, so padded slots exist."""
    rng = np.random.default_rng(11)
    rows = np.repeat(np.arange(300), 4)
    cols = np.clip(2 * rows + rng.integers(-40, 120, rows.size), 0, 699)
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(300, 700))


@pytest.fixture(scope="module")
def wide_bsr():
    """Level-0 operator of a 32x32 grid (test_pallas.py's wide_graph)."""
    mesh = make_grid_mesh(32, jitter=0.05)
    lap = normalized_neg_adjacency(vertex_adjacency(mesh.num_vertices,
                                                    mesh.f))
    return lap, to_block_sparse(lap, "cpu"), jax_to_bsr(lap)


_CASES = [dict(alpha=1.0), dict(alpha=2.0, t_prev=True),
          dict(alpha=2.0, t_plus=True), dict(alpha=1.0, t_plus=True,
                                             t_prev=True)]
_PRECISIONS = {"fp32": jax.lax.Precision.HIGHEST,
               "bf16x3": jax.lax.Precision.HIGH}


def _run_both(port_bsr, ref_bsr, mode, case, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((port_bsr.n_pad_cols, c)).astype(np.float32)
    seeds = {k: rng.standard_normal((port_bsr.n_pad, c)).astype(np.float32)
             for k in ("t_prev", "t_plus") if case.get(k)}
    y_port = bsr_grouped_spmm_reference(
        port_bsr, torch.from_numpy(x), mode, case["alpha"],
        **{k: torch.from_numpy(v) for k, v in seeds.items()}).numpy()
    y_ref = np.asarray(pc._bsr_matmul_impl(
        ref_bsr, jnp.asarray(x), _PRECISIONS[mode], alpha=case["alpha"],
        **{k: jnp.asarray(v) for k, v in seeds.items()}))
    return y_port, y_ref


@pytest.mark.parametrize("mode", list(_PRECISIONS))
@pytest.mark.parametrize("case", range(len(_CASES)))
def test_twin_matches_pallas_kernel(wide_bsr, mode, case):
    lap, port_bsr, ref_bsr = wide_bsr
    g_idx = port_bsr.g_idx.numpy()
    assert (g_idx == port_bsr.num_blocks).any(), "graph must have pad slots"
    y_port, y_ref = _run_both(port_bsr, ref_bsr, mode, _CASES[case], 256,
                              seed=case)
    np.testing.assert_allclose(y_port, y_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", list(_PRECISIONS))
def test_twin_matches_pallas_kernel_rectangular(mode):
    mat = _rect_operator()
    port_bsr = to_block_sparse(mat, "cpu", allow_rect=True)
    ref_bsr = jax_to_bsr(mat, allow_rect=True)
    assert port_bsr.n_pad_cols > port_bsr.n_pad
    y_port, y_ref = _run_both(port_bsr, ref_bsr, mode,
                              dict(alpha=2.0, t_prev=True), 128, seed=7)
    np.testing.assert_allclose(y_port, y_ref, rtol=1e-5, atol=1e-5)


def test_twin_matches_scipy(wide_bsr):
    """fp32 twin = L @ x; bf16x3 stays within 2e-5 of it (relative to
    max |y|), the bar of test_pallas.py's HIGH check."""
    lap, port_bsr, _ = wide_bsr
    x = np.random.default_rng(5).standard_normal(
        (port_bsr.n_pad, 128)).astype(np.float32)
    exact = np.zeros_like(x)
    exact[:lap.shape[0]] = lap @ x[:lap.shape[0]]
    y32 = bsr_grouped_spmm(port_bsr, torch.from_numpy(x), "fp32").numpy()
    np.testing.assert_allclose(y32, exact, rtol=1e-5, atol=1e-5)
    y3 = bsr_grouped_spmm(port_bsr, torch.from_numpy(x), "bf16x3").numpy()
    assert np.abs(y3 - exact).max() / np.abs(exact).max() < 2e-5


def test_twin_rejects_unknown_mode(wide_bsr):
    _, port_bsr, _ = wide_bsr
    x = torch.zeros(port_bsr.n_pad, 128)
    with pytest.raises(ValueError, match="mode"):
        bsr_grouped_spmm(port_bsr, x, "tf32")
