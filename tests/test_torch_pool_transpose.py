"""The pool backward's transpose product (ops/pool_transpose.py) against
the JAX package: P^T's CSR arrays against scipy's transpose of the JAX
package's pool matrices, the twin ``pool_transpose_reference`` against
``meshvae_tpu.ops.pool._bsr_transpose_apply`` (the Pallas kernels #4, #5
and #7 in interpret mode), and the pool's input gradient through
``pool_apply`` against the VJP of the JAX ``pool_apply``. On a card, the
kernel against ``bsr_grouped_spmm`` on the block-sparse P^T (fp32, bit for
bit) and against its twin (bf16, one ulp)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.block_sparse as jax_block_sparse
import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.mesh.hierarchy import build_hierarchy as jax_build_hierarchy
from meshvae_tpu.ops.pool import _bsr_transpose_apply as jax_transpose_apply
from meshvae_tpu.ops.pool import pool_apply as jax_pool_apply

from meshvae_tpu_torch.ops import graph
from meshvae_tpu_torch.ops import pool as port_pool
from meshvae_tpu_torch.ops import pool_transpose as pt
from meshvae_tpu_torch.ops.pool import pool_apply

from conftest import make_grid_mesh

BF = torch.bfloat16
ULP = 2.0 ** -8  # one bf16 ulp of max|y| (both sides round once)
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (BF, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def up_mats():
    """The JAX package's up-pools of a 24 x 24 grid at factors 4, 4: P^T
    [144, 576] with fan-in 24 and [36, 144] with fan-in 18, both above the
    default cutoff TGRAD_ELL_MAX = 16."""
    hier = jax_build_hierarchy(make_grid_mesh(24, jitter=0.05), [4, 4])
    return list(hier.upsample)


def _wide_pool():
    """P whose transpose [300, 1500] has row blocks spanning all 12 column
    blocks (more than MAX_GROUP = 8, as config 1's two finest P^T): the
    JAX package runs it column-major (#7) or per block (#5)."""
    wide = sp.random(300, 1500, density=0.02, format="csr",
                     random_state=np.random.default_rng(21),
                     dtype=np.float32)
    return sp.csr_matrix(wide.T)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("level", [0, 1])
def test_csr_matches_scipy_transpose(up_mats, level, dtype):
    """t_ptr / t_col / t_val are scipy's CSR of P^T (columns ascending),
    the values in the operator dtype; they hold the bits of t_bsr's
    blocks, as the JAX package builds them."""
    tdt, jdt = DTYPES[dtype]
    mat = up_mats[level]
    port = graph.pool_operator(mat, "cpu", dtype=tdt)
    ref = jax_graph.pool_operator(mat, dtype=jdt, pool_method="gather")
    want = sp.csr_matrix(sp.csr_matrix(mat).T)
    want.sort_indices()
    np.testing.assert_array_equal(port.t_ptr.numpy(), want.indptr)
    np.testing.assert_array_equal(port.t_col.numpy(), want.indices)
    assert port.t_ptr.dtype == port.t_col.dtype == torch.int32
    assert port.t_val.dtype == tdt
    np.testing.assert_array_equal(
        port.t_val.float().numpy(),
        torch.from_numpy(want.data.astype(np.float32)).to(tdt).float())
    # the same bits as the JAX package's P^T blocks, entry for entry
    blocks = np.asarray(ref.t_bsr.blocks.astype(jnp.float32))
    rows = np.repeat(np.arange(port.n_in), np.diff(want.indptr))
    lookup = {(int(r), int(c)): i for i, (r, c) in enumerate(zip(
        np.asarray(ref.t_bsr.block_row), np.asarray(ref.t_bsr.block_col)))}
    got = blocks[[lookup[(int(r) // 128, int(c) // 128)]
                  for r, c in zip(rows, want.indices)],
                 rows % 128, want.indices % 128]
    np.testing.assert_array_equal(port.t_val.float().numpy(), got)


def _held(got, want, dtype):
    scale = np.abs(want).max()
    bar = (1e-5 if dtype == "fp32" else ULP) * scale
    delta = np.abs(got - want).max()
    assert delta <= bar, (delta, bar)


def _to_bf16(a: np.ndarray) -> np.ndarray:
    """a rounded once to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF).float().numpy()


# The TPU kernels that _bsr_transpose_apply reaches on a P^T, each with the
# P^T that takes it and the pallas_cheb switches that route it there.
KERNELS = {
    "grouped": ("_make_grouped_kernel", "grid1", {}),   # #4
    "perblock": ("_make_spmm_kernel", "wide",           # #5
                 {"GROUPED": False, "COLMAJOR_VMEM_BUDGET": 0}),
    "colmajor": ("_make_colmajor_kernel", "wide",       # #7
                 {"FORCE_COLMAJOR": True}),
}
B, F = 16, 8  # B * F = 128: one column panel, the least the kernel takes


@pytest.fixture(scope="module")
def jax_transposes(up_mats):
    """Per TPU kernel: P^T's matrix and g, both rounded to bf16 values so
    that one input serves both dtypes, and _bsr_transpose_apply's result
    (jitted, the kernel in interpret mode) in fp32, and in bf16 where the
    kernel rounds once, as the port's bf16 mode does (#4). #5 and #7 round
    after each of the row's blocks in bf16; there the bf16 bar is their fp32
    result rounded once."""
    out = {}
    for case, (kernel, which, switches) in KERNELS.items():
        mat = sp.csr_matrix(up_mats[1] if which == "grid1" else _wide_pool(),
                            dtype=np.float32, copy=True)
        mat.data = _to_bf16(mat.data)
        g = _to_bf16(np.random.default_rng(7).standard_normal(
            (B, mat.shape[0], F)))
        want = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pc, "INTERPRET", True)
            for name, value in switches.items():
                mp.setattr(pc, name, value)
            calls = []
            real = getattr(pc, kernel)
            mp.setattr(pc, kernel, lambda *a, **kw:
                       calls.append(kernel) or real(*a, **kw))
            for dtype in ("fp32", "bf16") if case == "grouped" else ("fp32",):
                jdt = DTYPES[dtype][1]
                ref = jax_graph.pool_operator(mat, dtype=jdt,
                                              pool_method="gather")
                apply = jax.jit(lambda a, _r=ref, _d=jdt: jax_transpose_apply(
                    a, _r.t_bsr, _r.n_in, _d))
                want[dtype] = np.asarray(
                    apply(jnp.asarray(g, jdt)).astype(jnp.float32))
                assert calls, f"{kernel} did not run"
                calls.clear()
        want.setdefault("bf16", _to_bf16(want["fp32"]))
        out[case] = (mat, g, want)
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(KERNELS))
def test_twin_matches_jax_transpose_apply(jax_transposes, case, dtype):
    """pool_transpose_reference against the JAX package's
    _bsr_transpose_apply on P^T with fan-in > 16 at B * F = 128, once per
    TPU kernel it reaches: the row-grouped #4 (the grid's coarser up-pool),
    the per-block #5 and the column-major #7 (a P^T whose row blocks span
    12 column blocks, more than MAX_GROUP = 8, as config 1's two finest).
    fp32 within 1e-5 of max|y|; bf16 within one bf16 ulp of max|y| of the
    JAX bf16 result where it rounds once (#4), else of its fp32 result
    rounded once (#5, #7)."""
    tdt = DTYPES[dtype][0]
    mat, g, want = jax_transposes[case]
    port = graph.pool_operator(mat, "cpu", dtype=tdt)
    assert port.t_ptr is not None and B * F >= port_pool.COL_PANEL
    if case != "grouped":
        assert port.t_bsr.g_width > jax_block_sparse.MAX_GROUP
    got = pt.pool_transpose_reference(
        port, torch.from_numpy(g).to(tdt)).float().numpy()
    assert got.shape == (B, port.n_in, F)
    _held(got, want[dtype], dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pool_gradient_matches_jax_vjp(up_mats, monkeypatch, dtype):
    """The input gradient of sum(pool_apply(x) * g) through the port's
    pool backward (pool_transpose on both up-pools) against jax.grad of
    the JAX pool_apply (its block-sparse backward): fp32 at atol 2e-5
    (test_torch_grad.py's bar), bf16 within one bf16 ulp of max|g|."""
    from torch_port_utils import count_kernel_calls  # imports flax

    tdt, jdt = DTYPES[dtype]
    calls = count_kernel_calls(monkeypatch, pool=port_pool)
    rng = np.random.default_rng(5)
    b, f = 16, 8
    for mat in up_mats:
        port = graph.pool_operator(mat, "cpu", dtype=tdt)
        ref = jax_graph.pool_operator(mat, dtype=jdt, pool_method="gather")
        x = rng.standard_normal((b, mat.shape[1], f)).astype(np.float32)
        g = rng.standard_normal((b, mat.shape[0], f)).astype(np.float32)
        xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
        (pool_apply(xt, port) * torch.from_numpy(g).to(tdt)).sum().backward()
        want = jax.jit(jax.grad(lambda a: jnp.sum(
            (jax_pool_apply(a, ref) * jnp.asarray(g, jdt))
            .astype(jnp.float32))))(jnp.asarray(x, jdt))
        got = xt.grad.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        else:
            _held(got, want, dtype)
    assert calls == [("pool", dtype)] * 2


def test_twin_refuses_mismatched_operands(up_mats):
    """The wrapper takes g in the operator's dtype and shape, and needs the
    CSR form (built only above the fan-in cutoff)."""
    port = graph.pool_operator(up_mats[0], "cpu")
    g = torch.zeros(2, port.n_out, 4)
    with pytest.raises(TypeError):
        pt.pool_transpose(port, g.to(BF))
    with pytest.raises(ValueError):
        pt.pool_transpose(port, g[:, 1:])
    low = graph.pool_operator(sp.identity(8, format="csr"), "cpu")
    assert low.t_ptr is None and low.t_bsr is None
    with pytest.raises(ValueError):
        pt.pool_transpose(low, torch.zeros(1, 8, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,f", [(16, 16), (16, 32), (3, 5)])
def test_cuda_kernel_matches_block_sparse_kernel(up_mats, b, f, dtype):
    """On a card: fp32 bit-equal to bsr_grouped_spmm(t_bsr, ., "fp32") (the
    same fmaf chain over the row's nonzeros), bf16 within one bf16 ulp of
    max|y| of the twin; F = 5 takes the scalar loads. Launches counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm, pad_features

    tdt, _ = DTYPES[dtype]
    dev = torch.device("cuda")
    for mat in up_mats + [_wide_pool()]:
        port = graph.pool_operator(mat, dev, dtype=tdt)
        g = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (b, port.n_out, f)).astype(np.float32)).to(dev, tdt)
        before = pt.LAUNCHES[dtype]
        got = pt.pool_transpose(port, g)
        assert pt.LAUNCHES[dtype] == before + 1
        twin = pt.pool_transpose_reference(port, g)
        if dtype == "bf16":
            _held(got.float().cpu().numpy(), twin.float().cpu().numpy(),
                  dtype)
            continue
        bsr = port.t_bsr
        f_pad = pad_features(b, f)
        gt = torch.nn.functional.pad(
            g.transpose(0, 1), (0, f_pad - f, 0, 0, 0,
                                bsr.n_pad_cols - port.n_out))
        y = bsr_grouped_spmm(bsr, gt.reshape(bsr.n_pad_cols, -1)
                             .contiguous(), "fp32")
        want = y.reshape(bsr.n_pad, b, f_pad)[:port.n_in, :, :f] \
            .transpose(0, 1)
        assert torch.equal(got, want)
        _held(got.cpu().numpy(), twin.cpu().numpy(), dtype)
