"""meshvae_tpu_torch/ops/cheb_fused.py (the fused propagate + mix
Chebyshev conv, TPU kernel #9) against meshvae_tpu/ops/pallas_fused.py,
whose kernel runs in interpret mode: the output within 1e-5 of its max,
dx, dW and dbias within 1e-4 of their max (dW and dbias: the layer's), at
tests/test_pallas.py's shapes and on its padded-rows operator; the
step's bound (tile_probe.fused_bounds) against a hand count. The CUDA
kernel against its plain twin is marked ``cuda`` and skips without a
card."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.mesh.connectivity import vertex_adjacency
from meshvae_tpu.ops.block_sparse import to_block_sparse as jax_to_bsr
from meshvae_tpu.ops.graph import GraphOperator as JaxGraphOperator
from meshvae_tpu.ops.graph import cheb_operator as jax_cheb_operator
from meshvae_tpu.ops.pallas_fused import cheb_conv_fused as jax_fused

from meshvae_tpu_torch.bench import tile_probe
from meshvae_tpu_torch.ops import cheb_fused as port_fused
from meshvae_tpu_torch.ops import graph
from meshvae_tpu_torch.ops.block_sparse import BLOCK, to_block_sparse
from meshvae_tpu_torch.ops.cheb import cheb_conv
from meshvae_tpu_torch.ops.cheb_fused import cheb_conv_fused

from conftest import make_grid_mesh


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def ops():
    """tests/test_pallas.py's big_graph: a 196-vertex grid (2x2 blocks)."""
    mesh = make_grid_mesh(14, jitter=0.05)
    adj = vertex_adjacency(mesh.num_vertices, mesh.f)
    return (graph.cheb_operator(adj, "cpu", bsr_min_n=1),
            jax_cheb_operator(adj, layouts=("bsr",)))


def _run(port_op, jax_op, b, f_in, f_out, k, seed, precision="highest"):
    n = port_op.n
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, f_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f_in, f_out))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f_out)).astype(np.float32)
    g = rng.standard_normal((b, n, f_out)).astype(np.float32)

    def jax_loss(x_, w_, b_):
        out = jax_fused(x_, jax_op, w_, b_, precision=precision)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, bias))
    got = cheb_conv_fused(xt, port_op, wt, bt, precision=precision)
    (got * torch.from_numpy(g)).sum().backward()
    return got, np.asarray(want), (xt, wt, bt), grads


def _held(got, want, leaves, grads):
    assert got.shape == want.shape
    delta = np.abs(got.detach().numpy() - want).max()
    assert delta <= 1e-5 * np.abs(want).max(), delta
    layer = max(np.abs(np.asarray(a)).max() for a in grads[1:])
    for name, leaf, ref, scale in zip(
            ("dx", "dW", "dbias"), leaves, grads,
            (np.abs(np.asarray(grads[0])).max(), layer, layer)):
        delta = np.abs(leaf.grad.numpy() - np.asarray(ref)).max()
        assert delta <= 1e-4 * scale, (name, delta, scale)


@pytest.mark.parametrize("b,f_in,f_out,k", [(4, 8, 16, 4), (4, 16, 32, 6),
                                            (8, 16, 3, 5)])
def test_fused_conv_matches_jax(ops, b, f_in, f_out, k):
    """The output and every gradient against pallas_fused.cheb_conv_fused
    (tests/test_pallas.py's shapes; f_pad 32, 32 and 16), and the output
    against the port's main-path conv, which computes the same function."""
    port_op, jax_op = ops
    got, want, leaves, grads = _run(port_op, jax_op, b, f_in, f_out, k,
                                    seed=4)
    _held(got, want, leaves, grads)
    with torch.no_grad():
        plain = cheb_conv(leaves[0], port_op, leaves[1], leaves[2])
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=1e-5 * plain.abs().max().item())


def test_fused_conv_padded_rows():
    """tests/test_pallas.py's padded-rows operator: L = 0.5 I on 141 row
    blocks padded to 144, b = 1, f = 8, K = 2 (f_pad = 128: one batch item
    spans two of the CUDA kernel's 64-column tiles)."""
    n = 141 * BLOCK
    lap = sp.eye(n, format="csr", dtype=np.float32) * 0.5
    bsr = to_block_sparse(lap, "cpu")
    assert bsr.n_pad == 144 * BLOCK
    port_op = graph.GraphOperator(dense=None, bsr=bsr, n=n, active_n=n)
    jax_op = JaxGraphOperator(dense=None, ell_idx=None, ell_w=None,
                              bsr=jax_to_bsr(lap), n=n)
    got, want, leaves, grads = _run(port_op, jax_op, 1, 8, 8, 2, seed=31)
    assert port_fused.pad_feature(1, 8) == 128
    _held(got, want, leaves, grads)
    x, w = (leaf.detach().numpy() for leaf in leaves[:2])
    np.testing.assert_allclose(
        got.detach().numpy() - leaves[2].detach().numpy(),
        x @ w[0] + 0.5 * x @ w[1], rtol=1e-5, atol=1e-5)


def test_fused_bounds_hand_count():
    """A 256 x 256 operator with one nonzero in each of its four blocks
    (tiles (0, 0), (0, 4), (0, 0) and (7, 7)): at B = 2, f_pad = 16
    (C = 32) and f_out = 8 the step reads 4 occupied tiles of 256 fp32,
    tile_mask (8 bytes a block), g_idx and g_bcol (4 int32 each), T_{k-1}
    and T_{k-2} [256, 32], writes T_k [256, 32], reads and writes acc
    [256, 16] and reads W_k [16, 8]; it does 2 operations per nonzero per
    column and 2 f_out per T_k element."""
    mat = sp.coo_matrix(([1.0, 2.0, 3.0, 4.0],
                         ([0, 5, 130, 255], [0, 200, 3, 255])),
                        shape=(256, 256))
    bsr = to_block_sparse(mat, "cpu")
    assert (bsr.num_blocks, bsr.n_pad, bsr.g_width) == (4, 256, 2)
    b = tile_probe.fused_bounds(bsr, 32, 16, 8)
    tiles = 4 * 4 * 256 + 8 * 4 + 4 * (4 + 4)
    act = 4 * (256 * 32 * 3 + 2 * 256 * 2 * 8 + 16 * 8)
    assert b["bytes"] == tiles + act == 135_744
    assert b["stored_bytes"] == 4 * 4 * 128 * 128 + 4 * (4 + 4) + act
    assert b["ops"] == 2 * (4 * 32 + 256 * 32 * 8)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(1e3 * 135_744 / 3.35e12)
    first = tile_probe.fused_bounds(bsr, 32, 16, 8, prev=False)
    assert b["bytes"] - first["bytes"] == 4 * 256 * 32
    split = tile_probe.fused_bounds(bsr, 32, 16, 8, mode="bf16x3")
    assert split["ops"] == 3 * b["ops"] and split["bytes"] == b["bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16x3"])
@pytest.mark.parametrize("b,f_in,f_out", [(4, 8, 16), (1, 8, 8),
                                          (8, 16, 3)])
def test_cuda_fused_step_matches_twin(mode, b, f_in, f_out):
    """The CUDA kernel against its plain twin on the card, both steps
    (alpha 1 without T_{k-2}, alpha 2 with it), acc updated in place; T_k
    bit-equal to bsr_grouped_spmm with the same seed and, with acc in
    fp32, within 1e-5 of their max. In bf16x3 acc is held at 1e-4: the
    mix splits T_k, which kernel and twin agree on to the last fp32 bit
    only, and a one-bit change can move its bf16 split (the dropped lo*lo
    term then moves by up to 2^-17 |T W|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm

    mesh = make_grid_mesh(40, jitter=0.05)
    adj = vertex_adjacency(mesh.num_vertices, mesh.f)
    bsr = graph.cheb_operator(adj, "cuda", bsr_min_n=1).bsr
    f_pad = port_fused.pad_feature(b, f_in)
    c = b * f_pad
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1, t2 = (torch.randn(bsr.n_pad, c, device="cuda", generator=gen)
              for _ in range(2))
    w = torch.randn(f_pad, f_out, device="cuda", generator=gen)
    acc = torch.randn(bsr.n_pad, b * f_out, device="cuda", generator=gen)
    for alpha, prev in ((1.0, None), (2.0, t2)):
        before = port_fused.LAUNCHES[mode]
        want_t, want_acc = port_fused.cheb_fused_step_reference(
            bsr, t1, prev, w, acc, alpha, mode)
        got_t, got_acc = port_fused.cheb_fused_step(bsr, t1, prev, w,
                                                    acc.clone(), alpha, mode)
        same = bsr_grouped_spmm(bsr, t1, mode, alpha, t_prev=prev)
        torch.cuda.synchronize()
        assert port_fused.LAUNCHES[mode] == before + 1
        assert torch.equal(got_t, same)
        for got, want, bar in ((got_t, want_t, 1e-5), (got_acc, want_acc,
                                1e-5 if mode == "fp32" else 1e-4)):
            err = (got - want).abs().max() / want.abs().max()
            assert err.item() <= bar, err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16x3"])
def test_cuda_fused_step_synthetic_sweep(mode):
    """On a card, chip_smoke.py phase 10's sweep: square patterned
    operators (G = 1..9 with padded slots, a dense block, a block with no
    set bit, every other strip empty, sparse tiles) at (B, f_pad, f_out)
    in (16, 16, 16), (4, 32, 16), (1, 128, 8), (8, 16, 3), (16, 8, 5):
    T_k bit-equal to bsr_grouped_spmm with the same seed, T_k within 1e-5
    of its max of the twin, acc within 1e-5 (1e-4 in bf16x3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(10)
    for g in range(1, 10):
        bsr = tile_probe.patterned_operator(g, torch.float32, dev, seed=g,
                                            square=True)
        for b, f_pad, f_out in ((16, 16, 16), (4, 32, 16), (1, 128, 8),
                                (8, 16, 3), (16, 8, 5)):
            c = b * f_pad
            t1, t2 = (torch.randn(bsr.n_pad, c, generator=gen).to(dev)
                      for _ in range(2))
            w = torch.randn(f_pad, f_out, generator=gen).to(dev)
            acc = torch.randn(bsr.n_pad, b * f_out, generator=gen).to(dev)
            for alpha, prev in ((1.0, None), (2.0, t2)):
                got_t, got_acc = port_fused.cheb_fused_step(
                    bsr, t1, prev, w, acc.clone(), alpha, mode)
                same = bsr_grouped_spmm(bsr, t1, mode, alpha, t_prev=prev)
                torch.cuda.synchronize()
                want_t, want_acc = port_fused.cheb_fused_step_reference(
                    bsr, t1, prev, w, acc, alpha, mode)
                assert torch.equal(got_t, same), (g, b, f_pad, alpha)
                assert tile_probe.rel_err(got_t, want_t) <= 1e-5
                assert tile_probe.rel_err(got_acc, want_acc) <= (
                    1e-5 if mode == "fp32" else 1e-4), (g, b, f_pad, alpha)
