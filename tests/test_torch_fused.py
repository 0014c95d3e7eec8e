"""meshvae_tpu_torch/ops/cheb_fused.py (the fused propagate + mix
Chebyshev conv, TPU kernel #9) against meshvae_tpu/ops/pallas_fused.py,
whose kernel runs in interpret mode: the output within 1e-5 of its max,
dx, dW and dbias within 1e-4 of their max (dW and dbias: the layer's), at
tests/test_pallas.py's shapes and on its padded-rows operator. The CUDA
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16x3"])
@pytest.mark.parametrize("b,f_in,f_out", [(4, 8, 16), (1, 8, 8),
                                          (8, 16, 3)])
def test_cuda_fused_step_matches_twin(mode, b, f_in, f_out):
    """The CUDA kernel against its plain twin on the card, both steps
    (alpha 1 without T_{k-2}, alpha 2 with it), acc updated in place; T_k
    and, in fp32, acc within 1e-5 of their max. In bf16x3 acc is held at
    1e-4: the mix splits T_k, which kernel and twin agree on to the last
    fp32 bit only, and a one-bit change can move its bf16 split (the
    dropped lo*lo term then moves by up to 2^-17 |T W|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
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
        torch.cuda.synchronize()
        assert port_fused.LAUNCHES[mode] == before + 1
        for got, want, bar in ((got_t, want_t, 1e-5), (got_acc, want_acc,
                                1e-5 if mode == "fp32" else 1e-4)):
            err = (got - want).abs().max() / want.abs().max()
            assert err.item() <= bar, err.item()
