"""The tile mask of the port's block-sparse operators (tile_mask: which
16x16 tiles of each 128x128 block hold a nonzero) and the kernel's twin,
which zeroes every tile whose bit is clear: the mask against a brute-force
reduction, hand-made blocks, the public helper, the fused conv's re-cast
operator, a cleared bit against the JAX package's Pallas kernel, the
occupancy probe on the CPU, and (on a card) the kernel against the twin at
the same masks."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.ops.block_sparse import to_block_sparse as jax_to_bsr

from meshvae_tpu_torch.bench import tile_probe
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, vertex_adjacency
from meshvae_tpu_torch.ops.block_sparse import (block_sparse_arrays,
                                                tile_mask, to_block_sparse)
from meshvae_tpu_torch.ops.bsr_spmm import (MODE_DTYPE, bsr_grouped_spmm,
                                            bsr_grouped_spmm_reference,
                                            masked_blocks)
from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

from conftest import make_grid_mesh

BF = torch.bfloat16


@pytest.fixture(scope="module")
def grid_mats():
    """A 32x32 grid's level-0 Laplacian and its first up-pool's P^T
    [1024, 256] (rectangular)."""
    mesh = make_grid_mesh(32, jitter=0.05)
    hier = build_hierarchy(TriMesh(mesh.v, mesh.f), [4])
    lap = normalized_neg_adjacency(vertex_adjacency(mesh.num_vertices,
                                                    mesh.f))
    return {"lap": lap, "pt": sp.csr_matrix(hier.upsample[0].T)}


def _brute_force(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    out = np.zeros((nb, 8), np.uint8)
    for b in range(nb):
        for s in range(8):
            for t in range(8):
                if (blocks[b, 16 * s:16 * s + 16, 16 * t:16 * t + 16]
                        != 0).any():
                    out[b, s] |= 1 << t
    return out


def _operator(grid_mats, name, dtype):
    return to_block_sparse(grid_mats[name], "cpu", allow_rect=name == "pt",
                           dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("name", ["lap", "pt"])
def test_mask_matches_brute_force(grid_mats, name, dtype):
    """tile_mask = the (blocks != 0) reduction over 16x16 tiles, of the
    stored blocks and of the float32 sums."""
    bsr = _operator(grid_mats, name, dtype)
    fp32 = block_sparse_arrays(grid_mats[name], allow_rect=name == "pt")
    assert bsr.tile_mask.dtype == torch.uint8
    assert bsr.tile_mask.shape == (bsr.num_blocks, 8)
    mask = bsr.tile_mask.numpy()
    np.testing.assert_array_equal(mask, _brute_force(fp32["blocks"]))
    np.testing.assert_array_equal(mask, _brute_force(
        bsr.blocks.float().numpy()))
    assert 0 < np.unpackbits(mask).mean() < 1


def test_mask_of_hand_made_blocks():
    """One nonzero in each corner tile sets bits 0 and 7 of strips 0 and
    7; a dense random block sets every bit; the zero block that stands in
    for an empty block row, and any all-zero block, none."""
    corners = sp.coo_matrix(([1.0, 2.0, 3.0, 4.0],
                             ([0, 0, 127, 127], [0, 127, 0, 127])),
                            shape=(128, 128))
    want = np.zeros(8, np.uint8)
    want[[0, 7]] = 0x81
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((128, 128)) + 10.0
    for mat, bits in ((corners, want), (sp.csr_matrix(dense),
                                        np.full(8, 0xff, np.uint8))):
        got = block_sparse_arrays(mat)["tile_mask"]
        np.testing.assert_array_equal(got, bits[None])
        blocks = torch.from_numpy(block_sparse_arrays(mat)["blocks"])
        np.testing.assert_array_equal(tile_mask(blocks).numpy(), bits[None])
    assert not tile_mask(torch.zeros(2, 128, 128)).any()
    gap = sp.diags(np.r_[np.ones(128), np.zeros(128), np.ones(44)]).tocsr()
    gap.eliminate_zeros()  # block row 1 is absent: a zero block stands in
    arrays = block_sparse_arrays(gap)
    assert arrays["block_row"].tolist() == [0, 1, 2]
    assert arrays["tile_mask"][1].tolist() == [0] * 8
    assert arrays["tile_mask"][0].tolist() == [1 << s for s in range(8)]


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("name", ["lap", "pt"])
def test_helper_matches_to_block_sparse(grid_mats, name, dtype):
    """tile_mask(blocks), for operators built by hand, gives
    to_block_sparse's mask."""
    bsr = _operator(grid_mats, name, dtype)
    assert torch.equal(tile_mask(bsr.blocks), bsr.tile_mask)


def test_mask_survives_the_fused_convs_recast(grid_mats):
    """cheb_conv_fused re-casts a bf16 operator's blocks to fp32 with
    dataclasses.replace: the mask comes along and still describes the
    blocks, and the twin gives the same product as on a mask derived
    afresh."""
    bsr = _operator(grid_mats, "lap", BF)
    recast = dataclasses.replace(bsr, blocks=bsr.blocks.float())
    assert recast.tile_mask is bsr.tile_mask
    assert torch.equal(tile_mask(recast.blocks), recast.tile_mask)
    x = torch.randn(recast.n_pad_cols, 128,
                    generator=torch.Generator().manual_seed(0))
    fresh = dataclasses.replace(recast, tile_mask=tile_mask(recast.blocks))
    assert torch.equal(bsr_grouped_spmm_reference(recast, x),
                       bsr_grouped_spmm_reference(fresh, x))


@pytest.mark.parametrize("mode", ["fp32", "bf16x3"])
def test_twin_reads_the_mask(grid_mats, monkeypatch, mode):
    """With its mask the twin matches the JAX package's Pallas kernel
    (interpret mode); with one needed bit cleared it does not, and the
    difference is that tile's product exactly."""
    monkeypatch.setattr(pc, "INTERPRET", True)
    lap = grid_mats["lap"]
    bsr = to_block_sparse(lap, "cpu")
    ref = jax_to_bsr(lap)
    x = np.random.default_rng(1).standard_normal(
        (bsr.n_pad_cols, 128)).astype(np.float32)
    precision = {"fp32": jax.lax.Precision.HIGHEST,
                 "bf16x3": jax.lax.Precision.HIGH}[mode]
    want = np.asarray(pc._bsr_matmul_impl(ref, jnp.asarray(x), precision))
    got = bsr_grouped_spmm_reference(bsr, torch.from_numpy(x), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    mask = bsr.tile_mask.clone()
    b = int(np.flatnonzero(mask.numpy().any(1))[0])
    s = int(np.flatnonzero(mask[b].numpy())[0])
    t = int(mask[b, s]).bit_length() - 1
    mask[b, s] &= ~(1 << t) & 0xff
    cleared = dataclasses.replace(bsr, tile_mask=mask)
    assert (masked_blocks(cleared)[b, 16 * s:16 * s + 16,
                                   16 * t:16 * t + 16] == 0).all()
    off = bsr_grouped_spmm_reference(cleared, torch.from_numpy(x),
                                     mode).numpy()
    assert np.abs(off - want).max() > 1e-2 * np.abs(want).max()
    row = int(bsr.block_row[b]) * 128 + 16 * s
    col = int(bsr.block_col[b]) * 128 + 16 * t
    tile = bsr.blocks[b, 16 * s:16 * s + 16, 16 * t:16 * t + 16].numpy()
    np.testing.assert_allclose(got[row:row + 16] - off[row:row + 16],
                               tile @ x[col:col + 16], rtol=1e-4, atol=1e-4)


def test_occupancy_probe_on_the_cpu(tmp_path):
    """The occupancy probe's CPU path at the 5k level 0 (twins only: the
    synthetic sweep, fp32 against the emitted twin, bf16 against its
    twin) reports the layout's counts: the shipped template's 122 blocks,
    G 4, about a third of the tiles occupied."""
    report = tile_probe.main(["--workloads", "5k", "--device", "cpu",
                              "--cache-dir", str(tmp_path)])
    occ = report["workloads"]["5k"]
    assert (occ["blocks"], occ["g"]) == (122, 4)
    assert occ["tiles"] < occ["chunks"] * 4 <= occ["blocks"] * 64
    assert 0.3 < occ["tiles"] / (occ["blocks"] * 64) < 0.4
    assert occ["bit_equal"] == 1.0 and occ["bf16_err"] <= 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16x3", "bf16"])
def test_cuda_kernel_matches_twin_at_the_masks(mode):
    """On a card: the kernel against its twin on patterned operators (a
    dense block, a block with no set bit, empty strips, sparse tiles), G
    = 1..9 with padded slots, C = 64, 128, 512 and 2048, alpha 2 with
    t_prev; the lazy seed at f = 8, 16, 32 and 128 (fp32, bf16); fp32
    equal bit for bit to the dense-block product of emitted_spmm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from meshvae_tpu_torch.ops.emitted_spmm import emitted_spmm

    dt = MODE_DTYPE[mode]
    gen = torch.Generator().manual_seed(7)
    for g in range(1, 10):
        bsr = tile_probe.patterned_operator(g, dt, torch.device("cuda"), g)
        for c in (64, 128, 512, 2048):
            x = torch.randn(bsr.n_pad_cols, c, generator=gen).to(dt).cuda()
            prev = torch.randn(bsr.n_pad, c, generator=gen).to(dt).cuda()
            y = bsr_grouped_spmm(bsr, x, mode, 2.0, t_prev=prev)
            ref = bsr_grouped_spmm_reference(bsr, x, mode, 2.0, t_prev=prev)
            bar = tile_probe.ulp_bar(ref) if mode == "bf16" else 1e-5
            assert tile_probe.rel_err(y, ref) <= bar, (g, c)
            if mode == "fp32" and c % 128 == 0:
                assert torch.equal(bsr_grouped_spmm(bsr, x, mode),
                                   emitted_spmm(bsr, x)), (g, c)
        if mode == "bf16x3":
            continue
        x = torch.randn(bsr.n_pad_cols, 512, generator=gen).to(dt).cuda()
        for f in (8, 16, 32, 128):
            dot = (torch.randn(bsr.n_pad, 512, generator=gen).to(dt).cuda(),
                   (0.3 * torch.randn(f, f, generator=gen)).to(dt).cuda())
            y = bsr_grouped_spmm(bsr, x, mode, t_plus_dot=dot)
            ref = bsr_grouped_spmm_reference(bsr, x, mode, t_plus_dot=dot)
            bar = tile_probe.ulp_bar(ref) if mode == "bf16" else 1e-5
            assert tile_probe.rel_err(y, ref) <= bar, (g, f)
