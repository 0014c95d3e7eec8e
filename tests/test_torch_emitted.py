"""meshvae_tpu_torch/ops/emitted_spmm.py (TPU kernel #10, the emitted-
pipeline SpMM) against benchmarks/emitted_probe.py ``emitted_spmm``, whose
Pallas kernel runs in interpret mode, on tests/test_pallas.py's 32 x 32
grid (1,024 vertices, 8 block rows): within 1e-5 of max |y| in fp32 and one
bf16 ulp (2^-8 max |y|) in bf16, where both sum in fp32 and round once.
The twin zeroes the tiles that tile_mask clears, so these also show that
the mask drops no nonzero of the operators #10 runs on. The twin is also
held against the row-grouped twin and the dense product, on a G = 1
operator and on one with padded slots; the host work list of the
persistent kernel (row blocks by occupied k chunks, longest first) is held
against a brute-force count; the port's probe runs on the CPU in a
subprocess. The CUDA kernel against its twin is marked ``cuda`` and skips
without a card."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshvae_tpu.ops.block_sparse import to_block_sparse as jax_to_bsr

from meshvae_tpu_torch.bench import tile_probe
from meshvae_tpu_torch.mesh import vertex_adjacency
from meshvae_tpu_torch.ops import emitted_spmm as em
from meshvae_tpu_torch.ops.block_sparse import (BLOCK, TILE,
                                                BlockSparseOperator,
                                                bsr_to_dense, row_chunks,
                                                row_order, to_block_sparse)
from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm_reference
from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

from conftest import make_grid_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8)}


def jax_emitted(mat, x: np.ndarray, dtype: str) -> np.ndarray:
    """The JAX package's #10 in interpret mode, as fp32 numpy."""
    from benchmarks.emitted_probe import emitted_spmm

    _, jdt, _ = DTYPES[dtype]
    y = emitted_spmm(jax_to_bsr(mat, dtype=jdt), jnp.asarray(x).astype(jdt),
                     interpret=True)
    return np.asarray(y.astype(jnp.float32))


def port_emitted(mat, x: np.ndarray, dtype: str):
    tdt, _, _ = DTYPES[dtype]
    bsr = to_block_sparse(mat, "cpu", dtype=tdt)
    return bsr, em.emitted_spmm(bsr, torch.from_numpy(x).to(tdt))


def held(got: torch.Tensor, want: np.ndarray, bar: float) -> float:
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= bar, (err, bar)
    return err


@pytest.fixture(scope="module")
def lap():
    """test_pallas.py's emitted-pipeline operator: the normalised
    Laplacian of a jittered 32 x 32 grid."""
    mesh = make_grid_mesh(32, jitter=0.05)
    return normalized_neg_adjacency(vertex_adjacency(mesh.num_vertices,
                                                     mesh.f))


def _x(n: int, c: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, c)).astype(
        np.float32)


@pytest.mark.parametrize("dtype,c", [("float32", 256), ("bfloat16", 128),
                                     ("bfloat16", 256)])
def test_twin_matches_jax_emitted(lap, dtype, c):
    """The twin against the JAX package's emitted_spmm (interpret mode)."""
    x = _x(1024, c)
    bsr, got = port_emitted(lap, x, dtype)
    assert bsr.n_pad // BLOCK == 8 and bsr.g_width >= 3
    assert got.dtype == DTYPES[dtype][0] and got.shape == (1024, c)
    held(got, jax_emitted(lap, x, dtype), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_grouped_twin_and_dense(lap, dtype):
    """The twin against bsr_grouped_spmm_reference (alpha 1, no seeds) and
    the float64 dense product of the stored operands."""
    tdt, _, bar = DTYPES[dtype]
    x = _x(1024, 256, seed=6)
    bsr, got = port_emitted(lap, x, dtype)
    xt = torch.from_numpy(x).to(tdt)
    grouped = bsr_grouped_spmm_reference(
        bsr, xt, "fp32" if dtype == "float32" else "bf16")
    held(got, grouped.float().numpy(), bar)
    dense = bsr_to_dense(bsr).astype(np.float64) @ xt.double().numpy()
    held(got[:bsr.n], dense, bar)


def _layouts():
    """A block-diagonal operator (G = 1) and one whose first block row
    spans three column blocks while the others span one (padded slots)."""
    rng = np.random.default_rng(3)
    n = 4 * BLOCK
    diag = sp.block_diag([sp.random(BLOCK, BLOCK, density=0.05,
                                    random_state=rng) for _ in range(4)])
    wide = sp.lil_matrix(diag)
    wide[5, 2 * BLOCK + 7] = 0.5
    wide[9, 3 * BLOCK + 1] = -0.25
    return {"G=1": sp.csr_matrix(diag), "padded": sp.csr_matrix(wide)}, n


@pytest.mark.parametrize("name", ["G=1", "padded"])
def test_g1_and_padded_slots(name):
    mats, n = _layouts()
    mat = mats[name]
    x = _x(n, 128, seed=7)
    bsr, got = port_emitted(mat, x, "float32")
    if name == "G=1":
        assert bsr.g_width == 1
    else:
        assert bsr.g_width == 3
        assert int((bsr.g_idx == bsr.num_blocks).sum()) == 3 * 2
    held(got, jax_emitted(mat, x, "float32"), 1e-5)
    held(got, mat.toarray().astype(np.float64) @ x.astype(np.float64), 1e-5)


def test_twin_reads_the_mask(lap):
    """A value planted inside a tile whose tile_mask bit is clear changes
    the stored blocks' dense product but not the twin's result; clearing
    the bit of an occupied tile drops exactly that tile's product."""
    bsr = to_block_sparse(lap, "cpu")
    x = torch.from_numpy(_x(bsr.n_pad_cols, 128, seed=8))
    want = em.emitted_spmm_reference(bsr, x)
    mask = bsr.tile_mask.numpy()
    b, s, t = (int(i[0]) for i in np.nonzero(
        ((mask[:, :, None] >> np.arange(8)) & 1) == 0))
    planted = bsr.blocks.clone()
    planted[b, TILE * s + 3, TILE * t + 5] = 7.0
    moved = dataclasses.replace(bsr, blocks=planted)
    assert torch.equal(em.emitted_spmm_reference(moved, x), want)
    row = int(bsr.block_row[b]) * BLOCK + TILE * s + 3
    col = int(bsr.block_col[b]) * BLOCK + TILE * t + 5
    dense = torch.from_numpy(bsr_to_dense(moved)).double() @ x[:bsr.n].double()
    assert abs(dense[row] - want[row].double()).max() > 1.0
    assert np.allclose(np.delete(dense.numpy(), row, 0),
                       np.delete(want[:bsr.n].numpy(), row, 0), atol=1e-5)
    # an occupied tile with its bit cleared: that tile's product goes
    b, s = (int(i[0]) for i in np.nonzero(mask))
    t = int(mask[b, s]).bit_length() - 1
    cleared = bsr.tile_mask.clone()
    cleared[b, s] &= ~(1 << t) & 0xff
    off = em.emitted_spmm_reference(dataclasses.replace(
        bsr, tile_mask=cleared), x)
    r0 = int(bsr.block_row[b]) * BLOCK + TILE * s
    c0 = int(bsr.block_col[b]) * BLOCK + TILE * t
    tile = bsr.blocks[b, TILE * s:TILE * s + TILE, TILE * t:TILE * t + TILE]
    torch.testing.assert_close(want[r0:r0 + TILE] - off[r0:r0 + TILE],
                               tile @ x[c0:c0 + TILE], rtol=1e-4, atol=1e-5)
    assert torch.equal(torch.cat([want[:r0], want[r0 + TILE:]]),
                       torch.cat([off[:r0], off[r0 + TILE:]]))


def _brute_chunks(mask, g_idx, g_bcol, n_col_blocks):
    """Per row, the k chunks (bit t set in any strip's byte) over its real
    slots, by loops over every slot, strip and bit."""
    nb = len(mask)
    bcol = np.asarray(g_bcol).reshape(np.shape(g_idx))
    out = []
    for r, slots in enumerate(np.asarray(g_idx)):
        total = 0
        for s, bi in enumerate(slots):
            if not (0 <= bi < nb and 0 <= bcol[r, s] < n_col_blocks):
                continue
            total += sum(any((int(mask[bi][strip]) >> t) & 1
                             for strip in range(8)) for t in range(8))
        out.append(total)
    return np.array(out)


def _hand_masks():
    """Hand-made layouts: (name, mask [nb, 8], g_idx [nR, G], g_bcol,
    n_col_blocks) with an empty mask, half-empty blocks, padded slots
    (index nb) and slots outside x, and the patterned operators of the
    tile probe at G = 1..9."""
    rng = np.random.default_rng(4)
    nb = 6
    half = np.zeros((nb, 8), np.uint8)
    half[:, :4] = rng.integers(1, 256, (nb, 4))      # strips 4-7 empty
    half[2] = 0                                     # a block with no bit
    g_idx = np.array([[0, 1, nb], [2, nb, nb], [3, 4, 5], [nb, nb, nb],
                      [5, 5, 1]], np.int32)
    g_bcol = np.array([0, 1, 1, 2, 2, 2, 0, 1, 3, 0, 0, 0, 1, 9, 2],
                      np.int32)  # slot (4, 1) lies outside the 4 x blocks
    cases = [("empty", np.zeros((nb, 8), np.uint8), g_idx, g_bcol, 4),
             ("half-empty", half, g_idx, g_bcol, 4),
             ("full", np.full((nb, 8), 255, np.uint8), g_idx, g_bcol, 4)]
    for g in range(1, 10):
        bsr = tile_probe.patterned_operator(g, torch.float32, "cpu", seed=g)
        cases.append((f"G={g}", bsr.tile_mask.numpy(), bsr.g_idx.numpy(),
                      bsr.g_bcol.numpy(), bsr.n_pad_cols // BLOCK))
    return cases


def _grid_cases(lap):
    mats, _ = _layouts()
    out = []
    for name, mat in [("lap", lap)] + sorted(mats.items()):
        bsr = to_block_sparse(mat, "cpu")
        out.append((name, bsr.tile_mask.numpy(), bsr.g_idx.numpy(),
                    bsr.g_bcol.numpy(), bsr.n_pad_cols // BLOCK))
    return out


def _items(order, n_ct: int) -> np.ndarray:
    """[n_rows * n_ct, 2] (row block, column tile) in the order the
    persistent CTAs take them: item i is row order[i // n_ct], tile
    i % n_ct (the kernel's decode in csrc/emitted_spmm.cu)."""
    order = np.asarray(order, np.int64)
    items = np.arange(len(order) * n_ct)
    return np.stack([order[items // n_ct], items % n_ct], axis=1)


@pytest.mark.parametrize("n_ct", [1, 2, 8])
def test_work_list(lap, n_ct):
    """The persistent kernel's work list: per-row chunk counts equal a
    brute-force count from tile_mask; the row order is by those counts,
    most first, ties in row order; every (row block, column tile) item
    appears exactly once in the kernel's decode."""
    for name, mask, g_idx, g_bcol, ncb in _grid_cases(lap) + _hand_masks():
        chunks = row_chunks(mask, g_idx, g_bcol, ncb)
        np.testing.assert_array_equal(
            chunks, _brute_chunks(mask, g_idx, g_bcol, ncb), err_msg=name)
        order = row_order(mask, g_idx, g_bcol, ncb)
        assert order.dtype == np.int32 and sorted(order) == list(
            range(len(g_idx))), name
        ranked = list(zip(-chunks[order], order))
        assert ranked == sorted(ranked), name  # descending, then stable
        items = _items(order, n_ct)
        assert len(items) == len(g_idx) * n_ct
        assert len({tuple(i) for i in items}) == len(items), name
        assert set(items[:, 1]) <= set(range(n_ct))


def test_work_list_made_with_the_operator(lap):
    """to_block_sparse builds the work list from its tile_mask; an
    operator made by hand without one gets the same list from the
    wrapper, and a rectangular operator's counts skip nothing."""
    bsr = to_block_sparse(lap, "cpu")
    want = row_order(bsr.tile_mask.numpy(), bsr.g_idx.numpy(),
                     bsr.g_bcol.numpy(), bsr.n_pad_cols // BLOCK)
    np.testing.assert_array_equal(bsr.row_order.numpy(), want)
    bare = BlockSparseOperator(*[getattr(bsr, f.name) for f in
                                 dataclasses.fields(bsr)][:-1])
    assert bare.row_order is None
    assert torch.equal(em.work_order(bare), bsr.row_order)
    chunks = row_chunks(bsr.tile_mask.numpy(), bsr.g_idx.numpy(),
                        bsr.g_bcol.numpy(), bsr.n_pad_cols // BLOCK)
    assert chunks.sum() == sum(
        bin(int(np.bitwise_or.reduce(m))).count("1")
        for m in bsr.tile_mask.numpy())  # every block is in one slot


def test_wrapper_checks_and_counts():
    """C must be a positive multiple of 128 and x must have the blocks'
    dtype; a CPU call runs the twin, launches nothing and loads no
    library."""
    mats, n = _layouts()
    bsr = to_block_sparse(mats["G=1"], "cpu")
    em.reset_launches()
    with pytest.raises(ValueError, match="multiple of 128"):
        em.emitted_spmm(bsr, torch.zeros(n, 64))
    with pytest.raises(TypeError, match="dtype"):
        em.emitted_spmm(bsr, torch.zeros(n, 128, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="dtype"):
        em.emitted_spmm(bsr, torch.zeros(n, 128, dtype=torch.float64))
    y = em.emitted_spmm(bsr, torch.ones(n, 128))
    assert y.shape == (n, 128) and y.dtype == torch.float32
    assert em.LAUNCHES == {"fp32": 0, "bf16": 0}
    if not torch.cuda.is_available():
        assert em._lib.cache_info().currsize == 0


def test_probe_runs_on_the_cpu(tmp_path):
    """python -m meshvae_tpu_torch.bench.emitted_probe --workload 5k
    --device cpu: the template5k level 0 at B=32, f=16 (C=512) in bf16, the
    twins held together, and the JSON line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "meshvae_tpu_torch.bench.emitted_probe",
         "--workload", "5k", "--device", "cpu", "--cache-dir",
         str(tmp_path / "cache")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("level-0: n_pad 5120 rows 40 g ")
    report = json.loads(lines[-1])
    assert report["ok"] is True and report["device"] == "cpu"
    assert report["c"] == 512 and report["dtype"] == "bfloat16"
    assert report["max_err_rel"] <= 2.0 ** -8


@pytest.mark.cuda
def test_cuda_kernel_matches_twin(lap):
    """The CUDA kernel on the card against its twin and bsr_grouped_spmm
    (fp32: bit for bit with bsr_grouped_spmm and 1e-5 of max |y| from the
    twin; bf16: one bf16 ulp of max |y|), on the grid Laplacian, G = 1 and
    padded slots, at 1, 2 and the resident CTAs per SM; each call counts
    one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from meshvae_tpu_torch.device import resolve_device
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm

    dev = resolve_device("cuda")
    mats, n = _layouts()
    em.reset_launches()
    calls = 0
    for mat in (lap, mats["G=1"], mats["padded"]):
        for dtype, (tdt, _, bar) in DTYPES.items():
            bsr = to_block_sparse(mat, dev, dtype=tdt)
            x = torch.from_numpy(_x(bsr.n_pad_cols, 256)).to(tdt).to(dev)
            twin = em.emitted_spmm_reference(bsr, x)
            grouped = bsr_grouped_spmm(bsr, x, "fp32" if tdt == torch.float32
                                       else "bf16")
            for ctas in (0, 1, 2):
                y = em.emitted_spmm(bsr, x, ctas)
                torch.cuda.synchronize()
                calls += 1
                if tdt == torch.float32:
                    assert torch.equal(y, grouped), ctas
                for ref in (twin, grouped):
                    err = ((y.float() - ref.float()).abs().max()
                           / ref.float().abs().max()).item()
                    assert err <= bar, (dtype, ctas, err)
    assert sum(em.LAUNCHES.values()) == calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_synthetic_sweep(dtype):
    """On a card, chip_smoke.py phase 11's sweep: the tile probe's
    patterned operators (G = 1..9 with padded slots, a dense block, a block
    with no set bit, every other strip empty, sparse tiles) at C = 128,
    512 and 2048 and 0, 1 and 2 CTAs per SM cap; fp32 bit-equal to
    bsr_grouped_spmm, bf16 within the bf16 ulp of max |y| of the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm

    tdt = DTYPES[dtype][0]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    for g in range(1, 10):
        bsr = tile_probe.patterned_operator(g, tdt, dev, seed=g)
        for c in (128, 512, 2048):
            x = torch.randn(bsr.n_pad_cols, c, generator=gen).to(tdt).to(dev)
            twin = em.emitted_spmm_reference(bsr, x)
            grouped = bsr_grouped_spmm(bsr, x, "fp32" if tdt == torch.float32
                                       else "bf16")
            bar = (1e-5 if tdt == torch.float32 else
                   tile_probe.ulp_bar(twin))
            for ctas in (0, 1, 2):
                y = em.emitted_spmm(bsr, x, ctas)
                torch.cuda.synchronize()
                if tdt == torch.float32:
                    assert torch.equal(y, grouped), (g, c, ctas)
                assert tile_probe.rel_err(y, twin) <= bar, (g, c, ctas)
