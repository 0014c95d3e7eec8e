"""meshvae_tpu_torch/ops/emitted_spmm.py (TPU kernel #10, the emitted-
pipeline SpMM) against benchmarks/emitted_probe.py ``emitted_spmm``, whose
Pallas kernel runs in interpret mode, on tests/test_pallas.py's 32 x 32
grid (1,024 vertices, 8 block rows): within 1e-5 of max |y| in fp32 and one
bf16 ulp (2^-8 max |y|) in bf16, where both sum in fp32 and round once.
The twin is also held against the row-grouped twin and the dense product,
on a G = 1 operator and on one with padded slots; the port's probe runs on
the CPU in a subprocess. The CUDA kernel against its twin is marked
``cuda`` and skips without a card."""
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

from meshvae_tpu_torch.mesh import vertex_adjacency
from meshvae_tpu_torch.ops import emitted_spmm as em
from meshvae_tpu_torch.ops.block_sparse import (BLOCK, bsr_to_dense,
                                                to_block_sparse)
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
    (1e-5 of max |y| in fp32, one bf16 ulp in bf16), on the grid
    Laplacian, G = 1 and padded slots, at 1, 2 and the resident CTAs per
    SM; each call counts one launch."""
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
            refs = (em.emitted_spmm_reference(bsr, x),
                    bsr_grouped_spmm(bsr, x, "fp32" if tdt == torch.float32
                                     else "bf16"))
            for ctas in (0, 1, 2):
                y = em.emitted_spmm(bsr, x, ctas)
                torch.cuda.synchronize()
                calls += 1
                for ref in refs:
                    err = ((y.float() - ref.float()).abs().max()
                           / ref.float().abs().max()).item()
                    assert err <= bar, (dtype, ctas, err)
    assert sum(em.LAUNCHES.values()) == calls
