"""meshvae_tpu_torch.mesh against meshvae_tpu.mesh: the hierarchy (QSlim
decimation, adjacency, barycentric up-sampling), OBJ I/O and Procrustes."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import meshvae_tpu.native as jax_native
from meshvae_tpu.mesh import hierarchy as jax_hierarchy
from meshvae_tpu.mesh import io as jax_io
from meshvae_tpu.mesh import procrustes as jax_procrustes

from meshvae_tpu_torch import native as port_native
from meshvae_tpu_torch.mesh import hierarchy, io, procrustes

from conftest import make_grid_mesh


@pytest.fixture
def numpy_jax_mesh(monkeypatch):
    """Both packages' numpy host paths, without their optional C++
    libraries (tests/test_torch_scaled.py holds the native ones)."""
    for lib in (jax_native, port_native):
        monkeypatch.setattr(lib, "qslim_decimate_native",
                            lambda *a, **k: None)
        monkeypatch.setattr(lib, "barycentric_transfer_native",
                            lambda *a, **k: None)
        monkeypatch.setattr(lib, "obj_parse_native", lambda *a, **k: None)


def _assert_same_hierarchy(port, ref):
    assert port.levels == ref.levels
    for a, b in zip(port.vertices, ref.vertices):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.faces, ref.faces):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.adjacency + port.downsample,
                    ref.adjacency + ref.downsample):
        assert a.shape == b.shape and (a != b).nnz == 0
    for a, b in zip(port.upsample, ref.upsample):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("n,factors", [(8, [2, 2]), (12, [2, 3, 2])])
def test_hierarchy_matches_jax(numpy_jax_mesh, n, factors):
    mesh = make_grid_mesh(n, jitter=0.05, seed=n)
    ref = jax_hierarchy.build_hierarchy(mesh, factors)
    port = hierarchy.build_hierarchy(io.TriMesh(mesh.v, mesh.f), factors)
    _assert_same_hierarchy(port, ref)


def test_hierarchy_cache_roundtrip(numpy_jax_mesh, tmp_path):
    grid = make_grid_mesh(8, jitter=0.05)
    mesh = io.TriMesh(grid.v, grid.f)
    built = hierarchy.load_or_build_hierarchy(mesh, [2, 2], str(tmp_path))
    [cached] = os.listdir(tmp_path)
    assert cached.startswith("hierarchy_") and cached.endswith(".npz")
    loaded = hierarchy.load_or_build_hierarchy(mesh, [2, 2], str(tmp_path))
    _assert_same_hierarchy(loaded, built)
    # same npz format as the JAX package: its loader reads the port's file
    _assert_same_hierarchy(
        loaded, jax_hierarchy._load(os.path.join(tmp_path, cached)))


def test_obj_roundtrip_matches_jax(numpy_jax_mesh, tmp_path):
    mesh = make_grid_mesh(6, jitter=0.3, seed=2)
    path = str(tmp_path / "m.obj")
    io.save_obj(path, mesh.v, mesh.f, comment="port")
    port = io.load_obj(path)
    ref = jax_io.load_obj(path)
    np.testing.assert_array_equal(port.v, ref.v)
    np.testing.assert_array_equal(port.f, ref.f)
    np.testing.assert_allclose(port.v, mesh.v, atol=1e-6)  # %f: 6 decimals
    np.testing.assert_array_equal(port.f, mesh.f)


def test_obj_general_parser(tmp_path):
    """Quads, slashed indices and negative indices take the general parser
    and fan-triangulate like the JAX package's."""
    path = str(tmp_path / "q.obj")
    with open(path, "w") as fp:
        fp.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                 "f 1/1 2/2 3/3 4/4\nf -4 -3 -1\n")
    port = io.load_obj(path)
    np.testing.assert_array_equal(port.f, [[0, 1, 2], [0, 2, 3], [0, 1, 3]])
    np.testing.assert_array_equal(port.f, jax_io.load_obj(path).f)


def test_procrustes_matches_jax():
    rng = np.random.default_rng(3)
    template = rng.standard_normal((50, 3))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    points = 1.7 * template @ q.T + np.array([0.5, -2.0, 3.0])
    points += 0.01 * rng.standard_normal(points.shape)
    a_port, (r_p, s_p, m_p), d_port = procrustes.procrustes_align(template,
                                                                  points)
    a_ref, (r_r, s_r, m_r), d_ref = jax_procrustes.procrustes_align(template,
                                                                    points)
    np.testing.assert_array_equal(a_port, a_ref)
    np.testing.assert_array_equal(r_p, r_r)
    assert s_p == s_r and d_port == d_ref
    np.testing.assert_array_equal(m_p, m_r)
    # the inverse recovers the original pose
    np.testing.assert_allclose(a_port @ r_p * s_p + m_p, points, atol=1e-9)


def test_apply_inverse_similarity_matches_jax():
    rng = np.random.default_rng(4)
    b, n = 3, 40
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    r = rng.standard_normal((b, 3, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, b).astype(np.float32)
    m = rng.standard_normal((b, 1, 3)).astype(np.float32)
    port = procrustes.apply_inverse_similarity(
        torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(s),
        torch.from_numpy(m)).numpy()
    ref = np.asarray(jax_procrustes.apply_inverse_similarity(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(s), jnp.asarray(m)))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)


def test_degenerate_procrustes_raises():
    with pytest.raises(ValueError):
        procrustes.procrustes_align(np.ones((4, 3)), np.ones((4, 3)))
