"""The scaled-template pieces of meshvae_tpu_torch against the JAX package
and against the port's own numpy paths: midpoint subdivision + RCM
relabeling (bit for bit), ensure_template (generation, the v2 marker, v1
regeneration, no-op cases), the port's native library (QSlim, closest-point
transfer, OBJ parse) against its numpy copies, and the native template5k
hierarchy against the JAX package's. The native tests skip without a C++
compiler."""
import shutil
import subprocess

import numpy as np
import pytest

from meshvae_tpu.mesh.hierarchy import build_hierarchy as jax_build_hierarchy
from meshvae_tpu.mesh.io import TriMesh as JaxTriMesh
from meshvae_tpu.mesh.io import load_obj as jax_load_obj
from meshvae_tpu.mesh.subdivide import subdivide_to_target as jax_subdivide

from meshvae_tpu_torch import native
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, load_obj
from meshvae_tpu_torch.mesh import io as port_io
from meshvae_tpu_torch.mesh import qslim, save_obj, transfer
from meshvae_tpu_torch.mesh.subdivide import (subdivide_midpoint,
                                              subdivide_to_target)
from meshvae_tpu_torch.tools.make_scaled_template import (_MARKER,
                                                          ensure_template)

from conftest import TEMPLATE_PATH, make_grid_mesh


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("no C++ compiler: the native meshops library is not "
                    "built")
    return native


@pytest.mark.parametrize("source", ["grid", "template5k"])
def test_subdivide_matches_jax(source):
    """One midpoint subdivision + RCM relabeling (5k -> 20k), vertex for
    vertex and face for face."""
    mesh = (make_grid_mesh(12, jitter=0.05) if source == "grid"
            else jax_load_obj(TEMPLATE_PATH))
    got = subdivide_to_target(TriMesh(mesh.v, mesh.f), 20)
    want = jax_subdivide(JaxTriMesh(mesh.v, mesh.f), 20)
    np.testing.assert_array_equal(got.v, want.v)
    np.testing.assert_array_equal(got.f, want.f)
    plain = subdivide_midpoint(TriMesh(mesh.v, mesh.f))
    assert plain.num_vertices == got.num_vertices
    if source == "template5k":
        # V' = V + E = 4998 + 14994, F' = 4 * 9996
        assert (got.num_vertices, got.num_faces) == (19992, 39984)


def _template_dir(tmp_path):
    tdir = tmp_path / "template"
    tdir.mkdir()
    shutil.copy(TEMPLATE_PATH, tdir / "template5k.obj")
    return tdir


@pytest.mark.parametrize("target,verts", [(20, 19992), (80, 79968)])
def test_ensure_template_generates(tmp_path, target, verts):
    """A missing template20k / template80k beside template5k is generated
    (one or two subdivisions), stamped with the v2 marker, and equal to the
    JAX package's generator's output."""
    dst = _template_dir(tmp_path) / f"template{target}k.obj"
    ensure_template(str(dst))
    assert dst.read_text().splitlines()[0] == "# " + _MARKER
    mesh = load_obj(str(dst))
    assert mesh.num_vertices == verts and mesh.num_faces == 2 * verts
    if target == 20:
        want = jax_subdivide(jax_load_obj(TEMPLATE_PATH), 20)
        np.testing.assert_allclose(mesh.v, want.v, atol=1e-6)  # %f text
        np.testing.assert_array_equal(mesh.f, want.f)


def test_ensure_template_regenerates_v1_and_refuses_unreachable(tmp_path):
    """A v1-marked file is regenerated in place; 10k (not 5 * 4^m) raises
    unless the file exists."""
    tdir = _template_dir(tmp_path)
    dst = tdir / "template20k.obj"
    dst.write_text("# meshvae_tpu scaled template v1\nv 0 0 0\n")
    ensure_template(str(dst))
    assert load_obj(str(dst)).num_vertices == 19992
    assert dst.read_text().splitlines()[0] == "# " + _MARKER
    with pytest.raises(ValueError, match="5\\*4\\^m"):
        ensure_template(str(tdir / "template10k.obj"))
    (tdir / "template10k.obj").write_text("v 0 0 0\n")
    ensure_template(str(tdir / "template10k.obj"))


def test_ensure_template_noop_cases(tmp_path):
    """An unmarked existing file is left alone; without a template5k
    sibling, or for a non-template name, nothing is written."""
    p = tmp_path / "template20k.obj"
    p.write_text("v 0 0 0\n")
    ensure_template(str(p))
    assert p.read_text() == "v 0 0 0\n"
    q = tmp_path / "sub" / "template20k.obj"
    q.parent.mkdir()
    ensure_template(str(q))
    assert not q.exists()
    r = tmp_path / "sub" / "mesh.obj"
    ensure_template(str(r))
    assert not r.exists()


def _numpy_only(monkeypatch):
    """The port's numpy host paths: its native entry points answer None,
    as they do without a compiler."""
    for name in ("qslim_decimate_native", "barycentric_transfer_native",
                 "obj_parse_native"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)


@pytest.mark.parametrize("n,target", [(12, 36), (10, 25)])
def test_native_qslim_identical_to_numpy(lib, monkeypatch, n, target):
    mesh = make_grid_mesh(n, jitter=0.05)
    calls = lib.CALLS["qslim"]
    f_nat, d_nat = qslim.qslim_decimate(mesh.v, mesh.f, target)
    assert lib.CALLS["qslim"] == calls + 1
    _numpy_only(monkeypatch)
    f_py, d_py = qslim.qslim_decimate(mesh.v, mesh.f, target)
    assert d_py.shape == d_nat.shape and d_nat.shape[0] <= target
    assert (d_py != d_nat).nnz == 0
    np.testing.assert_array_equal(f_py, f_nat)


def test_native_transfer_matches_numpy(lib, monkeypatch):
    """Same closest faces -> same sparse entries (1e-6 for fp ties), rows
    summing to 1; identity on the source's own vertices."""
    mesh = make_grid_mesh(12, jitter=0.05)
    f, d = qslim.qslim_decimate(mesh.v, mesh.f, 36)
    coarse_v = d @ mesh.v
    calls = lib.CALLS["transfer"]
    u_nat = transfer.barycentric_transfer(coarse_v, f, mesh.v)
    # the 9x9 grid of tests/test_native.py: on a 12x12 grid the ring search
    # of both packages' native transfer stops early for 2 of 144 vertices
    # (ROADMAP.md, faults: a reference caveat copied for parity)
    grid9 = make_grid_mesh(9, jitter=0.05)
    u_id = transfer.barycentric_transfer(grid9.v, grid9.f, grid9.v)
    assert lib.CALLS["transfer"] == calls + 2
    np.testing.assert_allclose(u_id @ grid9.v, grid9.v, atol=1e-9)
    np.testing.assert_allclose(np.asarray(u_nat.sum(axis=1)).ravel(), 1.0,
                               atol=1e-9)
    _numpy_only(monkeypatch)
    u_py = transfer.barycentric_transfer(coarse_v, f, mesh.v)
    diff = abs(u_py - u_nat)
    assert diff.nnz == 0 or diff.max() < 1e-6


def test_native_obj_parse_matches_python(lib, tmp_path):
    """The native parse equals the numpy parser on a written mesh and on
    template5k; a construct outside the plain dialect falls back."""
    mesh = make_grid_mesh(9, jitter=0.05)
    path = str(tmp_path / "m.obj")
    save_obj(path, mesh.v, mesh.f, comment="a comment line")
    for p in (path, TEMPLATE_PATH):
        calls = lib.CALLS["obj_parse"]
        got = load_obj(p)
        assert lib.CALLS["obj_parse"] == calls + 1
        with open(p) as fp:
            v, f = port_io._parse_obj_fast(fp.read())
        np.testing.assert_array_equal(got.v, v)
        np.testing.assert_array_equal(got.f, f)
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n")
    assert lib.obj_parse_native(str(quad)) is None
    assert load_obj(str(quad)).f.tolist() == [[0, 1, 2], [0, 2, 3]]


def test_native_template5k_hierarchy_matches_jax(lib, tmp_path,
                                                 monkeypatch):
    """template5k, factors 4,4,4,4 through the port's native library
    against the JAX package's hierarchy through its own native library
    (compiled here from meshvae_tpu/native/meshops.cpp into tmp_path, as
    its build script does): the levels, D and A equal, U within 1e-9. (The
    two packages' numpy transfers differ from the native one in 3 rows of
    level 1's U: ROADMAP.md, faults.)"""
    import meshvae_tpu.native as jax_native
    from meshvae_tpu.native.build import SRC

    jax_lib = str(tmp_path / "libmeshops.so")
    proc = subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                           "-shared", "-fPIC", SRC, "-o", jax_lib],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setattr(jax_native, "_LIB_PATH", jax_lib)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.available()
    mesh = jax_load_obj(TEMPLATE_PATH)
    calls = dict(lib.CALLS)
    got = build_hierarchy(TriMesh(mesh.v, mesh.f), [4, 4, 4, 4])
    assert lib.CALLS["qslim"] == calls["qslim"] + 4
    assert lib.CALLS["transfer"] == calls["transfer"] + 4
    want = jax_build_hierarchy(mesh, [4, 4, 4, 4])
    assert got.levels == want.levels == [4998, 1250, 313, 79, 20]
    for a, b in zip(got.adjacency, want.adjacency):
        assert (a != b).nnz == 0
    for a, b in zip(got.downsample, want.downsample):
        assert (a != b).nnz == 0
    for a, b in zip(got.upsample, want.upsample):
        assert a.shape == b.shape
        diff = abs(a - b)
        assert diff.nnz == 0 or diff.max() < 1e-9
