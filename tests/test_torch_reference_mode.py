"""The reference-migration path of meshvae_tpu_torch against the JAX package
on the CPU: hierarchy_mode = reference (the bit-exact QSlim collapse order
and the reference up-transfer) and the reference-checkpoint importer
(train/torch_import.py).

  * qslim_decimate_exact and build_hierarchy(mode="reference") bit-equal
    to the JAX package's (D, faces, A and U, np.array_equal) on grid
    meshes and on template5k (4,998 -> 1,250 -> 313 -> 79 -> 20); fast
    mode still equal to the JAX package's fast mode;
  * the hierarchy cache keeps a fast and a reference entry apart (a
    planted fast entry is never returned for the reference mode), with
    the JAX package's keys;
  * the importer against the JAX package's import_torch_vae_state on the
    same seeded state_dict with the reference's names, for cheb_VAE and
    cheb_GCN: every mapped value equal after the layout change, the dead
    dec_lin_1 and a buffer ignored, a shape mismatch raised;
  * end to end on a 10 x 10 grid, factors 2,2,2,2, in reference mode: the
    imported port MeshVAE against the imported JAX MeshVAE in eval mode
    (mu and y_hat within 1e-5, recon within 1e-4: tests/test_parity.py's
    bars), the imported ChebGCN's logits within 1e-5;
  * the importer CLI with --cpu, and its hierarchy_mode rule: reference
    unless the INI file assigns the key; its output read by
    load_model_state and served by the inference CLI."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.native as jax_native
from meshvae_tpu.mesh import hierarchy as jax_hierarchy_mod
from meshvae_tpu.mesh.qslim import qslim_decimate_exact as jax_exact
from meshvae_tpu.models.gcn import ChebGCN as JaxChebGCN
from meshvae_tpu.models.gcn import GCNConfig as JaxGCNConfig
from meshvae_tpu.models.operators import build_operators as jax_build_ops
from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
from meshvae_tpu.train.torch_import import import_torch_vae_state

from meshvae_tpu_torch import native as port_native
from meshvae_tpu_torch.config import default_config
from meshvae_tpu_torch.data import MeshDataset, list_meshes
from meshvae_tpu_torch.infer.__main__ import main as infer_main
from meshvae_tpu_torch.mesh import (TriMesh, build_hierarchy, load_obj,
                                    load_or_build_hierarchy, save_obj)
from meshvae_tpu_torch.mesh import hierarchy as port_hierarchy_mod
from meshvae_tpu_torch.mesh.qslim import qslim_decimate_exact
from meshvae_tpu_torch.models import (ChebGCN, GCNConfig, MeshVAE, VAEConfig,
                                      build_operators, params_from_flax)
from meshvae_tpu_torch.train import torch_import
from meshvae_tpu_torch.train.checkpoint import load_model_state, load_params

from conftest import TEMPLATE_PATH, make_grid_mesh
from torch_port_utils import write_requests

FILTERS, ORDERS = (8, 8, 8, 16, 16), (4, 4, 4, 4, 4)
FACTORS = [2, 2, 2, 2]


def _same_sparse(a, b) -> bool:
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def _assert_same_hierarchy(port, ref):
    """D, faces, A and U bit-equal."""
    assert port.levels == ref.levels
    for i in range(port.num_levels):
        assert np.array_equal(port.vertices[i], ref.vertices[i])
        assert np.array_equal(port.faces[i], ref.faces[i])
        assert _same_sparse(port.adjacency[i], ref.adjacency[i])
    for i in range(port.num_levels - 1):
        assert _same_sparse(port.downsample[i], ref.downsample[i]), i
        assert _same_sparse(port.upsample[i], ref.upsample[i]), i


@pytest.mark.parametrize("n,seed,target", [(8, 0, 16), (10, 1, 30),
                                           (12, 2, 20)])
def test_qslim_exact_matches_jax(n, seed, target):
    mesh = make_grid_mesh(n, jitter=0.05, seed=seed)
    faces, down = qslim_decimate_exact(mesh.v, mesh.f, target)
    ref_faces, ref_down = jax_exact(mesh.v, mesh.f, target)
    assert np.array_equal(faces, ref_faces)
    assert _same_sparse(down, ref_down)


@pytest.mark.parametrize("mode", ["reference", "fast"])
def test_grid_hierarchy_matches_jax(mode, monkeypatch):
    """Both modes bit-equal to the JAX package's on a jittered grid, U
    included; in reference mode some U row (an edge-classified vertex)
    does not sum to 1, and fast mode is what build_hierarchy gives by
    default. Fast mode pins both packages to their numpy host paths (as
    tests/test_torch_mesh.py's numpy_jax_mesh): the JAX package takes its
    C++ library only where its .so happens to be built, and a native
    transfer differs from the numpy one (tests/test_torch_scaled.py holds
    native against native)."""
    if mode == "fast":
        for lib in (jax_native, port_native):
            monkeypatch.setattr(lib, "qslim_decimate_native",
                                lambda *a, **k: None)
            monkeypatch.setattr(lib, "barycentric_transfer_native",
                                lambda *a, **k: None)
    mesh = make_grid_mesh(10, jitter=0.05)
    port = build_hierarchy(TriMesh(mesh.v, mesh.f), FACTORS, mode=mode)
    _assert_same_hierarchy(port, jax_hierarchy_mod.build_hierarchy(
        mesh, FACTORS, mode=mode))
    if mode == "fast":
        _assert_same_hierarchy(port, build_hierarchy(TriMesh(mesh.v, mesh.f),
                                                     FACTORS))
    else:
        sums = np.concatenate([np.asarray(u.sum(axis=1)).ravel()
                               for u in port.upsample])
        assert np.abs(sums - 1.0).max() > 1e-6


def test_template5k_reference_hierarchy_matches_jax():
    template = load_obj(TEMPLATE_PATH)
    port = build_hierarchy(template, [4, 4, 4, 4], mode="reference")
    assert port.levels == [4998, 1250, 313, 79, 20]
    _assert_same_hierarchy(port, jax_hierarchy_mod.build_hierarchy(
        template, [4, 4, 4, 4], mode="reference"))


def test_cache_keeps_the_modes_apart(tmp_path):
    """The fast key is the JAX package's (and earlier entries') fast key,
    the reference key is the JAX package's reference key, and a fast entry
    in the cache (planted with a wrong hierarchy) is never returned for
    hierarchy_mode = reference."""
    mesh = make_grid_mesh(10, jitter=0.05)
    tmesh = TriMesh(mesh.v, mesh.f)
    keys = {m: port_hierarchy_mod._cache_key(tmesh, FACTORS, m)
            for m in ("fast", "reference")}
    assert keys["fast"] != keys["reference"]
    assert keys["fast"] == port_hierarchy_mod._cache_key(tmesh, FACTORS)
    for m, key in keys.items():
        assert key == jax_hierarchy_mod._cache_key(mesh, FACTORS, m)
    planted = build_hierarchy(tmesh, FACTORS)
    planted.vertices[0] = planted.vertices[0] + 1.0
    port_hierarchy_mod._save(
        str(tmp_path / f"hierarchy_{keys['fast']}.npz"), planted)
    got = load_or_build_hierarchy(tmesh, FACTORS, str(tmp_path),
                                  mode="reference")
    _assert_same_hierarchy(got, build_hierarchy(tmesh, FACTORS,
                                                mode="reference"))
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"hierarchy_{k}.npz" for k in keys.values())
    again = load_or_build_hierarchy(tmesh, FACTORS, str(tmp_path))
    assert np.array_equal(again.vertices[0], planted.vertices[0])


def _reference_name(port_name: str, model_type: str) -> str:
    """The reference's name of a port parameter (the importer's inverse)."""
    layer, kind = port_name.rsplit(".", 1)
    for prefix, ref in (("cheb_enc_", "cheb"), ("cheb_dec_", "cheb_dec"),
                        ("cheb_", "cheb")):
        if layer.startswith(prefix):
            return f"{ref}.{layer[len(prefix):]}.{kind}"
    return port_name


def reference_state_dict(target: dict, model_type: str, seed: int) -> dict:
    """A seeded state_dict under the reference's names and layout (Linear
    weights [out, in], as the port's), shaped as `target`, with the dead
    dec_lin_1 head and a buffer: Chebyshev weights and biases ~ N(0, 0.1),
    Linear weights and biases ~ U(+-1/sqrt(in))."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, value in target.items():
        if value.dim() == 3 or name.startswith("cheb"):
            v = 0.1 * torch.randn(value.shape, generator=gen)
        else:
            fan_in = target[name.rsplit(".", 1)[0] + ".weight"].shape[1]
            v = (2 * torch.rand(value.shape, generator=gen) - 1) / np.sqrt(
                fan_in)
        sd[_reference_name(name, model_type)] = v
    sd["dec_lin_1.weight"] = torch.randn(3, 3, generator=gen)
    sd["dec_lin_1.bias"] = torch.randn(3, generator=gen)
    sd["cheb.0.num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.fixture(scope="module")
def reference_grid():
    """The 10 x 10 grid's reference-mode hierarchy from each package and
    their dense operators."""
    mesh = make_grid_mesh(10, jitter=0.05)
    jhier = jax_hierarchy_mod.build_hierarchy(mesh, FACTORS,
                                              mode="reference")
    phier = build_hierarchy(TriMesh(mesh.v, mesh.f), FACTORS,
                            mode="reference")
    return (jhier, jax_build_ops(jhier, cheb_method="dense",
                                 pool_method="gather"),
            phier, build_operators(phier, "cpu", cheb_method="dense"))


def _vae_pair(coarse):
    common = dict(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                  n_layers=4, num_hidden=32, latent=6, num_classes=2,
                  dropout=0.2, coarse_verts=coarse)
    return JaxMeshVAE(JaxVAEConfig(**common)), MeshVAE(VAEConfig(**common))


def _gcn_pair(coarse):
    common = dict(num_features=6, filters=FILTERS, polygon_order=ORDERS,
                  n_layers=4, num_classes=2, coarse_verts=coarse)
    return JaxChebGCN(JaxGCNConfig(**common)), ChebGCN(GCNConfig(**common))


def _imported(reference_grid, model_type, seed):
    """(JAX model, its imported params, port model with its imported
    state, the reference state_dict)."""
    jhier, jops, phier, _ = reference_grid
    n = jhier.levels[0]
    if model_type == "cheb_VAE":
        jmodel, pmodel = _vae_pair(jhier.levels[-1])
        target = jax.jit(lambda k: jmodel.init(
            {"params": k}, jnp.zeros((1, n, 3)), jnp.zeros((1, 2)), jops,
            train=False))(jax.random.key(0))
    else:
        jmodel, pmodel = _gcn_pair(jhier.levels[-1])
        target = jax.jit(lambda k: jmodel.init(
            k, jnp.zeros((1, n, 6)), jops))(jax.random.key(0))
    sd = reference_state_dict(pmodel.state_dict(), model_type, seed)
    jparams = import_torch_vae_state(sd, target, model_type=model_type)
    state = torch_import.import_reference_state(sd, pmodel.state_dict(),
                                                model_type)
    pmodel.load_state_dict(state)
    return jmodel, jparams, pmodel.eval(), sd, state


@pytest.mark.parametrize("model_type", ["cheb_VAE", "cheb_GCN"])
def test_import_matches_jax(reference_grid, model_type):
    """Every value the JAX importer maps lands in the port at the port's
    name and layout, bit for bit; every port parameter is mapped (nothing
    keeps its init), and dec_lin_1 and the buffer are ignored."""
    _, jparams, pmodel, sd, state = _imported(reference_grid, model_type, 3)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(state) == set(want) == set(pmodel.state_dict())
    for name, value in want.items():
        assert torch.equal(state[name], value), name
        assert torch.equal(state[name], sd[_reference_name(name,
                                                           model_type)])
    prefix = "cheb_enc_0" if model_type == "cheb_VAE" else "cheb_0"
    assert not any("dec_lin_1" in k or "num_batches" in k for k in state)
    assert torch.equal(state[f"{prefix}.weight"], sd["cheb.0.weight"])


def test_import_shape_mismatch_raises(reference_grid):
    _, _, pmodel, sd, _ = _imported(reference_grid, "cheb_VAE", 4)
    sd["enc_lin.weight"] = torch.randn(5, 7)
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_import.import_reference_state(sd, pmodel.state_dict())


def test_imported_vae_reproduces_the_jax_import(reference_grid):
    """Eval mode on the reference hierarchy: mu and y_hat within 1e-5,
    recon within 1e-4 of the JAX-imported model's."""
    _, jops, _, pops = reference_grid
    jmodel, jparams, pmodel, _, _ = _imported(reference_grid, "cheb_VAE", 5)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, pops.num_nodes[0], 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    ref = jmodel.apply(jparams, jnp.asarray(x), jnp.asarray(y), jops,
                       train=False)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), torch.from_numpy(y), pops)
    for key in ("mu", "y_hat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert np.abs(got["recon"].numpy() - np.asarray(ref["recon"])).max() \
        < 1e-4


def test_imported_gcn_reproduces_the_jax_import(reference_grid):
    _, jops, _, pops = reference_grid
    jmodel, jparams, pmodel, _, _ = _imported(reference_grid, "cheb_GCN", 6)
    x = np.random.default_rng(13).standard_normal(
        (4, pops.num_nodes[0], 6)).astype(np.float32)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), pops).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(
        jparams, jnp.asarray(x), jops)), rtol=1e-5, atol=1e-5)


def _cli_config(root, line: str) -> str:
    """An INI file for the grid template with `line` added."""
    mesh = make_grid_mesh(10, jitter=0.05)
    save_obj(os.path.join(root, "template.obj"), mesh.v, mesh.f)
    path = os.path.join(root, "import.cfg")
    with open(path, "w") as fp:
        fp.write("[All]\n"
                 f"template = {os.path.join(root, 'template.obj')}\n"
                 f"hierarchy_cache_dir = {os.path.join(root, 'cache')}\n"
                 "downsampling_factors = 2, 2, 2, 2\n"
                 f"num_conv_filters = {', '.join(map(str, FILTERS))}\n"
                 f"polygon_order = {', '.join(map(str, ORDERS))}\n"
                 "num_hidden = 32\nnum_style = 6\nbatch_size = 4\n"
                 "checkpoint_dir = ckpt/\n"
                 f"{line}\n")
    return path


@pytest.mark.parametrize("line,mode", [
    ("", "reference"),
    ("hierarchy_mode = fast", "fast"),
    ("# hierarchy_mode is forced to reference unless set", "reference")])
def test_import_cli(tmp_path, capsys, line, mode):
    """python -m meshvae_tpu_torch.train.torch_import REF OUT -c CFG --cpu:
    OUT holds import_reference_state of the checkpoint's state_dict, and
    the hierarchy was built in `mode` (its cache entry's key)."""
    root = str(tmp_path)
    conf = _cli_config(root, line)
    mesh = load_obj(os.path.join(root, "template.obj"))
    hier = build_hierarchy(mesh, FACTORS, mode=mode)
    pmodel = _vae_pair(hier.levels[-1])[1]
    sd = reference_state_dict(pmodel.state_dict(), "cheb_VAE", 7)
    ref_path = os.path.join(root, "ref.pt")
    torch.save({"state_dict": sd, "epoch_num": 3}, ref_path)
    out = os.path.join(root, "imported.pt")
    assert torch_import.main([ref_path, out, "-c", conf, "--cpu"]) == 0
    assert ("hierarchy_mode=reference" in capsys.readouterr().out) == (
        mode == "reference" and line == "" or line.startswith("#"))
    assert os.listdir(os.path.join(root, "cache")) == [
        f"hierarchy_{port_hierarchy_mod._cache_key(mesh, FACTORS, mode)}"
        ".npz"]
    got = load_params(out)
    want = torch_import.import_reference_state(sd, pmodel.state_dict())
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_imported_checkpoint_serves_through_the_inference_cli(tmp_path):
    """The importer's output, written as ckpt/checkpoint_1.pt, is what
    load_model_state and python -m meshvae_tpu_torch.infer -n 1 read: the
    CLI answers every mesh with finite errors, with the config's
    hierarchy_mode = reference."""
    root = str(tmp_path)
    conf = _cli_config(root, "hierarchy_mode = reference")
    mesh = load_obj(os.path.join(root, "template.obj"))
    hier = build_hierarchy(mesh, FACTORS, mode="reference")
    pmodel = _vae_pair(hier.levels[-1])[1]
    sd = reference_state_dict(pmodel.state_dict(), "cheb_VAE", 8)
    torch.save({"state_dict": sd}, os.path.join(root, "ref.pt"))
    ckpt = os.path.join(root, "ckpt", "checkpoint_1.pt")
    assert torch_import.main([os.path.join(root, "ref.pt"), ckpt, "-c", conf,
                              "--cpu"]) == 0
    state = load_model_state(ckpt)
    assert torch.equal(state["z_mean.weight"], sd["z_mean.weight"])
    data_dir = write_requests(TriMesh(mesh.v, mesh.f), root, n=5)
    dcfg = dict(default_config(), root_dir=data_dir,
                checkpoint_dir=os.path.join(root, "ckpt"))
    index, labels = list_meshes(dcfg)
    MeshDataset(index, dcfg, labels, mesh.v)  # writes ckpt/norm.npz
    out = os.path.join(root, "out")
    assert infer_main(["-c", conf, "-d", data_dir, "-o", out, "-n", "1",
                       "--no-meshes", "--cpu"]) == 0
    with open(os.path.join(out, "inference.json")) as fp:
        results = json.load(fp)
    assert len(results) == 5
    assert all(np.isfinite(r["reconstruction_error"]["mean"])
               for r in results.values())
