"""meshvae_tpu_torch.infer against the JAX package: InferenceEngine.step vs
_step_impl, MeshServer stdio answers vs the JAX MeshServer (chunking,
padding, the error line), the CLI entry point, the package's import
isolation from JAX, device selection, and (on a card) the CUDA kernel
against its plain twin."""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.infer.driver import InferenceEngine as JaxEngine
from meshvae_tpu.infer.serve import MeshServer as JaxServer

from meshvae_tpu_torch.infer.driver import InferenceEngine
from meshvae_tpu_torch.infer.serve import MeshServer
from meshvae_tpu_torch.mesh import TriMesh, save_obj

from torch_port_utils import grid_hierarchy, paired_models, write_requests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_serve"))
    mesh, hier = grid_hierarchy()
    template = TriMesh(hier.vertices[0], hier.faces[0])
    data_dir = write_requests(template, root, n=6)  # 2 chunks at batch 4
    rng = np.random.default_rng(2)
    n = hier.levels[0]
    mean = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    std = (0.5 + rng.random((n, 3))).astype(np.float32)
    return root, hier, template, data_dir, mean, std


def _servers(env, precision):
    root, hier, template, data_dir, mean, std = env
    jmodel, jops, params, pmodel, pops = paired_models(hier, precision)
    kw = dict(template=template.v, faces=template.f, batch_size=BATCH,
              output_path=os.path.join(root, precision), save_meshes=False)
    port = MeshServer(pmodel, pops, mean, std, device="cpu", **kw)
    ref = JaxServer(jmodel, jops, params, mean, std, **kw)
    return port, ref, (jmodel, jops, params)


def _scale(batch):
    return float(np.abs(batch["original"]).max())


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_engine_step_matches_jax(env, precision):
    root, hier, template, data_dir, mean, std = env
    port, ref, (jmodel, jops, params) = _servers(env, precision)
    try:
        files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
        host = port.preprocess(files[:BATCH])
        host["x"] = host["x"].astype(np.float32)
        got = InferenceEngine(port.engine.model, port.engine.ops).step(
            {k: torch.from_numpy(v) for k, v in host.items()},
            torch.from_numpy(mean), torch.from_numpy(std))
        want = JaxEngine(jmodel, jops)._step_impl(
            params, {k: jnp.asarray(v) for k, v in host.items()},
            jnp.asarray(mean), jnp.asarray(std), jops)
    finally:
        port.close()
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    scale = _scale(host)
    for key in ("recon_orig", "oppo_orig", "err_mean", "err_max"):
        delta = np.abs(got[key].numpy() - np.asarray(want[key])).max()
        assert delta <= 1e-4 * scale, (key, delta, scale)


def _serve(server, lines):
    fout = io.StringIO()
    server.serve_forever(io.StringIO("".join(l + "\n" for l in lines)), fout)
    return [json.loads(l) for l in fout.getvalue().splitlines()]


def test_server_stdio_matches_jax(env):
    """One mesh, a directory of 6 (a full chunk and a padded one), a blank
    line and a bad path: same lines, keys and labels; errors within 1e-4
    of the mesh scale."""
    root, hier, template, data_dir, mean, std = env
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
    lines = [files[0], data_dir, "", "/nonexistent/mesh.obj"]
    port, ref, _ = _servers(env, "high")
    try:
        got = _serve(port, lines)
        want = _serve(ref, lines)
    finally:
        port.close()
    assert len(got) == len(want) == 1 + 1 + 6 + 1 + 1
    scale = float(np.abs(port.preprocess(files)["original"]).max())
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if "file" in g:
            assert g["file"] == w["file"] and g["sex"] == w["sex"]
            for k in ("mean", "max"):
                assert abs(g["reconstruction_error"][k]
                           - w["reconstruction_error"][k]) <= 1e-4 * scale
        elif "done" in g:
            assert g["done"] == w["done"]
        else:
            assert g == w and "error" in g


def test_server_padding_and_mesh_triples(env, tmp_path):
    """Chunked answers equal lone answers (padding rows never leak), and
    save_meshes writes the recon/gt/oppo triple."""
    root, hier, template, data_dir, mean, std = env
    _, _, _, pmodel, pops = paired_models(hier, "highest")
    server = MeshServer(pmodel, pops, mean, std, template=template.v,
                        faces=template.f, batch_size=BATCH,
                        output_path=str(tmp_path), save_meshes=True,
                        device="cpu")
    try:
        assert server.warmup() >= 0.0
        files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
        lone = {os.path.basename(p): server.handle([p])[0] for p in files}
        for res in server.handle(files):
            ref = lone[res["file"]]
            assert res["sex"] == ref["sex"]
            np.testing.assert_allclose(res["reconstruction_error"]["mean"],
                                       ref["reconstruction_error"]["mean"],
                                       rtol=1e-5)
            assert os.path.exists(res["recon"]) and os.path.exists(res["oppo"])
        stem = os.path.basename(files[0]).rsplit(".", 1)[0]
        assert os.path.exists(os.path.join(server.mesh_dir, stem + "_gt.obj"))
    finally:
        server.close()


def test_vertex_count_mismatch_is_reported(env, tmp_path):
    root, hier, template, data_dir, mean, std = env
    _, _, _, pmodel, pops = paired_models(hier, "highest")
    bad = str(tmp_path / "bad.obj")
    save_obj(bad, np.zeros((5, 3)), np.array([[0, 1, 2]]))
    server = MeshServer(pmodel, pops, mean, std, template=template.v,
                        faces=template.f, batch_size=BATCH, device="cpu")
    try:
        [line] = _serve(server, [bad])
    finally:
        server.close()
    assert "error" in line and "vertices" in line["error"]


def test_cli_entry_point(env, tmp_path):
    """python -m meshvae_tpu_torch.infer.serve: ready line, one request,
    JSON answers, clean EOF shutdown."""
    root, hier, template, data_dir, mean, std = env
    tmpl_path = str(tmp_path / "template.obj")
    save_obj(tmpl_path, template.v, template.f)
    cfg = str(tmp_path / "serve.cfg")
    with open(cfg, "w") as fp:
        fp.write("[Input Output]\n"
                 f"template = {tmpl_path}\n"
                 f"hierarchy_cache_dir = {tmp_path / 'cache'}\n"
                 "downsampling_factors = 2, 2, 2, 2\n"
                 "num_conv_filters = 8, 8, 8, 16, 16\n"
                 "polygon_order = 3, 3, 3, 3, 3\n"
                 "num_hidden = 32\nnum_style = 6\nbatch_size = 4\n"
                 "cheb_method = pallas\nmatmul_precision = high\n")
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
    proc = subprocess.run(
        [sys.executable, "-m", "meshvae_tpu_torch.infer.serve", "-c", cfg,
         "-p", "num_style", "4", "--device", "cpu", "--no-meshes",
         "--seed", "3"],
        input=files[0] + "\n", capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = [json.loads(l) for l in proc.stdout.splitlines()]
    assert out[0]["ready"] is True and out[0]["batch_size"] == 4
    [res] = [l for l in out if "file" in l]
    assert res["sex"] in (0, 1) and np.isfinite(
        res["reconstruction_error"]["mean"])
    assert out[-1]["done"] == 1


def test_package_imports_no_jax():
    """Importing every module of the port (train/__main__.py,
    infer/__main__.py, train/flax_msgpack.py, ops/cheb_fused.py,
    ops/emitted_spmm.py, bench/, parallel/, ops/bsr_shard.py, validate.py,
    and the classifier pipelines' models/gcn.py, models/joint.py,
    train/joint.py, train/crecon_driver.py and the crecon CLI, the
    reference-checkpoint importer train/torch_import.py, the serving
    export infer/export.py, models/experimental.py and the host-only
    report and plot_losses entry points included)
    leaves jax, flax, optax, scikit-learn, msgpack, meshvae_tpu and
    matplotlib out of sys.modules, builds and loads no library (no CUDA
    kernel, nor the native host library) and starts no torch.distributed
    process group."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import meshvae_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'sklearn',\n"
        "              'msgpack', 'meshvae_tpu', 'matplotlib'))\n"
        "from meshvae_tpu_torch import native\n"
        "from meshvae_tpu_torch.ops import bsr_spmm, cheb_fused, "
        "emitted_spmm\n"
        "for name, fn in (('native', native.library),\n"
        "                 ('kernel', bsr_spmm._lib),\n"
        "                 ('fused kernel', cheb_fused._lib),\n"
        "                 ('emitted kernel', emitted_spmm._lib)):\n"
        "    if fn.cache_info().currsize:\n"
        "        bad.append(name + ' loaded at import')\n"
        "for name in ('parallel', 'parallel.sharding', 'ops.bsr_shard',\n"
        "             'validate', 'models.gcn', 'models.joint',\n"
        "             'train.joint', 'train.crecon_driver', 'crecon',\n"
        "             'train.torch_import', 'infer.export',\n"
        "             'models.experimental', 'report', 'plot_losses'):\n"
        "    if 'meshvae_tpu_torch.' + name not in sys.modules:\n"
        "        bad.append(name + ' not imported')\n"
        "import torch.distributed as dist\n"
        "if dist.is_available() and dist.is_initialized():\n"
        "    bad.append('a process group started at import')\n"
        "print(len([k for k in sys.modules\n"
        "           if k.startswith('meshvae_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert int(proc.stdout.split()[0]) >= 20


def test_default_device_without_cuda_raises(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from meshvae_tpu_torch.device import resolve_device
    from meshvae_tpu_torch.models import build_operators

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        build_operators(env[1])  # device defaults to "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16x3"])
def test_cuda_kernel_matches_twin(env, mode):
    """The CUDA kernel against its plain twin on the card, with padded
    slots, both seeds and a rectangular x; 1e-5 of max |y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import scipy.sparse as sp

    from meshvae_tpu_torch.ops.block_sparse import to_block_sparse
    from meshvae_tpu_torch.ops.bsr_spmm import (LAUNCHES, bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(1000), 6)
    cols = np.clip(rows + rng.integers(-200, 300, rows.size), 0, 1499)
    for shape in ((1000, 1000), (1000, 1500)):
        mat = sp.csr_matrix((rng.standard_normal(rows.size),
                             (rows, np.minimum(cols, shape[1] - 1))),
                            shape=shape)
        bsr = to_block_sparse(mat, "cuda", allow_rect=shape[0] != shape[1])
        for c in (128, 192):
            x = torch.randn(bsr.n_pad_cols, c, device="cuda")
            tp, tm = (torch.randn(bsr.n_pad, c, device="cuda")
                      for _ in range(2))
            before = LAUNCHES[mode]
            y = bsr_grouped_spmm(bsr, x, mode, 2.0, t_plus=tp, t_prev=tm)
            torch.cuda.synchronize()
            assert LAUNCHES[mode] == before + 1
            ref = bsr_grouped_spmm_reference(bsr, x, mode, 2.0, t_plus=tp,
                                             t_prev=tm)
            assert ((y - ref).abs().max() / ref.abs().max()).item() < 1e-5
