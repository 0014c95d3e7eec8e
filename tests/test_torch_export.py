"""meshvae_tpu_torch.infer.export against the port's live engine and the
JAX package's serving export (meshvae_tpu/infer/export.py) on the CPU, at
tests/test_export.py's small size (an 8x8 grid, factors 2,2, two layers,
B=4) with both finest levels block-sparse on both sides, so that the
artifact holds the registered operator meshvae_torch::bsr_grouped_spmm:

  * torch.library.opcheck on the operator (fp32 and bf16, with and without
    seeds, the lazy seed included);
  * export_serving_step -> file -> load_serving_step against the port's
    InferenceEngine (1e-6) and against jax.jit of the JAX package's
    make_serving_step (tests/test_parity.py's bars: pred equal, recon
    within 1e-4);
  * export_packed_serving_step behind a MeshServer with no model against
    the warm port server (rtol 1e-5, the mesh triples written) and the JAX
    artifact server; the no-meshes artifact with save_meshes raises;
  * the CLI in process: --export-serve, then --serve --artifact with the
    hierarchy, operator and checkpoint functions made to raise, answering
    as a plain --serve; --export-platforms tpu, and cuda without a card,
    exit non-zero;
  * a bf16 artifact against the live bf16 engine;
  * on a card (marked cuda): the artifact moved to the card (the kernel)
    against the same artifact on the CPU (the twin)."""
import dataclasses
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshvae_tpu_torch.data.synthetic import generate_synthetic_dataset
from meshvae_tpu_torch.infer import export
from meshvae_tpu_torch.infer.__main__ import main as infer_main
from meshvae_tpu_torch.infer.driver import InferenceEngine
from meshvae_tpu_torch.infer.serve import MeshServer, packed_step
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, save_obj
from meshvae_tpu_torch.models import (MeshVAE, VAEConfig, build_operators,
                                      params_from_flax)
from meshvae_tpu_torch.ops import bsr_spmm
from meshvae_tpu_torch.ops.block_sparse import to_block_sparse
from meshvae_tpu_torch.train.checkpoint import save_params

from conftest import make_grid_mesh

B = 4
BSR_MIN_N = 32  # levels 64 / 32 / 16: the two finest block-sparse
N_REQUESTS = 6  # a full chunk and a padded one


def _config(root, precision="highest", compute_dtype="float32"):
    from meshvae_tpu_torch.config import default_config

    config = default_config()
    config.update({
        "template": os.path.join(root, "template.obj"),
        "checkpoint_dir": "ckpt/", "n_layers": 2, "num_hidden": 16,
        "num_style": 4, "downsampling_factors": [2, 2],
        "polygon_order": [3, 3, 3], "num_conv_filters": [8, 16, 16],
        "batch_size": B, "cheb_method": "pallas",
        "hierarchy_cache_dir": os.path.join(root, "cache"),
        "matmul_precision": precision, "compute_dtype": compute_dtype})
    return config


def _grid(root):
    mesh = make_grid_mesh(8, jitter=0.05)
    save_obj(os.path.join(root, "template.obj"), mesh.v, mesh.f)
    return build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2])


def _norm(n):
    rng = np.random.default_rng(7)
    return ((0.01 * rng.standard_normal((n, 3))).astype(np.float32),
            (1.0 + 0.1 * rng.random((n, 3))).astype(np.float32))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The grid, its hierarchy, the JAX package's modules, model, operators
    and params (trainer.init_params(key(0))), the port's model and
    operators from the same params, the norm statistics and a request
    directory. JAX and flax are imported here, so that the file collects
    where flax is absent (the card's machine runs its cuda test)."""
    import jax

    import meshvae_tpu.ops.graph as jax_graph
    import meshvae_tpu.ops.pallas_cheb as pc
    from meshvae_tpu.infer import export as jax_export
    from meshvae_tpu.infer.serve import MeshServer as JaxServer
    from meshvae_tpu.models.operators import build_operators as jax_build_ops
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
    from meshvae_tpu.train.driver import make_trainer as jax_make_trainer
    from torch_port_utils import jax_hierarchy

    root = str(tmp_path_factory.mktemp("torch_export"))
    hier = _grid(root)
    config = _config(root)
    old = jax_graph.PALLAS_MIN_N, pc.INTERPRET
    jax_graph.PALLAS_MIN_N, pc.INTERPRET = BSR_MIN_N, True
    try:
        jops = jax_build_ops(jax_hierarchy(hier), cheb_method="pallas",
                             pool_method="gather")
        jcfg = JaxVAEConfig(
            num_features=3, filters=(8, 16, 16), polygon_order=(3, 3, 3),
            n_layers=2, num_hidden=16, latent=4, num_classes=2, dropout=0.2,
            coarse_verts=hier.levels[-1], cheb_method="pallas",
            precision="highest")
        jmodel = JaxMeshVAE(jcfg)
        # params do not depend on the operator layout: init on the dense
        # path
        dense = jax_build_ops(jax_hierarchy(hier), cheb_method="dense",
                              pool_method="gather")
        params = jax.tree_util.tree_map(np.asarray, jax_make_trainer(
            config, JaxMeshVAE(dataclasses.replace(jcfg, cheb_method="dense")),
            dense).init_params(jax.random.key(0)))
    finally:
        jax_graph.PALLAS_MIN_N, pc.INTERPRET = old
    pmodel, pops = _port(hier, config, params)
    mean, std = _norm(hier.levels[0])
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(TriMesh(hier.vertices[0], hier.faces[0]),
                               data_dir, n_samples=N_REQUESTS, seed=1)
    jx = types.SimpleNamespace(jax=jax, pc=pc, export=jax_export,
                               server=JaxServer)
    return dict(root=root, hier=hier, config=config, jmodel=jmodel,
                jops=jops, params=params, pmodel=pmodel, pops=pops,
                mean=mean, std=std, data_dir=data_dir, jx=jx)


@pytest.fixture
def interpret(small, monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, as its own
    tests run them on the CPU."""
    monkeypatch.setattr(small["jx"].pc, "INTERPRET", True)


def _port(hier, config, params):
    cfg = VAEConfig.from_config(config, coarse_verts=hier.levels[-1])
    model = MeshVAE(cfg)
    model.load_state_dict(params_from_flax(params))
    ops = build_operators(hier, "cpu", cheb_method="pallas",
                          bsr_min_n=BSR_MIN_N, dtype=cfg.dtype)
    assert ops.lap[0].bsr is not None and ops.lap[1].bsr is not None
    return model.eval(), ops


def _batch(n, seed=3):
    """tests/test_export.py's _fake_batch."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((B, 3, 3)))
    s = (1.0 + rng.random(B)).astype(np.float32)
    m = rng.standard_normal((B, 1, 3)).astype(np.float32)
    return x, q.astype(np.float32), s, m


def _op_args(dtype, seeds):
    rng = np.random.default_rng(5)
    rows = np.repeat(np.arange(200), 5)
    cols = np.clip(rows + rng.integers(-40, 40, rows.size), 0, 199)
    mat = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                        shape=(200, 200))
    bsr = to_block_sparse(mat, "cpu", dtype=dtype)
    c = 64
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
    x = t(bsr.n_pad_cols, c)
    mode = "bf16" if dtype == torch.bfloat16 else "fp32"
    plus, prev, gm, wt = (None,) * 4
    if seeds == "plus prev":
        plus, prev = t(bsr.n_pad, c), t(bsr.n_pad, c)
    elif seeds == "dot prev":
        gm, wt, prev = t(bsr.n_pad, c), t(16, 16), t(bsr.n_pad, c)
    return (bsr.blocks, bsr.g_idx, bsr.g_bcol, bsr.tile_mask, x, plus, prev,
            gm, wt, bsr.n_pad, bsr.n_pad_cols, bsr_spmm.MODES.index(mode),
            2.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seeds", ["none", "plus prev", "dot prev"])
def test_operator_passes_opcheck(dtype, seeds):
    """The registered operator's schema, fake implementation and dispatch
    (torch.library.opcheck), and its CPU implementation equal to the
    twin."""
    args = _op_args(dtype, seeds)
    torch.library.opcheck(bsr_spmm.bsr_grouped_spmm_op, args)
    blocks, g_idx, g_bcol, mask, x, plus, prev, gm, wt, n_pad, n_cols, \
        mode, alpha = args
    bsr = bsr_spmm._operator_of(blocks, g_idx, g_bcol, mask, n_pad, n_cols)
    want = bsr_spmm.bsr_grouped_spmm_reference(
        bsr, x, bsr_spmm.MODES[mode], alpha, plus, prev,
        None if gm is None else (gm, wt))
    got = torch.ops.meshvae_torch.bsr_grouped_spmm(*args)
    assert got.dtype == dtype and torch.equal(got, want)


def _tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_artifact_matches_live_engine_and_jax(small, interpret, tmp_path):
    """The plain contract through a file: outputs within 1e-6 of the port's
    live InferenceEngine, and pred equal / recon within 1e-4 of the JAX
    package's jitted make_serving_step on the same params; the file's
    program calls the registered operator 8 times (the encoder's and the
    decoder's convs on the two block-sparse levels, K - 1 = 2 each)."""
    hier, mean, std = small["hier"], small["mean"], small["std"]
    n = hier.levels[0]
    data = export.export_serving_step(small["pmodel"], small["pops"], mean,
                                      std, batch_size=B, num_vertices=n)
    path = str(tmp_path / "serve.pt2")
    export.save_serving_artifact(path, data)
    step = export.load_serving_step(path, "cpu")
    assert step.header["contract"] == "plain"
    assert step.header["platforms"] == ["cpu"]
    calls = [nd for nd in step.program.graph.nodes
             if nd.target is torch.ops.meshvae_torch.bsr_grouped_spmm.default]
    assert len(calls) == 8
    x, r, s, m = _batch(n)
    got = step(*_tensors(x, r, s, m))
    live = InferenceEngine(small["pmodel"], small["pops"]).step(
        dict(zip("xrsm", _tensors(x, r, s, m))), torch.from_numpy(mean),
        torch.from_numpy(std))
    assert set(got) == {"pred", "recon_orig", "oppo_orig"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), live[k].numpy(),
                                   rtol=1e-6, atol=1e-6)
    jx = small["jx"]
    ref = jx.jax.jit(jx.export.make_serving_step(
        small["jmodel"], small["jops"], small["params"], mean, std))(
            x, r, s, m)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(ref["pred"]))
    for k in ("recon_orig", "oppo_orig"):
        assert np.abs(got[k].numpy() - np.asarray(ref[k])).max() < 1e-4, k


def _serve(server, lines):
    fout = io.StringIO()
    try:
        server.serve_forever(io.StringIO("".join(l + "\n" for l in lines)),
                             fout)
    finally:
        if hasattr(server, "close"):
            server.close()
    return [json.loads(l) for l in fout.getvalue().splitlines()]


def test_packed_artifact_serves_as_the_warm_server(small, interpret,
                                                  tmp_path):
    """A MeshServer with no model on the --export-serve contract answers
    one mesh and the request directory (a full and a padded chunk) as the
    warm port server does (rtol 1e-5) and writes the mesh triples equal to
    its; the JAX artifact server answers the same at the parity bars; the
    no-meshes artifact meets save_meshes with a RuntimeError."""
    hier, mean, std = small["hier"], small["mean"], small["std"]
    n = hier.levels[0]
    tmpl = (hier.vertices[0], hier.faces[0])
    files = sorted(os.listdir(small["data_dir"]))
    lines = [os.path.join(small["data_dir"], files[0]), small["data_dir"]]
    kw = dict(template=tmpl[0], faces=tmpl[1], batch_size=B,
              save_meshes=True)
    step = export.load_serving_step(export.export_packed_serving_step(
        small["pmodel"], small["pops"], mean, std, B, n), "cpu")
    assert step.header["wire_dtype"] == "float16"
    got = _serve(MeshServer(None, None, mean, std, device="cpu",
                            output_path=str(tmp_path / "artifact"),
                            serving_step=step, **kw), lines)
    want = _serve(MeshServer(small["pmodel"], small["pops"], mean, std,
                             device="cpu", output_path=str(tmp_path / "warm"),
                             **kw), lines)
    jx = small["jx"]
    jstep = jx.export.load_serving_step(jx.export.export_packed_serving_step(
        small["jmodel"], small["jops"], small["params"], mean, std, B, n))
    jax_lines = _serve(jx.server(None, None, None, mean, std,
                                 output_path=str(tmp_path / "jax"),
                                 serving_step=jstep, **kw), lines)
    assert len(got) == len(want) == len(jax_lines) == N_REQUESTS + 3
    for g, w, j in zip(got, want, jax_lines):
        assert set(g) == set(w) == set(j)
        if "file" not in g:
            assert g["done"] == w["done"] == j["done"]
            continue
        assert g["file"] == w["file"] and g["sex"] == w["sex"] == j["sex"]
        for k in ("mean", "max"):
            e = g["reconstruction_error"][k]
            assert e == pytest.approx(w["reconstruction_error"][k], rel=1e-5)
            assert abs(e - j["reconstruction_error"][k]) < 1e-4
        for key in ("recon", "oppo"):
            a = np.loadtxt(g[key], usecols=(1, 2, 3), comments="f")
            b = np.loadtxt(w[key], usecols=(1, 2, 3), comments="f")
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    light = export.load_serving_step(export.export_packed_serving_step(
        small["pmodel"], small["pops"], mean, std, B, n,
        collect_meshes=False), "cpu")
    server = MeshServer(None, None, mean, std, device="cpu",
                        output_path=str(tmp_path / "light"),
                        serving_step=light, **kw)
    try:
        with pytest.raises(RuntimeError, match="without mesh outputs"):
            server.warmup()
    finally:
        server.close()


def _write_cli_env(small, root):
    """infer.cfg (checkpoint_dir relative to it), the port's params as
    ckpt/checkpoint_1.pt and the norm as ckpt/norm.npz."""
    os.makedirs(os.path.join(root, "ckpt"))
    save_params(os.path.join(root, "ckpt", "checkpoint_1.pt"),
                small["pmodel"].state_dict())
    np.savez(os.path.join(root, "ckpt", "norm.npz"), mean=small["mean"],
             std=small["std"])
    config = small["config"]
    path = os.path.join(root, "infer.cfg")
    with open(path, "w") as fp:
        fp.write("[All]\n")
        for k in ("template", "checkpoint_dir", "hierarchy_cache_dir",
                  "n_layers", "num_hidden", "num_style",
                  "downsampling_factors", "polygon_order",
                  "num_conv_filters", "batch_size", "cheb_method",
                  "matmul_precision"):
            v = config[k]
            v = ", ".join(map(str, v)) if isinstance(v, (list, tuple)) else v
            fp.write(f"{k} = {v}\n")
    return path


def _served_lines(capsys, monkeypatch, argv, request):
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(request + "\n"))
    assert infer_main(argv) == 0
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def test_cli_exports_and_cold_starts(small, tmp_path, capsys, monkeypatch):
    """--export-serve P --no-meshes --cpu writes the artifact; --serve
    --artifact P --cpu then answers the request directory with the
    hierarchy build, the operator build and the checkpoint loader made to
    raise, and its lines equal a plain --serve --cpu run's (the ready line
    names the artifact)."""
    import functools

    import meshvae_tpu_torch.mesh.hierarchy as port_hierarchy
    import meshvae_tpu_torch.models.operators as port_operators
    import meshvae_tpu_torch.train.checkpoint as port_checkpoint
    import meshvae_tpu_torch.train.driver as port_driver

    cfg = _write_cli_env(small, str(tmp_path))
    base = ["-c", cfg, "-d", small["data_dir"], "-n", "1", "--cpu",
            "--no-meshes", "-o", str(tmp_path / "out")]
    art = str(tmp_path / "serve.pt2")
    monkeypatch.setattr(port_driver, "build_operators", functools.partial(
        build_operators, bsr_min_n=BSR_MIN_N))
    capsys.readouterr()
    assert infer_main([*base, "--export-serve", art]) == 0
    assert f"serve artifact written to {art}" in capsys.readouterr().out
    want = _served_lines(capsys, monkeypatch, [*base, "--serve"],
                         small["data_dir"])

    def refuse(*args, **kwargs):
        raise AssertionError("the artifact's cold start built or loaded it")

    for module, name in ((port_hierarchy, "build_hierarchy"),
                         (port_hierarchy, "load_or_build_hierarchy"),
                         (port_driver, "load_or_build_hierarchy"),
                         (port_driver, "build_operators"),
                         (port_operators, "build_operators"),
                         (port_checkpoint, "load_model_state"),
                         (port_checkpoint, "find_checkpoint")):
        monkeypatch.setattr(module, name, refuse)
    got = _served_lines(capsys, monkeypatch,
                        [*base, "--serve", "--artifact", art],
                        small["data_dir"])
    assert got[0]["ready"] is True and got[0]["artifact"] == art
    assert got[-1]["done"] == N_REQUESTS
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert set(g) == set(w)
        if "file" in g:
            assert g["file"] == w["file"] and g["sex"] == w["sex"]
            for k in ("mean", "max"):
                assert g["reconstruction_error"][k] == pytest.approx(
                    w["reconstruction_error"][k], rel=1e-5)


@pytest.mark.parametrize("platforms", ["tpu", "cpu,tpu", "cuda"])
def test_cli_refuses_unknown_or_absent_platforms(small, tmp_path, capsys,
                                                 platforms):
    """A platform outside cpu/cuda exits non-zero naming the accepted ones;
    cuda exits non-zero without a card (and without --device cuda), and
    nothing is written."""
    cfg = _write_cli_env(small, str(tmp_path))
    art = str(tmp_path / "a.pt2")
    capsys.readouterr()
    rc = infer_main(["-c", cfg, "-d", small["data_dir"], "--cpu",
                     "--export", art, "--export-platforms", platforms])
    err = capsys.readouterr().err
    assert rc != 0 and not os.path.exists(art)
    if "tpu" in platforms:
        assert "'cpu', 'cuda'" in err
    else:
        assert "cuda" in err


def test_bf16_artifact_matches_live_engine(small):
    """compute_dtype bfloat16 (bf16 operators, the operator's bf16 mode):
    the packed artifact equals the live bf16 engine's packed step to
    1e-6."""
    hier, mean, std = small["hier"], small["mean"], small["std"]
    config = _config(small["root"], compute_dtype="bfloat16")
    model, ops = _port(hier, config, small["params"])
    assert ops.lap[0].bsr.blocks.dtype == torch.bfloat16
    step = export.load_serving_step(export.export_packed_serving_step(
        model, ops, mean, std, B, hier.levels[0]), "cpu")
    assert step.header["compute_dtype"] == "bfloat16"
    x, r, s, m = _batch(hier.levels[0], seed=9)
    args = _tensors(x.astype(np.float16), r, s, m)
    got = step(*args)
    live = packed_step(InferenceEngine(model, ops).step,
                       dict(zip("xrsm", args)), torch.from_numpy(mean),
                       torch.from_numpy(std), True)
    for k in live:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   live[k].float().numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_export_from_a_world_is_refused(small):
    """The artifact is one process's step: operators sharded over sp are
    refused."""
    ops = small["pops"]
    sharded = dataclasses.replace(
        ops, lap=(dataclasses.replace(ops.lap[0], bsr_sp=object()),)
        + ops.lap[1:])
    with pytest.raises(ValueError, match="single-process"):
        export.make_serving_step(small["pmodel"], sharded, small["mean"],
                                 small["std"])


@pytest.mark.cuda
def test_cuda_lowering_matches_cpu_lowering(tmp_path):
    """On a card: one packed artifact exported there for cuda and cpu, the
    program moved to the card (the registered operator launches the
    kernel) against the same program on the CPU (the twin), on seeded
    weights: pred equal, meshes and errors within 1e-4 of the mesh
    scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    hier = _grid(str(tmp_path))
    config = _config(str(tmp_path))
    model = MeshVAE(VAEConfig.from_config(config, hier.levels[-1]),
                    generator=torch.Generator().manual_seed(0))
    ops = build_operators(hier, "cuda", cheb_method="pallas",
                          bsr_min_n=BSR_MIN_N)
    n = hier.levels[0]
    mean, std = _norm(n)
    data = export.export_packed_serving_step(
        model.to("cuda").eval(), ops, mean, std, B, n,
        platforms=("cuda", "cpu"))
    x, r, s, m = _batch(n, seed=4)
    args = _tensors(x.astype(np.float16), r, s, m)
    cpu = export.load_serving_step(data, "cpu")(*args)
    card = export.load_serving_step(data, "cuda")(
        *[a.to("cuda") for a in args])
    scale = float(np.abs(cpu["recon_orig"].numpy()).max())
    np.testing.assert_array_equal(card["packed"][0].cpu().numpy(),
                                  cpu["packed"][0].numpy())
    for k in ("recon_orig", "oppo_orig"):
        assert (card[k].cpu() - cpu[k]).abs().max().item() <= 1e-4 * scale
    assert (card["packed"][1:].cpu() - cpu["packed"][1:]).abs().max() \
        .item() <= 1e-4 * scale
