"""compute_dtype=bfloat16 in meshvae_tpu_torch against the JAX package's
bf16 mode (bf16 operators, bf16 state, fp32 accumulation). The JAX Pallas
kernels run in interpret mode.

Kernel: the plain twin of ``bsr_grouped_spmm[bf16]`` against TPU kernel
#3b (``_grouped_matmul`` with bf16 blocks and a bf16 output, R=1 and
multi-row) within one bf16 ulp, 2^-8 max|y| (measured: equal); against the
per-block #5 and column-major #7 kernels in bf16 on a rectangular operator
with G = 12 > 8 within (G + 1) ulps, their repeated rounding (measured:
about 2 ulps).

Conv, eval forward, train step: the port's bf16 result must be closer to
JAX's bf16 result than JAX's bf16 is to JAX's fp32 result (up to one bf16
ulp of the scale, see torch_port_utils.closer), and within 5e-2 of max|y| (of the layer's
max|g| for a gradient), the JAX package's own bf16 bar
(tests/test_models.py:253, tests/test_pallas.py:276). The deltas are
printed (pytest -s); the measured ones are quoted in the test docstrings."""
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.ops.block_sparse import to_block_sparse as jax_to_bsr
from meshvae_tpu.infer.driver import run_inference as jax_run_inference
from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
from meshvae_tpu.ops.cheb import cheb_conv as jax_cheb_conv
from meshvae_tpu.train import loop as jax_loop

from meshvae_tpu_torch.data import BatchIterator, MeshDataset, list_meshes
from meshvae_tpu_torch.infer.driver import InferenceEngine, run_inference
from meshvae_tpu_torch.infer.serve import MeshServer
from meshvae_tpu_torch.mesh import load_obj
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, vertex_adjacency
from meshvae_tpu_torch.models import VAEConfig, params_from_flax
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops import graph
from meshvae_tpu_torch.ops import pool as port_pool
from meshvae_tpu_torch.ops.block_sparse import to_block_sparse
from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm_reference
from meshvae_tpu_torch.ops.cheb import cheb_conv, resolve_precision
from meshvae_tpu_torch.train import Trainer, unpack_metrics

from conftest import make_grid_mesh
from torch_port_utils import (ULP, FedNoise, bf16_ulp, closer,
                              count_kernel_calls, feed_noise, grid_hierarchy,
                              paired_models, paired_operators, settled_rows,
                              to_np as _np, write_requests)

BF = torch.bfloat16
BATCH, TGRAD = 16, 6     # as tests/test_torch_train.py: three P^T kernels
CONFIG = {"num_classes": 2, "learning_rate": 1e-3, "weight_decay": 5e-4}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


def _to_jax_bf16(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _twin_vs_jax(port_bsr, ref_bsr, c, seeds, alpha, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((port_bsr.n_pad_cols, c)).astype(np.float32)
    extra = {k: rng.standard_normal((port_bsr.n_pad, c)).astype(np.float32)
             for k in seeds}
    got = bsr_grouped_spmm_reference(
        port_bsr, torch.from_numpy(x).to(BF), "bf16", alpha,
        **{k: torch.from_numpy(v).to(BF) for k, v in extra.items()})
    want = pc._bsr_matmul_impl(
        ref_bsr, _to_jax_bf16(x), jax.lax.Precision.DEFAULT, alpha=alpha,
        **{k: _to_jax_bf16(v) for k, v in extra.items()})
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    return _np(got), _np(want)


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        real = getattr(pc, name)

        def spied(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(pc, name, spied)
    return calls


@pytest.fixture(scope="module")
def grid_lap():
    mesh = make_grid_mesh(32, jitter=0.05)
    return graph.normalized_neg_adjacency(
        vertex_adjacency(mesh.num_vertices, mesh.f))


@pytest.mark.parametrize("rows,alpha,seeds", [
    (1, 1.0, ()), (1, 2.0, ()), (1, 1.0, ("t_prev",)), (1, 2.0, ("t_prev",)),
    (1, 1.0, ("t_plus",)), (1, 2.0, ("t_plus",)),
    (1, 1.0, ("t_plus", "t_prev")), (1, 2.0, ("t_plus", "t_prev")),
    (2, 2.0, ("t_prev",)), (2, 2.0, ("t_plus", "t_prev"))])
def test_twin_matches_grouped_kernel_bf16(monkeypatch, grid_lap, rows, alpha,
                                          seeds):
    """TPU kernel #3b: _make_grouped_kernel (one row-block per step) and
    _make_multirow_kernel (two) with bf16 blocks, bf16 x and seeds and a
    bf16 output. Both round once after alpha and the seeds, so the twin
    agrees within one bf16 ulp (2^-8 max|y|), in bf16."""
    monkeypatch.setattr(pc, "GROUP_ROWS", rows)
    ref_bsr = jax_to_bsr(grid_lap, dtype=jnp.bfloat16)
    port_bsr = to_block_sparse(grid_lap, "cpu", dtype=BF)
    np.testing.assert_array_equal(_np(port_bsr.blocks), _np(ref_bsr.blocks))
    kernel = "_make_grouped_kernel" if rows == 1 else "_make_multirow_kernel"
    calls = _spy(monkeypatch, ["_make_grouped_kernel",
                               "_make_multirow_kernel"])
    got, want = _twin_vs_jax(port_bsr, ref_bsr, 256, seeds, alpha)
    assert calls == [kernel]
    assert np.abs(got - want).max() <= ULP * np.abs(want).max()


def _wide_rect(seed=21, shape=(300, 1500), density=0.02):
    """Row blocks spanning all 12 column blocks: more than MAX_GROUP = 8,
    so the JAX BSR has no grouped view (as the 80k template's P^T of
    up-pools 0-2, G = 25, 15, 10)."""
    import scipy.sparse as sp

    return sp.random(*shape, density=density, format="csr",
                     random_state=np.random.default_rng(seed),
                     dtype=np.float32)


@pytest.mark.parametrize("kernel", ["_make_colmajor_kernel",
                                    "_make_spmm_kernel"])
def test_twin_matches_wide_row_kernels_bf16(monkeypatch, kernel):
    """TPU kernels #7 (column-major) and #5 (per-block) with bf16 blocks
    and a bf16 output, both seeds, alpha 2: they round the output block
    after every slot (pallas_cheb._accumulate), the twin once, so the bar
    is (G + 1) bf16 ulps of max|y|."""
    if kernel == "_make_colmajor_kernel":
        monkeypatch.setattr(pc, "FORCE_COLMAJOR", True)
    else:
        monkeypatch.setattr(pc, "GROUPED", False)
        monkeypatch.setattr(pc, "COLMAJOR_VMEM_BUDGET", 0)
    mat = _wide_rect()
    ref_bsr = jax_to_bsr(mat, allow_rect=True, dtype=jnp.bfloat16)
    port_bsr = to_block_sparse(mat, "cpu", allow_rect=True, dtype=BF)
    g = port_bsr.g_width
    assert ref_bsr.g_idx is None and g == 12
    calls = _spy(monkeypatch, [kernel])
    got, want = _twin_vs_jax(port_bsr, ref_bsr, 256, ("t_plus", "t_prev"),
                             2.0, seed=4)
    assert calls == [kernel]
    delta = np.abs(got - want).max()
    print(f"{kernel}: max delta {delta / (ULP * np.abs(want).max()):.2f} "
          f"ulps (bar {g + 1})")
    assert delta <= (g + 1) * ULP * np.abs(want).max()


@pytest.fixture(scope="module")
def conv_ops():
    """A 1024-vertex grid level as BSR and dense, and the embedded
    final-conv operator, each as (port bf16, JAX bf16, JAX fp32, method)."""
    mesh = make_grid_mesh(32, jitter=0.05)
    adj = vertex_adjacency(mesh.num_vertices, mesh.f)
    small = make_grid_mesh(16, jitter=0.05)
    coarse = build_hierarchy(TriMesh(small.v, small.f), [2]).adjacency[0]
    j = lambda f, *a, dt=jnp.float32, **kw: f(*a, dtype=dt, **kw)
    return {
        "bsr": (graph.cheb_operator(adj, "cpu", bsr_min_n=1, dtype=BF),
                j(jax_graph.cheb_operator, adj, dt=jnp.bfloat16,
                  layouts=("bsr",)),
                j(jax_graph.cheb_operator, adj, layouts=("bsr",)), "pallas"),
        "dense": (graph.cheb_operator(adj, "cpu", bsr_min_n=None, dtype=BF),
                  j(jax_graph.cheb_operator, adj, dt=jnp.bfloat16,
                    layouts=("dense",)),
                  j(jax_graph.cheb_operator, adj, layouts=("dense",)),
                  "dense"),
        "corner": (graph.embed_operator(coarse, 512, "cpu", bsr_min_n=1,
                                        dtype=BF),
                   j(jax_graph.embed_operator, coarse, 512, dt=jnp.bfloat16,
                     layouts=("bsr",)),
                   j(jax_graph.embed_operator, coarse, 512,
                     layouts=("bsr",)), "pallas"),
    }


@pytest.mark.parametrize("layout", ["bsr", "dense", "corner"])
def test_cheb_conv_bf16_matches_jax(conv_ops, monkeypatch, layout):
    """cheb_conv forward and its gradients in x, W and the bias, bf16
    operators and state at precision "default", against cheb_conv_pallas
    (or the dense path) with bf16 operators; K = 6. The BSR backward runs
    the bf16 kernel mode for dx; the output and dx stay bf16."""
    port_op, j16_op, j32_op, method = conv_ops[layout]
    n, k, b, f_in, f_out = port_op.n, 6, 4, 8, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, n, f_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f_in, f_out))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f_out)).astype(np.float32)
    g = rng.standard_normal((b, n, f_out)).astype(np.float32)

    def jax_run(op, dt, precision):
        def loss(x_, w_, b_):
            out = jax_cheb_conv(x_.astype(dt), op, w_.astype(dt),
                                b_.astype(dt), method=method,
                                precision=precision)
            return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
        return out, grads

    out16, g16 = jax_run(j16_op, jnp.bfloat16, "default")
    out32, g32 = jax_run(j32_op, jnp.float32, "highest")
    calls = count_kernel_calls(monkeypatch, cheb=port_cheb)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, bias))
    out = cheb_conv(xt.to(BF), port_op, wt.to(BF), bt.to(BF),
                    precision="default")
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert out.dtype == BF and xt.grad.dtype == torch.float32
    n_kernel = 0 if layout == "dense" else k - 1
    assert calls == [("cheb", "bf16")] * (2 * n_kernel)
    closer(f"{layout} out", out, out16, out32, np.abs(_np(out32)).max())
    layer = max(np.abs(_np(a)).max() for a in g32[1:])
    for name, got, r16, r32, scale in (
            ("dx", xt.grad, g16[0], g32[0], np.abs(_np(g32[0])).max()),
            ("dW", wt.grad, g16[1], g32[1], layer),
            ("dbias", bt.grad, g16[2], g32[2], layer)):
        closer(f"{layout} {name}", got, r16, r32, scale)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_bf16_precision_clamps_to_default(conv_ops, precision):
    """On bf16 operators matmul_precision high and highest run exactly as
    default, forward and backward (the JAX package's
    _clamp_bf16_precision; tests/test_pallas.py:290-321), and a config
    with compute_dtype bfloat16 resolves to default. float32 keeps
    refusing default."""
    port_op = conv_ops["bsr"][0]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, port_op.n, 8)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 8, 16))).astype(np.float32)

    def run(prec):
        xt, wt = (torch.from_numpy(a).to(BF).requires_grad_(True)
                  for a in (x, w))
        out = cheb_conv(xt, port_op, wt, None, precision=prec)
        (out.float() ** 2).sum().backward()
        return out, xt.grad, wt.grad

    for got, want in zip(run(precision), run("default")):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert resolve_precision(precision, BF) == "default"
    cfg = {"num_conv_filters": [8, 8], "polygon_order": [3, 3, 3],
           "n_layers": 2, "num_hidden": 16, "num_style": 4,
           "num_classes": 2, "dropout": 0.2, "compute_dtype": "bfloat16",
           "matmul_precision": precision}
    vcfg = VAEConfig.from_config(cfg, coarse_verts=10)
    assert (vcfg.precision, vcfg.dtype) == ("default", BF)
    with pytest.raises(ValueError, match="not supported"):
        resolve_precision("default", torch.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """20 synthetic meshes on the grid template; the first batch of 16,
    the normalisation and the config (norm.npz in its checkpoint_dir)."""
    _, hier = grid_hierarchy()
    root = tmp_path_factory.mktemp("bf16")
    template = TriMesh(hier.vertices[0], hier.faces[0])
    cfg = {"root_dir": write_requests(template, str(root), n=20),
           "checkpoint_dir": str(root / "ckpt")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    return (hier, next(iter(BatchIterator(ds, BATCH))), (ds.mean, ds.std),
            cfg)


def _models(hier, dtype):
    return paired_models(hier, "default" if dtype == "bfloat16" else
                         "highest", tgrad_ell_max=TGRAD, compute_dtype=dtype)


def test_eval_forward_bf16_matches_jax(data):
    """MeshVAE eval forward in bf16 (weights through params_from_flax):
    recon, mu, logvar and y_hat, all float32, against the flax model in
    bf16, with the flax fp32 forward as the yardstick."""
    hier, batch = data[:2]
    x, y = batch["x"], np.eye(2, dtype=np.float32)[batch["label"]]
    outs = {}
    for dtype in ("bfloat16", "float32"):
        jmodel, jops, params, pmodel, pops = _models(hier, dtype)
        outs[dtype] = jax.jit(lambda p: jmodel.apply(
            p, jnp.asarray(x), jnp.asarray(y), jops, train=False))(params)
    pmodel, pops = _models(hier, "bfloat16")[3:]
    assert pops.lap[0].bsr.blocks.dtype == BF and pops.up[0].w.dtype == BF
    assert all(p.dtype == torch.float32 for p in pmodel.parameters())
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), torch.from_numpy(y), pops)
    for key in ("recon", "mu", "logvar", "y_hat"):
        assert got[key].dtype == torch.float32
        closer(f"eval {key}", got[key], outs["bfloat16"][key],
                outs["float32"][key], np.abs(_np(outs["float32"][key])).max())


def test_train_step_bf16_matches_jax(data, monkeypatch):
    """One Trainer.train_step in bf16 against _train_step_impl in bf16,
    the same dropout masks and eps fed to both, with JAX fp32 as the
    yardstick: the loss and every gradient (scale: the layer's max|g|).
    Master params and Adam stay fp32. Every kernel call runs mode bf16:
    2 per block-sparse conv forward (K = 3), 2 per backward but the first
    encoder conv's, and the three pool P^T."""
    hier, batch, (mean, std) = data[:3]
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("x", "label", "r", "s", "m", "mask")}
    losses, grads = {}, {}
    for dtype in ("bfloat16", "float32"):
        jmodel, jops, params, pmodel, pops = _models(hier, dtype)
        cfg = pmodel.cfg
        noise = FedNoise(BATCH, cfg.num_hidden,
                         cfg.coarse_verts * cfg.filters[-1], cfg.latent)
        feed_noise(monkeypatch, noise)
        jtrainer = jax_loop.Trainer(jmodel, jops, CONFIG)
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: jtrainer._forward_loss(p, jbatch, None, True, jops),
            has_aux=True))(params)
        losses[dtype] = float(loss)
        grads[dtype] = {k: v.numpy() for k, v in params_from_flax(
            jax.tree_util.tree_map(np.asarray, g)).items()}
    noise.i = 0
    ptrainer = Trainer(*_models(hier, "bfloat16")[3:], CONFIG, device="cpu")
    calls = count_kernel_calls(monkeypatch, cheb=port_cheb, pool=port_pool)
    packed = ptrainer.train_step(ptrainer.to_device(batch),
                                 torch.Generator(),
                                 *ptrainer.norm_to_device(mean, std))
    assert noise.i == 4
    assert [m for _, m in calls] == ["bf16"] * 17, calls
    got = unpack_metrics(packed)
    closer("loss", np.float32(got["loss"]), np.float32(losses["bfloat16"]),
            np.float32(losses["float32"]), abs(losses["float32"]))
    named = dict(ptrainer.model.named_parameters())
    assert set(named) == set(grads["float32"])
    for name, p in named.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        state = ptrainer.optimizer.state[p]
        assert state["exp_avg"].dtype == torch.float32
        layer = name.rsplit(".", 1)[0]
        scale = max(np.abs(v).max() for k, v in grads["float32"].items()
                    if k.rsplit(".", 1)[0] == layer)
        closer(f"grad {name}", p.grad, grads["bfloat16"][name],
                grads["float32"][name], scale)


def _jax_outputs(out: str, names: list) -> dict:
    """A run_inference directory as arrays in `names` order: pred,
    err_mean, err_max [S] and the recon / counterfactual .obj [S, N, 3]."""
    with open(os.path.join(out, "inference.json")) as fp:
        res = json.load(fp)
    mesh = lambda suffix: np.stack([load_obj(os.path.join(
        out, "sex_change", n.split(".")[0] + suffix)).v for n in names])
    return {"pred": np.array([res[n]["sex"] for n in names]),
            "err_mean": np.array([res[n]["reconstruction_error"]["mean"]
                                  for n in names]),
            "err_max": np.array([res[n]["reconstruction_error"]["max"]
                                 for n in names]),
            "recon_orig": mesh("_recon.obj"), "oppo_orig": mesh(".obj")}


def test_inference_bf16_matches_jax(data, tmp_path, monkeypatch):
    """Batch inference in bf16 (the model casts the fp32 upload, as the
    JAX engine's) against the JAX package's run_inference in bf16 on the
    same weights, its fp32 run (dense path) the yardstick: 20 meshes in
    batches of 8 (a padded tail). Held on the rows where JAX bf16's
    logits are settled (torch_port_utils.settled_rows; the excused rows
    are printed, at most a quarter): pred equal, and recon_orig,
    oppo_orig, err_mean and err_max by torch_port_utils.closer's rule (the
    fp32 yardstick over the rows whose pred JAX bf16 and fp32 share; the
    ulp is one bf16 ulp of the normalized recon's scale, the model's
    bf16 output, carried to the original pose). Three runs: InferenceEngine.step per
    batch (its outputs float32), run_inference's files, and one
    MeshServer request line (the data directory, fp32 wire)."""
    hier, _, (mean, std), cfg = data
    jmodel, jops, params, pmodel, pops = paired_models(
        hier, "default", compute_dtype="bfloat16", jit_init=True)
    jops32 = paired_operators(hier, "dense")[0]
    jmodel32 = JaxMeshVAE(dataclasses.replace(
        jmodel.cfg, cheb_method="dense", compute_dtype="float32",
        precision="highest"))
    batch_size = 8
    common = dict(mean=mean, std=std, config=dict(cfg),
                  template=hier.vertices[0], batch_size=batch_size,
                  faces=hier.faces[0])
    for name, jm, jo in (("j16", jmodel, jops), ("j32", jmodel32, jops32)):
        jax_run_inference(params, jm, jo, str(tmp_path / name), **common)
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, hier.vertices[0], dtype="test")
    names = [p.split("/").pop() for p in ds.filenames]
    j16 = _jax_outputs(str(tmp_path / "j16"), names)
    j32 = _jax_outputs(str(tmp_path / "j32"), names)
    logits = jax.jit(lambda p, x: jmodel.apply(
        p, jmodel.apply(p, x, jops, method=JaxMeshVAE.encode),
        method=lambda m, h: m.classifier_layer(h)))(params,
                                                      jnp.asarray(ds.x))
    keep = settled_rows(logits)
    print(f"excused rows (JAX bf16 logits within 2 ulps): "
          f"{int((~keep).sum())} of {len(keep)}")
    assert (~keep).sum() <= len(keep) // 4
    same = keep & (j16["pred"] == j32["pred"])
    # the model's bf16 output is the normalized recon: one bf16 ulp of its
    # scale, carried to the original pose (x std, then R s, which mixes
    # the three coordinates)
    aligned = np.einsum("snj,sij->sni", j32["recon_orig"] - ds.m,
                        ds.r) / ds.s[:, None, None]
    scale = float(np.abs((aligned - mean) / std).max())
    ulp = np.sqrt(3) * bf16_ulp(scale) * float(std.max() * ds.s.max())

    def hold(label, got):
        np.testing.assert_array_equal(got["pred"][keep], j16["pred"][keep],
                                      label)
        for k in ("recon_orig", "oppo_orig", "err_mean", "err_max"):
            d_port = np.abs(got[k][keep] - j16[k][keep]).max()
            d_bf16 = np.abs(j16[k][same] - j32[k][same]).max()
            print(f"{label} {k}: |port - jax_bf16| {d_port:.3e}, "
                  f"|jax_bf16 - jax_fp32| {d_bf16:.3e}, ulp {ulp:.3e}")
            assert d_port <= d_bf16 + ulp, (label, k)

    engine = InferenceEngine(pmodel, pops)
    mean_t, std_t = torch.from_numpy(mean), torch.from_numpy(std)
    steps = {k: [] for k in j16}
    for host in BatchIterator(ds, batch_size):
        batch = {k: torch.from_numpy(np.asarray(host[k], np.float32))
                 for k in ("x", "r", "s", "m")}
        batch["original"] = torch.from_numpy(
            ds.original[host["index"]].astype(np.float32))
        out = engine.step(batch, mean_t, std_t)
        rows = np.asarray(host["mask"]) > 0
        for k, v in out.items():
            assert k == "pred" or v.dtype == torch.float32, k
            steps[k].append(v.numpy()[rows])
    hold("step", {k: np.concatenate(v) for k, v in steps.items()})

    run_inference(pmodel, pops, str(tmp_path / "port"), device="cpu",
                  **common)
    hold("run_inference", _jax_outputs(str(tmp_path / "port"), names))

    server = MeshServer(pmodel, pops, mean, std, template=hier.vertices[0],
                        faces=hier.faces[0], batch_size=batch_size,
                        wire_dtype=np.float32, device="cpu")
    fout = io.StringIO()
    try:
        server.serve_forever(io.StringIO(cfg["root_dir"] + "\n"), fout)
    finally:
        server.close()
    lines = [json.loads(l) for l in fout.getvalue().splitlines()]
    assert lines[-1]["done"] == len(names)
    served = {l["file"]: l for l in lines[:-1]}
    got = {"pred": np.array([served[n]["sex"] for n in names])}
    for k in ("mean", "max"):
        got[f"err_{k}"] = np.array([served[n]["reconstruction_error"][k]
                                    for n in names])
    np.testing.assert_array_equal(got["pred"][keep], j16["pred"][keep])
    for k in ("err_mean", "err_max"):
        d_port = np.abs(got[k][keep] - j16[k][keep]).max()
        d_bf16 = np.abs(j16[k][same] - j32[k][same]).max()
        print(f"serve {k}: |port - jax_bf16| {d_port:.3e}, "
              f"|jax_bf16 - jax_fp32| {d_bf16:.3e}")
        assert d_port <= d_bf16 + ulp, k
