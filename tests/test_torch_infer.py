"""Batch inference and JAX checkpoints in meshvae_tpu_torch against the JAX
package: the port's flax-bytes reader (train/flax_msgpack.py) against
flax.serialization.msgpack_restore; a JAX checkpoint_{fold}.msgpack read
by train/checkpoint.py (params equal to params_from_flax of the same tree,
the optax Adam state as torch's, so one more port step from it equals one
more JAX step); list_meshes without labels; run_inference against the JAX
package's on the grid template (the JAX Pallas kernels in interpret mode):
the same pred.json, errors and every .obj triple within 1e-4 of the mesh
scale (the JAX pipeline recomputes the original pose on the device from
x, as the port does; the .4f strings are never compared); and
``python -m meshvae_tpu_torch.infer`` end to end on a JAX-written
checkpoint, with the selection flags and the export refusal.

Gradient-carrying bars as tests/test_torch_train.py: Adam moments within
1e-4 of their layer's max (nu: 2e-4), params within 1e-2 lr."""
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.data.dataset import list_meshes as jax_list_meshes
from meshvae_tpu.infer.driver import run_inference as jax_run_inference
from meshvae_tpu.models.joint import JointMeshVAE as JaxJointMeshVAE
from meshvae_tpu.models.operators import build_operators as jax_build_ops
from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
from meshvae_tpu.train import loop as jax_loop
from meshvae_tpu.train.checkpoint import save_checkpoint as jax_save

from meshvae_tpu_torch.config import default_config
from meshvae_tpu_torch.data import MeshDataset, list_meshes
from meshvae_tpu_torch.infer.__main__ import main as infer_main
from meshvae_tpu_torch.infer.driver import run_inference
from meshvae_tpu_torch.infer.export import load_serving_step
from meshvae_tpu_torch.mesh import (TriMesh, load_obj, load_or_build_hierarchy,
                                    save_obj)
from meshvae_tpu_torch.models import MeshVAE, params_from_flax
from meshvae_tpu_torch.models.vae import parameter_order
from meshvae_tpu_torch.train import Trainer, flax_msgpack
from meshvae_tpu_torch.train.checkpoint import (checkpoint_path,
                                                find_checkpoint,
                                                load_checkpoint,
                                                save_checkpoint)
from meshvae_tpu_torch.train.driver import _restart

from conftest import make_grid_mesh
from torch_port_utils import (FILTERS, JOINT_SPLIT, ORDERS, FedNoise,
                              _jit_init as jit_init, feed_noise, gcn_configs,
                              grid_hierarchy, jax_hierarchy, paired_models,
                              write_requests)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD = 1e-3, 5e-4
CONFIG = {"num_classes": 2, "learning_rate": LR, "weight_decay": WD}
N_MESHES, BATCH = 8, 3   # 3 + 3 + 2: the last batch has a padded row
TOL = 1e-4               # of the mesh scale


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The 256-vertex grid hierarchy, 8 synthetic meshes and a
    checkpoint_dir holding their norm.npz."""
    _, hier = grid_hierarchy()
    root = tmp_path_factory.mktemp("infer")
    template = TriMesh(hier.vertices[0], hier.faces[0])
    cfg = {"root_dir": write_requests(template, str(root), n=N_MESHES),
           "checkpoint_dir": str(root / "ckpt")}
    index, labels = list_meshes(cfg)
    MeshDataset(index, cfg, labels, template.v)  # writes norm.npz
    with np.load(os.path.join(cfg["checkpoint_dir"], "norm.npz")) as z:
        norm = (z["mean"].astype(np.float32), z["std"].astype(np.float32))
    return hier, root, cfg, norm


def _adam_state(params, steps=1, seed=0):
    """optax state of the JAX package's optimizer after `steps` updates
    with random gradients."""
    opt = jax_loop.make_optimizer(LR, WD)
    state = opt.init(params)
    update = jax.jit(opt.update)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            params)
        _, state = update(grads, state, params)
    return state


def _same_tree(got, want, path="") -> int:
    """got (the port's reader) equals want (msgpack_restore) leaf for leaf;
    returns the number of array leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        return sum(_same_tree(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        return sum(_same_tree(g, w, path) for g, w in zip(got, want))
    if isinstance(got, torch.Tensor):  # bfloat16: a torch tensor here
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32), path)
        return 1
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, path)
        return 1
    assert got == want or (got != got and want != want), path
    return 0


def test_list_meshes_without_labels_matches_jax(env):
    _, _, cfg, _ = env
    for by_name in (True, False):
        got = list_meshes(cfg, sex_from_filename=by_name)
        assert got == jax_list_meshes(cfg, sex_from_filename=by_name)
    index, labels = got
    assert len(index) == N_MESHES and set(labels.values()) == {-1}


def test_reader_matches_msgpack_restore_on_a_checkpoint(env, tmp_path):
    """The bytes of the JAX package's save_checkpoint (params, the optax
    chain's state after one update, epoch and losses)."""
    _, _, params, _, _ = paired_models(env[0], "highest")
    path = str(tmp_path / "checkpoint_1.msgpack")
    jax_save(path, params, _adam_state(params), 4, 1.5, 2.5)
    with open(path, "rb") as fp:
        data = fp.read()
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.restore(data)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert _same_tree(got, want) == 3 * n_leaves + 3  # + counts, lr
    assert got["epoch_num"] == 4 and got["val_loss"] == 2.5


def test_reader_matches_msgpack_restore_on_every_type():
    """fp32 / bf16 / int arrays (empty, 0-d, over 64 KiB), numpy scalars,
    Python ints of every width, floats, None, bools, long strings and maps
    and lists over 15 entries."""
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": jnp.asarray(rng.standard_normal((4, 2)), jnp.bfloat16),
        "bf16_scalar": np.asarray(1.25, jnp.bfloat16),
        "i32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
        "u8": np.arange(200, 210, dtype=np.uint8),
        "empty": np.zeros((0, 4), np.float32),
        "zero_d": jnp.asarray(3, jnp.int32),
        "big": rng.standard_normal((100, 100)),
        "scalars": {"i64": np.int64(-7), "f32": np.float32(2.5),
                    "bool": np.bool_(True)},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 63],
        "misc": [1.5, 1e300, None, True, False, "x" * 31, "y" * 200,
                 "z" * 70000, b"raw", b"r" * 300],
        "wide": {f"k{i}": i for i in range(20)},
    }
    data = serialization.to_bytes(tree)
    want = serialization.msgpack_restore(data)
    assert _same_tree(flax_msgpack.restore(data), want) == 8


def test_reader_rejects_what_flax_does_not_write():
    with pytest.raises(ValueError, match="ext type 2"):  # complex
        flax_msgpack.restore(serialization.to_bytes({"z": 1 + 2j}))
    with pytest.raises(ValueError, match="0xc1"):
        flax_msgpack.restore(b"\xc1")
    with pytest.raises(ValueError, match="after the msgpack value"):
        flax_msgpack.restore(b"\x01\x02")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(b"\xa5ab")


def test_jax_checkpoint_loads_into_the_port(env, tmp_path):
    """checkpoint_1.msgpack -> the port's dict: params equal
    params_from_flax of the same tree and load into MeshVAE; Adam's
    moments, step and lr as torch keeps them; find_checkpoint prefers the
    port's .pt and names both files when neither exists."""
    hier = env[0]
    _, _, params, pmodel, _ = paired_models(hier, "highest")
    opt_state = _adam_state(params, steps=2)
    ckpt = str(tmp_path)
    jax_save(os.path.join(ckpt, "checkpoint_1.msgpack"), params, opt_state,
             7, 1.5, 2.5)
    path = find_checkpoint(ckpt, 1)
    assert path.endswith("checkpoint_1.msgpack")
    state = load_checkpoint(path)
    assert (state["epoch_num"], state["train_loss"], state["val_loss"]) == (
        7, 1.5, 2.5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert state["model"].keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(state["model"][k], v, rtol=0, atol=0)
    pmodel.load_state_dict(state["model"])

    adam = opt_state.inner_state[1]
    mu = params_from_flax(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = params_from_flax(jax.tree_util.tree_map(np.asarray, adam.nu))
    order = [n for n, _ in pmodel.named_parameters()]
    opt = state["optimizer"]
    assert opt["param_groups"] == [{"lr": pytest.approx(LR),
                                    "params": list(range(len(order)))}]
    for i, name in enumerate(order):
        s = opt["state"][i]
        assert s["step"].item() == 2.0
        torch.testing.assert_close(s["exp_avg"], mu[name], rtol=0, atol=0)
        torch.testing.assert_close(s["exp_avg_sq"], nu[name], rtol=0, atol=0)

    save_checkpoint(checkpoint_path(ckpt, 1), pmodel.state_dict(),
                    {"state": {}, "param_groups": []}, 1, 0.0, 0.0)
    assert find_checkpoint(ckpt, 1) == checkpoint_path(ckpt, 1)
    with pytest.raises(FileNotFoundError,
                       match=r"checkpoint_2\.pt.*checkpoint_2\.msgpack"):
        find_checkpoint(ckpt, 2)


def test_parameter_order_is_the_module_order(env):
    _, _, params, pmodel, _ = paired_models(env[0], "highest")
    names = list(params_from_flax(params))
    assert sorted(names) != [n for n, _ in pmodel.named_parameters()]
    assert parameter_order(names) == [n for n, _ in
                                      pmodel.named_parameters()]


def test_adam_state_continues_a_jax_run(env, monkeypatch, tmp_path):
    """A JAX train step, its checkpoint, then one more step on each side
    from that checkpoint (same masks and eps): the port's Adam moments,
    step and params after its step agree with the JAX package's."""
    hier, _, cfg, (mean, std) = env
    jmodel, jops, params, pmodel, pops = paired_models(hier, "highest")
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, hier.vertices[0], dtype="test")
    batch = {k: getattr(ds, k if k != "label" else "labels")
             for k in ("x", "label", "r", "s", "m")}
    batch["mask"] = np.ones(N_MESHES, np.float32)
    c = pmodel.cfg
    noise = FedNoise(N_MESHES, c.num_hidden,
                     c.coarse_verts * c.filters[-1], c.latent)
    feed_noise(monkeypatch, noise)
    jtrainer = jax_loop.Trainer(jmodel, jops, CONFIG)
    step = jax.jit(jtrainer._train_step_impl)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jbatch, jax.random.key(0), jnp.asarray(mean), jnp.asarray(std),
            jops)
    p1, o1, _ = step(params, jtrainer.init_opt_state(params), *args)
    jax_save(str(tmp_path / "checkpoint_1.msgpack"), p1, o1, 1, 0.0, 0.0)
    p2, o2, _ = step(p1, o1, *args)  # the same masks and eps: one trace

    trainer = Trainer(pmodel, pops, CONFIG, device="cpu")
    state = load_checkpoint(find_checkpoint(str(tmp_path), 1))
    _restart(trainer, state["model"], state["optimizer"])
    group = trainer.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (pytest.approx(LR), WD)
    noise.i = 0
    trainer.train_step(trainer.to_device(batch), torch.Generator(),
                       *trainer.norm_to_device(mean, std))

    named = lambda tree: {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}
    adam = o2.inner_state[1]
    mu, nu, after = named(adam.mu), named(adam.nu), named(p2)
    for name, p in pmodel.named_parameters():
        st = trainer.optimizer.state[p]
        assert int(st["step"]) == 2
        for got, ref, bar in ((st["exp_avg"], mu, 1e-4),
                              (st["exp_avg_sq"], nu, 2e-4)):
            layer = name.rsplit(".", 1)[0]
            scale = max(np.abs(v).max() for k, v in ref.items()
                        if k.rsplit(".", 1)[0] == layer)
            delta = np.abs(got.numpy() - ref[name]).max()
            assert delta <= bar * scale, (name, delta, scale)
        delta = np.abs(p.detach().numpy() - after[name]).max()
        assert delta <= 1e-2 * LR, (name, delta)


def _objs(out: str) -> dict:
    d = os.path.join(out, "sex_change")
    return {f: load_obj(os.path.join(d, f)).v for f in sorted(os.listdir(d))}


def _held_outputs(port_out: str, jax_out: str, scale: float, meshes=True):
    """pred.json equal; inference.json's errors and every .obj within
    TOL of the mesh scale; error_list.json's paths equal."""
    load = lambda out, name: json.load(open(os.path.join(out, name)))
    assert load(port_out, "pred.json") == load(jax_out, "pred.json")
    got, want = (load(o, "inference.json") for o in (port_out, jax_out))
    assert list(got) == list(want) and len(got) == N_MESHES
    for name, w in want.items():
        assert got[name]["sex"] == w["sex"]
        for k in ("mean", "max"):
            assert abs(got[name]["reconstruction_error"][k]
                       - w["reconstruction_error"][k]) <= TOL * scale
    assert list(load(port_out, "error_list.json")) == list(
        load(jax_out, "error_list.json"))
    if meshes:
        got, want = _objs(port_out), _objs(jax_out)
        assert list(got) == list(want) and len(got) == 3 * N_MESHES
        for f in want:
            assert np.abs(got[f] - want[f]).max() <= TOL * scale, f


def test_run_inference_matches_jax(env, tmp_path):
    """run_inference against the JAX package's on the same weights: batch 3
    over 8 meshes (a padded tail row), levels 0-1 block-sparse."""
    hier, _, cfg, (mean, std) = env
    jmodel, jops, params, pmodel, pops = paired_models(hier, "highest")
    common = dict(mean=mean, std=std, config=dict(cfg),
                  template=hier.vertices[0], batch_size=BATCH,
                  faces=hier.faces[0])
    want = jax_run_inference(params, jmodel, jops, str(tmp_path / "jax"),
                             **common)
    got = run_inference(pmodel, pops, str(tmp_path / "port"), device="cpu",
                        **common)
    assert list(got) == list(want)
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, hier.vertices[0], dtype="test")
    _held_outputs(str(tmp_path / "port"), str(tmp_path / "jax"),
                  float(np.abs(ds.original).max()))


def _cli_env(env, root, joint=False):
    """A config file with a relative checkpoint_dir, the grid template as
    an .obj, a JAX-written checkpoint_1.msgpack and norm.npz there, and the
    JAX model and operators of that config; joint: type = joint_VAE (the
    joint VAE + GCN, latent split 2)."""
    _, _, cfg, _ = env
    os.makedirs(root / "ckpt")
    mesh = make_grid_mesh(16, jitter=0.05)
    save_obj(str(root / "template.obj"), mesh.v, mesh.f)
    config = default_config()
    config.update({
        "template": str(root / "template.obj"), "checkpoint_dir": "ckpt/",
        "hierarchy_cache_dir": str(root / "cache"),
        "downsampling_factors": [2, 2, 2, 2], "num_conv_filters": FILTERS,
        "polygon_order": ORDERS, "num_hidden": 32, "num_style": 6,
        "batch_size": BATCH, "cheb_method": "pallas",
        "matmul_precision": "highest",
        "type": "joint_VAE" if joint else config["type"],
        "latent_split": JOINT_SPLIT})
    with open(root / "infer.cfg", "w") as fp:
        fp.write("[All]\n")
        for k in ("template", "checkpoint_dir", "hierarchy_cache_dir",
                  "downsampling_factors", "num_conv_filters", "polygon_order",
                  "num_hidden", "num_style", "batch_size", "cheb_method",
                  "matmul_precision", "type", "latent_split"):
            v = config[k]
            v = ", ".join(map(str, v)) if isinstance(v, (list, tuple)) else v
            fp.write(f"{k} = {v}\n")
    hier = load_or_build_hierarchy(load_obj(config["template"]), [2] * 4,
                                   cache_dir=config["hierarchy_cache_dir"])
    jcfg = JaxVAEConfig(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                        n_layers=4, num_hidden=32, latent=6, num_classes=2,
                        dropout=0.2, coarse_verts=hier.levels[-1],
                        cheb_method="pallas", precision="highest")
    jops = jax_build_ops(jax_hierarchy(hier), cheb_method="pallas",
                         pool_method="gather")
    init_args = ({"params": jax.random.key(1)},
                 jnp.zeros((1, hier.levels[0], 3), jnp.float32),
                 jnp.zeros((1, 2), jnp.float32))
    if joint:
        jgcn = gcn_configs(hier, "highest")[0]
        jmodel = JaxJointMeshVAE(jcfg, jgcn, JOINT_SPLIT)
        params = jit_init(JaxJointMeshVAE(
            dataclasses.replace(jcfg, cheb_method="dense"),
            dataclasses.replace(jgcn, cheb_method="dense"), JOINT_SPLIT),
            hier, *init_args, train=False)
    else:
        jmodel = JaxMeshVAE(jcfg)
        params = jax.tree_util.tree_map(np.asarray, jmodel.init(
            *init_args, jops, train=False))
    jax_save(str(root / "ckpt" / "checkpoint_1.msgpack"), params,
             _adam_state(params), 3, 1.0, 2.0)
    ckpt_cfg = {"root_dir": cfg["root_dir"],
                "checkpoint_dir": str(root / "ckpt")}
    index, labels = list_meshes(ckpt_cfg)
    MeshDataset(index, ckpt_cfg, labels, hier.vertices[0])  # norm.npz
    with np.load(root / "ckpt" / "norm.npz") as z:
        norm = (z["mean"].astype(np.float32), z["std"].astype(np.float32))
    return hier, ckpt_cfg, norm, (jmodel, jops, params)


def test_cli_reads_a_jax_checkpoint(env, tmp_path, capsys):
    """python -m meshvae_tpu_torch.infer in a subprocess with --pred
    --error_list --no-meshes (only those two files), then in process with no
    selection flag (all three and the triples), each against the JAX
    package's run_inference on the same JAX checkpoint; --export writes an
    artifact that loads (tests/test_torch_export.py holds its outputs), and
    --artifact without --serve is refused."""
    hier, ckpt_cfg, (mean, std), (jmodel, jops, params) = _cli_env(
        env, tmp_path)
    data = ckpt_cfg["root_dir"]
    args = ["-c", str(tmp_path / "infer.cfg"), "-d", data, "-n", "1",
            "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "meshvae_tpu_torch.infer", *args, "-o",
         str(tmp_path / "selected"), "--pred", "--error_list", "--no-meshes"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "selected")) == [
        "error_list.json", "pred.json"]

    assert infer_main([*args, "-o", str(tmp_path / "all")]) == 0
    jax_out = str(tmp_path / "jax")
    jax_run_inference(params, jmodel, jops, jax_out, mean, std,
                      dict(ckpt_cfg), template=hier.vertices[0],
                      batch_size=BATCH, faces=hier.faces[0])
    index, labels = list_meshes(ckpt_cfg)
    ds = MeshDataset(index, ckpt_cfg, labels, hier.vertices[0], dtype="test")
    _held_outputs(str(tmp_path / "all"), jax_out,
                  float(np.abs(ds.original).max()))
    for name in ("pred.json", "error_list.json"):
        with open(tmp_path / "selected" / name) as a, \
                open(tmp_path / "all" / name) as b:
            assert json.load(a) == json.load(b)

    art = str(tmp_path / "x.pt2")
    capsys.readouterr()
    assert infer_main([*args, "-o", str(tmp_path / "x"), "--export", art]) == 0
    assert f"serving artifact written to {art}" in capsys.readouterr().out
    assert load_serving_step(art, "cpu").header["contract"] == "plain"
    assert infer_main([*args, "-o", str(tmp_path / "x"), "--artifact",
                       art]) == 2
    assert "--serve" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x")


def test_cli_takes_cpu_for_device_cpu(monkeypatch):
    """--cpu is --device cpu (inference.py's flag); the default stays
    cuda."""
    import meshvae_tpu_torch.infer.driver as infer_driver
    import meshvae_tpu_torch.validate as validate

    seen = []
    monkeypatch.setattr(infer_driver, "run_cli", lambda world, args,
                        config: seen.append(args.device) or 0)
    monkeypatch.setattr(validate, "validate_config", lambda config, device:
                        None)  # it counts the cards of a cuda run
    cfg = os.path.join(REPO, "files", "default.cfg")
    for flags in (["--cpu"], []):
        assert infer_main(["-c", cfg, "-d", "data", "-o", "out",
                           *flags]) == 0
    assert seen == ["cpu", "cuda"]


def test_cli_serve_answers_as_the_batch_run(env, tmp_path, capsys,
                                            monkeypatch):
    """--serve on the JAX-written checkpoint (fp32 wire): the data
    directory as one request on stdin answers every mesh with the batch
    run's sex and errors (within TOL of the mesh scale), then a done line."""
    hier, ckpt_cfg, _, _ = _cli_env(env, tmp_path)
    data = ckpt_cfg["root_dir"]
    args = ["-c", str(tmp_path / "infer.cfg"), "-d", data, "-n", "1",
            "--device", "cpu", "--no-meshes", "-p", "serve_wire_dtype",
            "float32"]
    assert infer_main([*args, "-o", str(tmp_path / "batch"),
                       "--inference"]) == 0
    with open(tmp_path / "batch" / "inference.json") as fp:
        want = json.load(fp)
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(data + "\n"))
    assert infer_main([*args, "-o", str(tmp_path / "served"), "--serve"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert lines[0]["ready"] is True and lines[0]["batch_size"] == BATCH
    assert lines[-1]["done"] == N_MESHES
    served = {l["file"]: l for l in lines[1:-1]}
    assert sorted(served) == sorted(want)
    index, labels = list_meshes(ckpt_cfg)
    ds = MeshDataset(index, ckpt_cfg, labels, hier.vertices[0], dtype="test")
    scale = float(np.abs(ds.original).max())
    for name, w in want.items():
        assert served[name]["sex"] == w["sex"]
        for k in ("mean", "max"):
            assert abs(served[name]["reconstruction_error"][k]
                       - w["reconstruction_error"][k]) <= TOL * scale


def test_joint_checkpoint_through_inference(env, tmp_path, capsys,
                                            monkeypatch):
    """A JAX-written joint checkpoint_1.msgpack (type = joint_VAE, the
    engine driving the joint model through its MeshVAE delegations, as
    the JAX engine through type(model).encode, classify, z_mean and
    sample): python -m meshvae_tpu_torch.infer --cpu against the JAX
    package's run_inference on the same weights (pred.json equal, errors
    and every .obj triple within 1e-4 of the mesh scale), then --serve on
    that checkpoint answers the data directory with the same sex and
    errors."""
    hier, ckpt_cfg, (mean, std), (jmodel, jops, params) = _cli_env(
        env, tmp_path, joint=True)
    assert isinstance(jmodel, JaxJointMeshVAE)
    data = ckpt_cfg["root_dir"]
    args = ["-c", str(tmp_path / "infer.cfg"), "-d", data, "-n", "1",
            "--cpu", "-p", "serve_wire_dtype", "float32"]
    assert infer_main([*args, "-o", str(tmp_path / "all")]) == 0
    jax_out = str(tmp_path / "jax")
    jax_run_inference(params, jmodel, jops, jax_out, mean, std,
                      dict(ckpt_cfg), template=hier.vertices[0],
                      batch_size=BATCH, faces=hier.faces[0])
    index, labels = list_meshes(ckpt_cfg)
    ds = MeshDataset(index, ckpt_cfg, labels, hier.vertices[0], dtype="test")
    scale = float(np.abs(ds.original).max())
    _held_outputs(str(tmp_path / "all"), jax_out, scale)

    with open(os.path.join(jax_out, "inference.json")) as fp:
        want = json.load(fp)
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(data + "\n"))
    assert infer_main([*args, "-o", str(tmp_path / "served"), "--serve",
                       "--no-meshes"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert lines[-1]["done"] == N_MESHES
    served = {l["file"]: l for l in lines[1:-1]}
    assert sorted(served) == sorted(want)
    for name, w in want.items():
        assert served[name]["sex"] == w["sex"]
        for k in ("mean", "max"):
            assert abs(served[name]["reconstruction_error"][k]
                       - w["reconstruction_error"][k]) <= TOL * scale
