"""crecon (train/crecon_driver.py), the joint VAE + GCN (models/joint.py,
train/joint.py) and the Trainer's scanned epoch in a ("dp", "sp") world,
on the CPU:

  * one spawned dp=2 x sp=2 gloo world of four CPU ranks
    (tests/torch_world_classifiers_worker.py, on
    tests/torch_parallel_worker.py's grid with every level block-sparse)
    against the port's single-process runs from the same weights: a
    crecon epoch of 3 steps (a full, a padded and a full batch) through
    the per-step loop and through the scanned epoch with the device
    reshuffle, and its eval epochs (as test_parallel.py's
    TestCreconParallel); a deterministic joint train step, one with
    dropout 0.2 and the noise from a seeded generator on the padded
    batch, and the scanned joint eval (TestJointParallel); the Trainer's
    train_epoch_scanned_async and evaluate_scanned_async over 3 staged
    batches with the reshuffle and dropout (TestScannedPathsUnderMesh);
    every rank's parameters bit-equal, the frozen VAE untouched, and the
    kernel calls per rank equal to one process's at the shard shapes;
  * the world's crecon per-step epoch and deterministic joint step
    against the JAX package's CreconTrainer and JointTrainer under
    make_device_mesh(dp=2, sp=2), cheb_method pallas with PALLAS_MIN_N = 0
    (the distributed kernel in interpret mode), z = mu and no dropout
    (the two packages' RNG streams differ);
  * ``python -m meshvae_tpu_torch.crecon`` with -p data_parallel 2 -p
    seq_parallel 2 --device cpu against the single-process CLI on a
    32x32 grid (level 0 at the block-sparse cutoff, so sp shards it), and
    ``python -m meshvae_tpu_torch.infer`` on a joint model there.

Bars against one process: metrics rtol 1e-5 / atol 1e-6, parameters
rtol 1e-4 / atol 1e-5 (tests/test_torch_parallel.py's); against the JAX
package test_parallel.py's rtol 1e-4 / atol 1e-5."""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.mesh.hierarchy import MeshHierarchy as JaxHierarchy
from meshvae_tpu.parallel.sharding import make_device_mesh

from meshvae_tpu_torch.crecon import main as crecon_main
from meshvae_tpu_torch.data import generate_synthetic_dataset
from meshvae_tpu_torch.mesh import load_or_build_hierarchy, save_obj
from meshvae_tpu_torch.models import MeshVAE, VAEConfig, params_from_flax
from meshvae_tpu_torch.parallel import sharding
from meshvae_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

import torch_parallel_worker as W
import torch_world_classifiers_worker as CW


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The seeded weights; the spawned 2 x 2 world's rank results; the
    port's single-process results."""
    root = str(tmp_path_factory.mktemp("torch_world_classifiers"))
    states = CW.initial_states(W.hierarchy())
    states_path = os.path.join(root, "states.pt")
    torch.save(states, states_path)
    sharding.spawn_local(CW.world_rank, 2, 2, "cpu",
                         args=(states_path, root), timeout=300)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    return dict(states=states, ranks=ranks,
                single=CW.run_scenarios(None, states_path))


def _close_metrics(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _close_params(got, want, rtol=1e-4, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("path", ["loop", "scan"])
def test_crecon_epoch_matches_single_process(world, path):
    """A crecon train epoch of 3 steps and an eval epoch, through the
    per-step loop or the scanned epoch (device reshuffle): every rank's
    (average loss, accuracy) and GCN parameters as one process's."""
    want = world["single"]["crecon"]
    for r in world["ranks"]:
        got = r["crecon"]
        for phase in ("train", "eval"):
            np.testing.assert_allclose(got[f"{path}_{phase}"],
                                       want[f"{path}_{phase}"], rtol=1e-5,
                                       atol=1e-6, err_msg=phase)
        _close_params(got[f"{path}_params"], want[f"{path}_params"])


@pytest.mark.parametrize("tag", ["full", "dropout"])
def test_joint_step_matches_single_process(world, tag):
    """A deterministic joint train step on a full batch, and a step with
    dropout 0.2 and the noise drawn from a seeded generator on the padded
    batch: the masks and noise of the 2B decode's two segments are the
    single-process ones row for row."""
    want = world["single"]["joint"]
    for r in world["ranks"]:
        _close_metrics(r["joint"][f"metrics_{tag}"], want[f"metrics_{tag}"])
        _close_params(r["joint"][f"params_{tag}"], want[f"params_{tag}"])


def test_joint_scanned_eval_matches_single_process(world):
    """evaluate_scanned of the joint model (its sup_accuracy and
    adv_accuracy summed over dp) and the per-vertex errors gathered over
    dp."""
    want = world["single"]["joint"]
    assert {"sup_accuracy", "adv_accuracy"} <= set(want["eval_avg"])
    for r in world["ranks"]:
        _close_metrics(r["joint"]["eval_avg"], want["eval_avg"])
        np.testing.assert_allclose(r["joint"]["eval_errors"],
                                   want["eval_errors"], rtol=1e-4, atol=1e-6)


def test_scanned_train_and_eval_match_single_process(world):
    """Trainer.train_epoch_scanned_async over 3 staged batches with the
    device reshuffle and dropout from a seeded generator, then
    evaluate_scanned_async: averages, parameters and errors."""
    want = world["single"]["scan"]
    for r in world["ranks"]:
        _close_metrics(r["scan"]["train_avg"], want["train_avg"])
        _close_params(r["scan"]["params"], want["params"])
        _close_metrics(r["scan"]["eval_avg"], want["eval_avg"])
        np.testing.assert_allclose(r["scan"]["eval_errors"],
                                   want["eval_errors"], rtol=1e-4, atol=1e-6)


def test_replicas_bit_equal(world):
    """Every rank's parameters after every scenario bit-equal to rank 0's;
    the frozen VAE replicated and untouched by crecon's epochs."""
    keys = [("crecon", "loop_params"), ("crecon", "scan_params"),
            ("joint", "params_full"), ("joint", "params_dropout"),
            ("scan", "params")]
    first = world["ranks"][0]
    for r in world["ranks"][1:]:
        for scenario, key in keys:
            for k, v in first[scenario][key].items():
                np.testing.assert_array_equal(r[scenario][key][k], v,
                                              err_msg=f"{scenario} {k}")
    for r in world["ranks"]:
        for k, v in world["states"]["vae"].items():
            np.testing.assert_array_equal(r["crecon"]["vae_params"][k],
                                          v.numpy(), err_msg=k)


@pytest.mark.parametrize("scenario", ["crecon", "joint"])
def test_kernel_calls_per_rank(world, scenario):
    """Per rank, one train step (crecon's frozen VAE and GCN; the joint
    model's forward and backward) makes as many Laplacian kernel calls as
    one process, in the same order, each at its operator's shard shape
    [rows_per * 128, n_pad_global]."""
    want = world["single"][scenario]["calls"]
    for r in world["ranks"]:
        got = r[scenario]["calls"]
        assert len(got) == len(want) > 0
        for (rows, cols), (n_pad, n_pad_cols) in zip(got, want):
            assert n_pad == n_pad_cols
            n_glob = -(-n_pad // 256) * 256
            assert (rows, cols) == (n_glob // 2, n_glob)


# --- against the JAX package under make_device_mesh(dp=2, sp=2) ---------

def _flax_tree(state: dict) -> dict:
    """The port's state_dict as the JAX package's param tree (the inverse
    of params_from_flax): dotted names nest, a Chebyshev weight and every
    bias stay as they are, a Linear weight [out, in] becomes a Dense
    kernel [in, out]."""
    tree = {}
    for name, v in state.items():
        *path, layer, leaf = name.split(".")
        a = v.numpy()
        if leaf == "weight" and not layer.startswith("cheb_"):
            leaf, a = "kernel", a.T
        node = tree
        for part in path + [layer]:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(a))
    return {"params": tree}


def _jax_ops(monkeypatch, hier):
    from meshvae_tpu.models.operators import build_operators as jax_build_ops

    monkeypatch.setattr(jax_graph, "PALLAS_MIN_N", 0)
    return jax_build_ops(JaxHierarchy(hier.vertices, hier.faces,
                                      hier.adjacency, hier.downsample,
                                      hier.upsample),
                         cheb_method="pallas", pool_method="gather")


def _numpy_params(params) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


def test_crecon_epoch_matches_jax_mesh(world, monkeypatch):
    """The world's per-step crecon epoch against the JAX CreconTrainer's
    epoch (its scanned epoch, in order) under make_device_mesh(dp=2,
    sp=2) from the same frozen VAE and GCN weights."""
    from meshvae_tpu.models.gcn import ChebGCN as JaxChebGCN
    from meshvae_tpu.models.gcn import GCNConfig as JaxGCNConfig
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
    from meshvae_tpu.train.crecon_driver import CreconTrainer

    hier = W.hierarchy()
    coarse = hier.levels[-1]
    cfg = dict(CW.CRECON_CONFIG, scan_epoch=True)
    trainer = CreconTrainer(
        JaxChebGCN(JaxGCNConfig.from_config(cfg, coarse_verts=coarse)),
        JaxMeshVAE(JaxVAEConfig.from_config(cfg, coarse_verts=coarse)),
        _jax_ops(monkeypatch, hier), cfg, mesh=make_device_mesh(dp=2, sp=2))
    params = _flax_tree(world["states"]["gcn"])
    loader = [{k: b[k] for k in ("x", "label", "mask")}
              for b in CW.epoch_batches(hier.levels[0])]
    params, _, loss, acc = trainer.run_epoch(
        params, trainer.optimizer.init(params),
        _flax_tree(world["states"]["vae"]), loader, train=True)
    want_params = _numpy_params(params)
    for r in world["ranks"]:
        np.testing.assert_allclose(r["crecon"]["loop_train"], (loss, acc),
                                   rtol=1e-4, atol=1e-5)
        _close_params(r["crecon"]["loop_params"], want_params)


def test_joint_step_matches_jax_mesh(world, monkeypatch):
    """The world's deterministic joint step against the JAX JointTrainer's
    step under make_device_mesh(dp=2, sp=2): dropout 0 and z = mu on the
    JAX side."""
    from meshvae_tpu.models.joint import build_joint_model as jax_joint
    from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
    from meshvae_tpu.train.joint import JointTrainer
    from meshvae_tpu.train.loop import unpack_metrics as jax_unpack

    hier = W.hierarchy()
    monkeypatch.setattr(JaxMeshVAE, "reparameterize",
                        lambda self, mu, logvar: mu)
    cfg = dict(CW.JOINT_CONFIG, dropout=0.0)
    trainer = JointTrainer(jax_joint(cfg, coarse_verts=hier.levels[-1]),
                           _jax_ops(monkeypatch, hier), cfg,
                           mesh=make_device_mesh(dp=2, sp=2))
    params = trainer.maybe_replicate(_flax_tree(world["states"]["joint"]))
    opt_state = trainer.maybe_replicate(trainer.init_opt_state(params))
    n0 = hier.levels[0]
    m = trainer.maybe_replicate(jnp.zeros((n0, 3), jnp.float32))
    s = trainer.maybe_replicate(jnp.ones((n0, 3), jnp.float32))
    params, _, metrics = trainer._train_step(
        params, opt_state, trainer._put(CW.epoch_batches(n0)[0]),
        jax.random.key(1), m, s)
    want = jax_unpack(metrics)
    want_params = _numpy_params(params)
    for r in world["ranks"]:
        for k in want:
            np.testing.assert_allclose(r["joint"]["metrics_full"][k],
                                       want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        _close_params(r["joint"]["params_full"], want_params)


# --- the crecon CLI in a world --------------------------------------------

CLI_MESHES = 20   # per fold: 12 train (3 steps of 4), 4 valid, 4 test
WORLD_FLAGS = ("-p", "data_parallel", "2", "-p", "seq_parallel", "2")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """python -m meshvae_tpu_torch.crecon -t -s --device cpu on a 32x32
    grid, 5 folds x 1 epoch, from one seeded VAE checkpoint: in one
    process and with -p data_parallel 2 -p seq_parallel 2 (four local gloo
    ranks started by the CLI)."""
    root = str(tmp_path_factory.mktemp("torch_world_crecon_cli"))
    template = W.grid_mesh(32)
    tpath = os.path.join(root, "template.obj")
    save_obj(tpath, template.v, template.f)
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(template, data_dir, n_samples=CLI_MESHES,
                               seed=1)
    cache = os.path.join(root, "cache")
    cfg_path = os.path.join(root, "crecon.cfg")
    with open(cfg_path, "w") as fp:
        fp.write(f"[I/O]\nroot_dir = {data_dir}\ntemplate = {tpath}\n"
                 f"hierarchy_cache_dir = {cache}\ntype = cheb_GCN\n"
                 "[Model]\nn_layers = 2\ndownsampling_factors = 2, 2\n"
                 "num_conv_filters = 8, 16, 16\npolygon_order = 3, 3, 3\n"
                 "num_hidden = 16\nnum_style = 4\nbatch_size = 4\n"
                 "epoch = 1\ntest_size = 0.25\ncheb_method = pallas\n"
                 "matmul_precision = highest\n")
    hier = load_or_build_hierarchy(template, [2, 2], cache_dir=cache)
    from meshvae_tpu_torch.config import read_config

    vae = MeshVAE(VAEConfig.from_config(read_config(cfg_path),
                                        coarse_verts=hier.levels[-1]),
                  generator=torch.Generator().manual_seed(3))
    vae_ckpt = os.path.join(root, "vae", "checkpoint_1.pt")
    save_checkpoint(vae_ckpt, vae.state_dict(),
                    {"state": {}, "param_groups": []}, 1, 0.0, 0.0)
    out = {"root": root, "cfg": cfg_path, "data": data_dir, "hier": hier}
    for tag, extra in (("single", ()), ("world", WORLD_FLAGS)):
        ckpt = os.path.join(root, tag)
        assert crecon_main(["-c", cfg_path, "-t", "-s", "--device", "cpu",
                            "-p", "checkpoint_file", vae_ckpt,
                            "-p", "checkpoint_dir", ckpt + "/",
                            "-p", "log_file", os.path.join(ckpt, "log.txt"),
                            *extra]) == 0
        with open(os.path.join(ckpt, "log.txt")) as fp:
            out[tag] = (ckpt, fp.read())
    return out


def test_crecon_cli_world_matches_single_process(cli_runs):
    """The 2 x 2 world's five test results and epoch lines as one
    process's, each fold's checkpoint within the parameter bars, and every
    file written once by the primary: the same files, one log whose
    first line is written once and which names the world's eager
    steps."""
    (one, log1), (many, log4) = cli_runs["single"], cli_runs["world"]
    assert sorted(os.listdir(one)) == sorted(os.listdir(many))
    assert log4.count("model type:") == 1
    assert "eager steps: a world's collectives" in log4
    number = r"([-+0-9.eE]+)"
    for pattern in (rf"test loss\s+{number} test acc {number}",
                    rf"Train loss\s+{number} train acc {number}\s+Val loss"
                    rf"\s+{number} acc\s+{number}"):
        want = np.array(re.findall(pattern, log1), dtype=np.float64)
        got = np.array(re.findall(pattern, log4), dtype=np.float64)
        assert want.shape[0] == 5 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    for fold in range(1, 6):
        p1, p4 = (load_checkpoint(os.path.join(d, f"checkpoint_{fold}.pt"))
                  for d in (one, many))
        _close_params({k: v.numpy() for k, v in p4["model"].items()},
                      {k: v.numpy() for k, v in p1["model"].items()})


def test_joint_infer_cli_world_matches_single_process(cli_runs):
    """python -m meshvae_tpu_torch.infer on a seeded joint model (type =
    joint_VAE, which the CLI no longer refuses in a world) in one process
    and in the 2 x 2 world: the same pred.json, errors within 1e-5
    relative, the same .obj triples."""
    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.data import MeshDataset, list_meshes
    from meshvae_tpu_torch.infer.__main__ import main as infer_main
    from meshvae_tpu_torch.models.joint import build_joint_model

    root, data, hier = cli_runs["root"], cli_runs["data"], cli_runs["hier"]
    ckpt = os.path.join(root, "joint_ckpt")
    cfg_path = os.path.join(root, "joint.cfg")
    with open(cli_runs["cfg"]) as fp:
        text = fp.read().replace("type = cheb_GCN", "type = joint_VAE")
    with open(cfg_path, "w") as fp:
        fp.write(text + f"latent_split = 2\ncheckpoint_dir = {ckpt}\n")
    model = build_joint_model(read_config(cfg_path), hier.levels[-1],
                              generator=torch.Generator().manual_seed(4))
    save_checkpoint(os.path.join(ckpt, "checkpoint_1.pt"), model.state_dict(),
                    {"state": {}, "param_groups": []}, 1, 0.0, 0.0)
    index, labels = list_meshes({"root_dir": data})
    MeshDataset(index, {"root_dir": data, "checkpoint_dir": ckpt}, labels,
                hier.vertices[0])   # writes the norm.npz inference reads
    outs = {}
    for tag, extra in (("one", ()), ("world", WORLD_FLAGS)):
        outs[tag] = os.path.join(root, f"joint_infer_{tag}")
        assert infer_main(["-c", cfg_path, "-d", data, "-o", outs[tag], "-n",
                           "1", "--device", "cpu", *extra]) == 0

    def read(tag, name):
        with open(os.path.join(outs[tag], name)) as fp:
            return json.load(fp)

    assert read("one", "pred.json") == read("world", "pred.json")
    one, world = read("one", "inference.json"), read("world",
                                                     "inference.json")
    assert list(one) == list(world) and len(one) == CLI_MESHES
    for name, r in one.items():
        for key in ("mean", "max"):
            np.testing.assert_allclose(
                world[name]["reconstruction_error"][key],
                r["reconstruction_error"][key], rtol=1e-5)
    assert (sorted(os.listdir(os.path.join(outs["one"], "sex_change")))
            == sorted(os.listdir(os.path.join(outs["world"], "sex_change"))))
