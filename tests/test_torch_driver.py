"""The port's k-fold train driver (meshvae_tpu_torch/train/driver.py and
``python -m meshvae_tpu_torch.train``) on the CPU: its numpy splits
against scikit-learn's, its fold lists against the JAX driver's, and whole
runs on a tiny grid template in bf16 (2 folds x 2 epochs, train and test):
the history schema, checkpoints, resume, the non-finite halt, the test
line, the sex-change mesh dumps, and evaluate(collect_meshes=True) against
the JAX package's."""
import contextlib
import io
import json
import os

import numpy as np
import pytest
from sklearn.model_selection import RepeatedStratifiedKFold
from sklearn.model_selection import train_test_split as sk_train_test_split

import meshvae_tpu.ops.pallas_cheb as pc
import meshvae_tpu.train.driver as jax_driver
from meshvae_tpu.config import default_config as jax_default_config
from meshvae_tpu.train import loop as jax_loop
from meshvae_tpu.train.metrics import history_record as jax_history_record

from meshvae_tpu_torch.config import default_config
from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                    generate_synthetic_dataset, list_meshes)
from meshvae_tpu_torch.mesh import TriMesh, load_obj, save_obj
from meshvae_tpu_torch.train import Trainer
from meshvae_tpu_torch.train import driver
from meshvae_tpu_torch.train.__main__ import main as train_main
from meshvae_tpu_torch.train.checkpoint import (checkpoint_path,
                                                load_checkpoint)
from meshvae_tpu_torch.train.metrics import maybe_profile, trace_path
from meshvae_tpu_torch.train.splits import stratified_kfold, train_test_split

from conftest import make_grid_mesh
from torch_port_utils import grid_hierarchy, paired_models, write_requests


@pytest.mark.parametrize("n,folds,seed", [(16, 2, 666), (40, 5, 666),
                                          (23, 3, 1), (61, 4, 12345)])
def test_splits_match_sklearn(n, folds, seed):
    """stratified_kfold (one class, as the driver's dummy labels, and two
    classes) and train_test_split give scikit-learn's index lists."""
    for y in (np.ones(n), np.arange(n) % 2):
        want = list(RepeatedStratifiedKFold(
            n_splits=folds, n_repeats=1, random_state=seed).split(
                np.zeros(n), y))
        got = list(stratified_kfold(folds, y, seed))
        assert len(got) == len(want) == folds
        for (gt, ge), (wt, we) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(ge, we)
    names = np.array([f"m{i}" for i in range(n)])
    for test_size in (0.3, 0.25):
        got = train_test_split(names, test_size=test_size, seed=seed)
        want = sk_train_test_split(names, test_size=test_size,
                                   random_state=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """An 8x8 grid template, 16 synthetic meshes, a tiny bf16 config."""
    root = str(tmp_path_factory.mktemp("driver"))
    template = make_grid_mesh(8, jitter=0.05)
    template_path = os.path.join(root, "template.obj")
    save_obj(template_path, template.v, template.f)
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(TriMesh(template.v, template.f), data_dir,
                               n_samples=16, seed=1)
    config = default_config()
    config.update({
        "template": template_path, "root_dir": data_dir, "folds": 2,
        "test_size": 0.25, "n_layers": 2, "num_hidden": 16, "num_style": 4,
        "downsampling_factors": [2, 2], "polygon_order": [3, 3, 3],
        "num_conv_filters": [8, 16, 16], "batch_size": 4, "epoch": 2,
        "hierarchy_cache_dir": os.path.join(root, "cache"),
        "cheb_method": "pallas", "compute_dtype": "bfloat16",
        "matmul_precision": "highest",
    })
    return root, config


def _ckpt_config(env, name):
    root, config = env
    ckpt = os.path.join(root, name)
    return dict(config, checkpoint_dir=ckpt,
                log_file=os.path.join(ckpt, "log.txt"))


@pytest.fixture(scope="module")
def trained(env, tmp_path_factory):
    """One run of the CLI: -t -s -v --device cpu, 2 folds x 2 epochs, bf16
    (the driver's own config file is written and read back)."""
    root, _ = env
    config = _ckpt_config(env, "ckpt")
    cfg_path = os.path.join(root, "tiny.cfg")
    with open(cfg_path, "w") as fp:
        fp.write("[All]\n")
        for k in ("template", "root_dir", "checkpoint_dir", "folds",
                  "test_size", "n_layers", "num_hidden", "num_style",
                  "downsampling_factors", "polygon_order",
                  "num_conv_filters", "batch_size", "hierarchy_cache_dir",
                  "cheb_method", "compute_dtype", "matmul_precision"):
            v = config[k]
            v = ", ".join(map(str, v)) if isinstance(v, list) else v
            fp.write(f"{k} = {v}\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_main(["-c", cfg_path, "-t", "-s", "-v", "-p", "epoch",
                           "2", "--device", "cpu"]) == 0
    return config, out.getvalue()


def test_cli_takes_cpu_for_device_cpu(monkeypatch):
    """--cpu is --device cpu (main.py's flag); the default stays cuda."""
    seen = []
    monkeypatch.setattr(driver, "run", lambda config, do_train, do_test,
                        vis, device: seen.append(device))
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "files", "default.cfg")
    assert train_main(["-c", cfg, "-t", "--cpu"]) == 0
    assert train_main(["-c", cfg, "-t"]) == 0
    assert seen == ["cpu", "cuda"]


def test_run_writes_history_and_checkpoints(trained):
    """history{1,2}.json carry the JAX package's keys per epoch; the log
    and stdout carry the test line of both folds; each checkpoint reloads
    into a bf16 MeshVAE and records its epoch; the model ran in bf16."""
    config, stdout = trained
    ckpt = config["checkpoint_dir"]
    ref = jax_history_record(
        1, 0.0, 1.0, dict(loss=0, kld=0, rec_loss=0, accuracy=0, error=0),
        dict(loss=0, kld=0, rec_loss=0, accuracy=0,
             sex_change_success_rate=0), 0.0)
    for fold in (1, 2):
        with open(os.path.join(ckpt, f"history{fold}.json")) as fp:
            hist = json.load(fp)
        assert [h["epoch"] for h in hist] == [1, 2]
        for h in hist:
            assert h.keys() == ref.keys()
            assert h["training"].keys() == ref["training"].keys()
            assert h["validation"].keys() == ref["validation"].keys()
            assert all(np.isfinite(v) for v in h["training"].values())
        state = load_checkpoint(checkpoint_path(ckpt, fold))
        assert state["epoch_num"] in (1, 2)
        with open(checkpoint_path(ckpt, fold) + ".meta.json") as fp:
            assert json.load(fp)["epoch_num"] == state["epoch_num"]
        model, _, _, _ = driver.build_model_and_ops(config, "cpu")
        model.load_state_dict(state["model"])
        assert model.cfg.compute_dtype == "bfloat16"
        assert {"state", "param_groups"} <= set(state["optimizer"])
    for name in ("initial_weight.pt", "norm.npz", "log.txt"):
        assert os.path.exists(os.path.join(ckpt, name))
    tests = [l for l in stdout.splitlines() if "test loss" in l]
    assert [l.split()[1] for l in tests] == ["1", "2"]
    assert "compute dtype: bfloat16 matmul precision: default" in stdout
    with open(os.path.join(ckpt, "log.txt")) as fp:
        assert fp.read().count("test loss") == 2


def test_run_writes_sex_change_triples(trained):
    """-v: each tested mesh gets recon / gt / oppo .obj files under
    mesh{fold}/sex_change_{S,F}, with the template's vertex count."""
    config, _ = trained
    for fold in (1, 2):
        base = os.path.join(config["checkpoint_dir"], f"mesh{fold}")
        files = [os.path.join(base, d, f)
                 for d in ("sex_change_S", "sex_change_F")
                 for f in os.listdir(os.path.join(base, d))]
        stems = {os.path.basename(f).replace("_recon", "").replace("_gt", "")
                 for f in files}
        assert len(files) == 3 * len(stems) == 3 * 8
        assert load_obj(files[0]).v.shape == (64, 3)


def test_resume_restarts_after_the_checkpoint_epoch(env, trained):
    """checkpoint_file resumes the first fold at epoch_num + 1 with the
    saved params and Adam state; the second fold starts at epoch 1."""
    config, _ = trained
    saved = load_checkpoint(checkpoint_path(config["checkpoint_dir"], 1))
    resumed = dict(_ckpt_config(env, "resume"), epoch=saved["epoch_num"] + 1,
                   checkpoint_file=checkpoint_path(
                       config["checkpoint_dir"], 1))
    driver.run(resumed, do_train=True, do_test=False, device="cpu")
    hist = {}
    for fold in (1, 2):
        with open(os.path.join(resumed["checkpoint_dir"],
                               f"history{fold}.json")) as fp:
            hist[fold] = [h["epoch"] for h in json.load(fp)]
    assert hist[1] == [saved["epoch_num"] + 1]
    assert hist[2] == list(range(1, saved["epoch_num"] + 2))


def test_nonfinite_loss_halts_with_checkpoint_hint(env, monkeypatch):
    """A non-finite train loss at epoch 2 stops the run, names the best
    checkpoint so far (epoch 1's), and keeps the failing epoch in the
    history. This is the per-step loop's halt (scan_epoch = False, whose
    train_epoch is poisoned); tests/test_torch_scan.py holds the scanned,
    pipelined one."""
    config = dict(_ckpt_config(env, "nan"), scan_epoch=False)
    real = Trainer.train_epoch
    epochs = []

    def poisoned(self, *args, **kwargs):
        avg = real(self, *args, **kwargs)
        epochs.append(1)
        if len(epochs) == 2:
            avg["loss"] = float("nan")
        return avg

    monkeypatch.setattr(Trainer, "train_epoch", poisoned)
    with pytest.raises(RuntimeError, match="best checkpoint so far: .*"
                       "checkpoint_1.pt"):
        driver.run(config, do_train=True, do_test=False, device="cpu")
    with open(os.path.join(config["checkpoint_dir"], "history1.json")) as fp:
        assert [h["epoch"] for h in json.load(fp)] == [1, 2]


def test_profile_dir_traces_epoch_2_of_each_fold(env, tmp_path):
    """profile_dir: run() writes a torch.profiler Chrome trace of epoch 2
    (metrics.PROFILE_EPOCHS, as the JAX driver) of each fold, holding the
    epoch's train steps, and none of epochs 1 and 3."""
    prof = str(tmp_path / "prof")
    config = dict(_ckpt_config(env, "profiled"), epoch=3, profile_dir=prof)
    driver.run(config, do_train=True, do_test=False, device="cpu")
    assert sorted(os.listdir(prof)) == sorted(
        os.path.basename(trace_path(prof, n, 2)) for n in (1, 2))
    with open(trace_path(prof, 1, 2)) as fp:
        names = {e.get("name", "") for e in json.load(fp)["traceEvents"]}
    assert {"aten::mm", "aten::addmm"} & names  # the epoch's products


def test_no_profile_dir_writes_no_trace(trained, tmp_path, monkeypatch):
    """Without profile_dir the run writes no trace, and maybe_profile
    yields no profiler and creates nothing."""
    config, _ = trained
    for _, _, files in os.walk(config["checkpoint_dir"]):
        assert not [f for f in files if f.endswith(".trace.json")]
    monkeypatch.chdir(tmp_path)
    for profile_dir in ("", None):
        with maybe_profile(profile_dir, 2) as prof:
            assert prof is None
    assert os.listdir(tmp_path) == []


def test_fold_splits_match_the_jax_driver(env, monkeypatch):
    """The mesh names each fold trains and validates on, as the port's
    run() passes them to MeshDataset and as the JAX driver's run() does
    (epoch 0: datasets are built, no step runs)."""
    root, config = env
    seen = {"port": [], "jax": []}

    class Recorder:
        def __init__(self, side, names, cfg, labels, template, dtype,
                     write_norm=True):
            seen[side].append((dtype, list(names)))
            self.mean = self.std = np.zeros((1, 3), np.float32)

    monkeypatch.setattr(driver, "MeshDataset",
                        lambda *a, **kw: Recorder("port", *a, **kw))
    monkeypatch.setattr(jax_driver, "MeshDataset",
                        lambda *a, **kw: Recorder("jax", *a, **kw))
    monkeypatch.setattr(driver, "BatchIterator", lambda *a, **kw: [])
    monkeypatch.setattr(jax_driver, "BatchIterator", lambda *a, **kw: [])
    port_cfg = dict(_ckpt_config(env, "split_port"), epoch=0, folds=3)
    driver.run(port_cfg, do_train=True, do_test=False, device="cpu")
    jax_cfg = jax_default_config()
    jax_cfg.update({k: port_cfg[k] for k in (
        "template", "root_dir", "folds", "test_size", "n_layers",
        "num_hidden", "num_style", "downsampling_factors", "polygon_order",
        "num_conv_filters", "batch_size", "hierarchy_cache_dir")})
    ckpt = os.path.join(root, "split_jax")
    jax_cfg.update(checkpoint_dir=ckpt, log_file=os.path.join(ckpt, "l.txt"),
                   epoch=0, scan_epoch=False,
                   hierarchy_cache_dir=os.path.join(root, "cache_jax"))
    jax_driver.run(jax_cfg, do_train=True, do_test=False)
    assert len(seen["port"]) == 6 and seen["port"] == seen["jax"]


def test_evaluate_collect_meshes_matches_jax(tmp_path, monkeypatch):
    """Trainer.evaluate(collect_meshes=True), as the test path calls it,
    against the JAX Trainer's on a padded batch (20 meshes, batches of
    16): the same keys, the dataset indices of the valid rows, the
    counterfactual labels, and the original-pose meshes within 1e-4 of the
    mesh scale."""
    monkeypatch.setattr(pc, "INTERPRET", True)
    _, hier = grid_hierarchy()
    template = TriMesh(hier.vertices[0], hier.faces[0])
    cfg = {"root_dir": write_requests(template, str(tmp_path), n=20),
           "checkpoint_dir": str(tmp_path / "ckpt")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    loader = BatchIterator(ds, 16)
    jmodel, jops, params, pmodel, pops = paired_models(hier, "highest")
    config = {"num_classes": 2, "learning_rate": 1e-3, "weight_decay": 5e-4}
    jtrainer = jax_loop.Trainer(jmodel, jops, config)
    want = jtrainer.evaluate(params, loader, ds.mean, ds.std,
                             collect_meshes=True)
    got = Trainer(pmodel, pops, config, device="cpu").evaluate(
        loader, ds.mean, ds.std, collect_meshes=True)
    assert got[2].keys() == want[2].keys()
    for k in ("index", "oppo_pred", "oppo_label"):
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)
    assert got[2]["index"].tolist() == list(range(20))
    scale = np.abs(ds.original).max()
    for k in ("recon", "oppo"):
        assert got[2][k].shape == (20, hier.levels[0], 3)
        assert np.abs(got[2][k] - want[2][k]).max() <= 1e-4 * scale, k
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
