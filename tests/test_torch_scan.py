"""The scanned epoch of meshvae_tpu_torch (train/loop.py stage_batches,
reshuffle_batches, train_epoch_scanned_async, evaluate_scanned_async and
their finalizers; train/driver.py's scanned, pipelined branch) against
the JAX package's (meshvae_tpu/train/loop.py, driver.py) on the CPU, where
the port's steps run eagerly; and, on a card, the CUDA graphs of the steps
(train/graphs.py) against the same steps run eagerly.

Both packages get the same batches, the same permutation of the epoch's
samples (the port's ``perm=``; the JAX package's ``jax.random.permutation``
patched to return it) and the same dropout masks and noise (FedNoise: a
``lax.scan`` body is traced once, so the JAX side applies one set of
masks at every step, and the port is fed that set at every step). The
JAX Pallas kernels run in interpret mode.

Bars (tests/test_torch_train.py's): the per-step loss and metrics rtol
1e-5 (pose error 1e-4), each parameter after the epoch within 1e-4 of its
layer's max |p|; eval (tests/test_parity.py's): loss rtol 1e-5, errors and
meshes within 1e-4 of the mesh scale, labels equal. The finalizers, the
staging and the reshuffle are exact. On the card the graphed steps are
held to the eager ones bit for bit.

The JAX side and the shared set-up (tests/torch_port_utils.py, which
imports flax) are imported inside the fixtures, so the card's test
collects on a machine without flax.
"""
import copy
import json
import os
import types

import numpy as np
import pytest
import torch

from meshvae_tpu_torch.config import apply_overrides, default_config
from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                    generate_synthetic_dataset, list_meshes)
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, save_obj
from meshvae_tpu_torch.models import MeshVAE, VAEConfig, build_operators
from meshvae_tpu_torch.ops import bsr_spmm
from meshvae_tpu_torch.train import Trainer, driver, set_learning_rate
from meshvae_tpu_torch.train import loop as port_loop
from meshvae_tpu_torch.train.checkpoint import (checkpoint_path,
                                                load_checkpoint)
from meshvae_tpu_torch.train.graphs import HostCopy

from conftest import make_grid_mesh

BATCH = 16      # B * F = 128 at F = 8: the pool backward takes P^T's kernel
N_MESHES = 40   # three steps of 16, the last one padded
TGRAD = 6       # three block-sparse P^T on the grid (test_torch_train.py)
DROPOUT = 0.2
LR, WD = 1e-3, 5e-4
CONFIG = {"num_classes": 2, "learning_rate": LR, "weight_decay": WD}
KEYS = Trainer.BATCH_KEYS


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules and the shared set-up."""
    import jax
    import jax.numpy as jnp

    import meshvae_tpu.ops.pallas_cheb as pc
    from meshvae_tpu.train import loop as jax_loop
    import torch_port_utils as utils

    return types.SimpleNamespace(jax=jax, jnp=jnp, pc=pc, loop=jax_loop,
                                 utils=utils)


@pytest.fixture
def interpret(ref, monkeypatch):
    monkeypatch.setattr(ref.pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def data(ref, tmp_path_factory):
    """40 synthetic meshes on the 16x16 grid template: the port's dataset,
    its shuffled batches (three of 16, the last padded) and norm stats."""
    _, hier = ref.utils.grid_hierarchy()
    root = tmp_path_factory.mktemp("scan")
    template = TriMesh(hier.vertices[0], hier.faces[0])
    data_dir = str(root / "data")
    generate_synthetic_dataset(template, data_dir, n_samples=N_MESHES,
                               seed=1)
    cfg = {"root_dir": data_dir, "checkpoint_dir": str(root / "ckpt")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    batches = list(BatchIterator(ds, BATCH, shuffle=True, seed=3))
    assert len(batches) == 3 and batches[2]["mask"].sum() == 8
    return types.SimpleNamespace(hier=hier, ds=ds, batches=batches,
                                 norm=(ds.mean, ds.std))


def _paired(ref, data, precision, dropout=DROPOUT):
    jmodel, jops, params, pmodel, pops = ref.utils.paired_models(
        data.hier, precision, dropout=dropout, tgrad_ell_max=TGRAD)
    return (ref.loop.Trainer(jmodel, jops, CONFIG), params,
            Trainer(pmodel, pops, CONFIG, device="cpu"))


def _port_trainer(hier, device, dist=None):
    """A port Trainer alone (seeded weights), as torch_port_utils' models."""
    cfg = VAEConfig(num_features=3, filters=(8, 8, 8, 16, 16),
                    polygon_order=(3, 3, 3, 3, 3), n_layers=4, num_hidden=32,
                    latent=6, num_classes=2, dropout=DROPOUT,
                    coarse_verts=hier.levels[-1], precision="highest")
    ops = build_operators(hier, device, cheb_method="pallas", bsr_min_n=128)
    model = MeshVAE(cfg, generator=torch.Generator().manual_seed(0))
    return Trainer(model, ops, CONFIG, device=device, dist=dist)


def _numpy(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_stage_and_reshuffle_match_jax(ref, data):
    """stage_batches with and without with_index: the same [S, B, ...]
    arrays, host mask and indices as the JAX package's; reshuffle_batches
    by one numpy permutation: the same batches."""
    ptrainer = _port_trainer(data.hier, "cpu")
    jtrainer = ref.loop.Trainer(None, None, CONFIG)
    for with_index in (False, True):
        got = ptrainer.stage_batches(data.batches, with_index=with_index)
        want = jtrainer.stage_batches(data.batches, with_index=with_index)
        assert got.keys() == want.keys()
        assert {"mask_host", "index"} & set(got) == (
            {"mask_host", "index"} if with_index else {"mask_host"})
        for k in got:
            np.testing.assert_array_equal(_numpy(got[k]), np.asarray(want[k]),
                                          err_msg=k)
        assert got["label"].dtype == torch.long
        assert isinstance(got["mask_host"], np.ndarray)
    assert ptrainer.stage_batches([]) is None
    perm = np.random.default_rng(0).permutation(3 * BATCH)
    got = port_loop.reshuffle_batches({k: got[k] for k in KEYS},
                                      torch.from_numpy(perm))
    want = ref.loop.reshuffle_batches({k: want[k] for k in KEYS},
                                      ref.jnp.asarray(perm))
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # each scanned step gathers its own row of that reshuffled epoch
    st = ptrainer._scan_state("train", ptrainer.stage_batches(data.batches),
                              *data.norm)
    st.perm.copy_(torch.from_numpy(perm))
    for i in range(3):
        st.step.fill_(i)
        batch = ptrainer._scan_batch(st)
        for k in KEYS:
            assert torch.equal(batch[k], got[k][i]), (i, k)


def test_finalizers_match_jax(ref):
    """finalize_train_metrics and finalize_eval_scanned (light, errors,
    collect, empty split) on the same packed arrays: the same averages,
    errors and meshes; the light variant refuses errors as the JAX one
    does."""
    rng = np.random.default_rng(1)
    s, b, n = 3, 4, 5
    packed = rng.random((s, 6)).astype(np.float32)
    packed[:, 5] = [4, 4, 2]
    want = ref.loop.Trainer.finalize_train_metrics(packed)
    for given in (packed, torch.from_numpy(packed),
                  HostCopy(torch.from_numpy(packed))):
        assert Trainer.finalize_train_metrics(given) == want
    assert (Trainer.finalize_train_metrics(None)
            == ref.loop.Trainer.finalize_train_metrics(None))

    mask = np.ones((s, b), np.float32)
    mask[2, 2:] = 0
    outs = {"scalars": rng.random((s, 7)).astype(np.float32),
            "errors": rng.random((s, b, n)).astype(np.float32),
            "recon_orig": rng.random((s, b, n, 3)).astype(np.float32),
            "oppo_orig": rng.random((s, b, n, 3)).astype(np.float32),
            "oppo_pred": rng.integers(0, 2, (s, b)),
            "oppo_label": rng.integers(0, 2, (s, b))}
    outs["scalars"][:, 4] = mask.sum(1)
    index = np.arange(s * b).reshape(s, b)
    jself = types.SimpleNamespace(extra_scalar_names=(),
                                  _EVAL_EMPTY=ref.loop.Trainer._EVAL_EMPTY)
    ptrainer = object.__new__(Trainer)
    keep = {"light": ("scalars",), "errors": ("scalars", "errors"),
            "collect": tuple(outs)}
    for variant, keys in keep.items():
        collect = variant == "collect"
        sub = {k: outs[k] for k in keys}
        jpending = {"outs": {k: ref.jnp.asarray(v) for k, v in sub.items()},
                    "index": index, "collect": collect, "mask_host": mask,
                    "mask_dev": None}
        ppending = {"outs": HostCopy({k: torch.from_numpy(v)
                                      for k, v in sub.items()}),
                    "index": index, "collect": collect, "mask_host": mask}
        with_errors = variant != "light"
        want = ref.loop.Trainer.finalize_eval_scanned(jself, jpending,
                                                      with_errors)
        got = ptrainer.finalize_eval_scanned(ppending, with_errors)
        assert got[0] == want[0], variant
        for g, w in zip(got[1:], want[1:]):
            if isinstance(w, dict):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            elif w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
        if variant == "light":
            with pytest.raises(ValueError, match="light"):
                ptrainer.finalize_eval_scanned(ppending, True)
    for with_errors in (False, True):
        got = ptrainer.finalize_eval_scanned(None, with_errors)
        want = ref.loop.Trainer.finalize_eval_scanned(jself, None,
                                                      with_errors)
        assert got[0] == want[0]
        assert (got[1] is None) == (want[1] is None)


def _layer_scale(named: dict, name: str) -> float:
    layer = name.rsplit(".", 1)[0]
    return max(np.abs(v).max() for k, v in named.items()
               if k.rsplit(".", 1)[0] == layer)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_scanned_train_epoch_matches_jax(ref, data, interpret, monkeypatch,
                                         precision):
    """One scanned epoch of three steps from the same weights with the
    same permutation, masks and noise: each step's packed metrics, and
    every parameter and Adam's step count after the epoch."""
    jtrainer, params, ptrainer = _paired(ref, data, precision)
    cfg = ptrainer.model.cfg
    noise = ref.utils.FedNoise(BATCH, cfg.num_hidden,
                               cfg.coarse_verts * cfg.filters[-1],
                               cfg.latent)
    ref.utils.feed_noise(monkeypatch, noise)
    perm = np.random.default_rng(2).permutation(3 * BATCH)
    monkeypatch.setattr(ref.jax.random, "permutation",
                        lambda key, n: ref.jnp.asarray(perm))
    mean, std = data.norm
    jparams, jopt, jpacked = jtrainer.train_epoch_scanned_async(
        params, jtrainer.init_opt_state(params),
        jtrainer.stage_batches(data.batches), ref.jax.random.key(0), mean,
        std, shuffle_key=ref.jax.random.key(1))
    noise.i = 0
    staged = ptrainer.stage_batches(data.batches)
    packed = ptrainer.train_epoch_scanned_async(
        staged, torch.Generator(), mean, std, perm=perm)
    assert noise.i == 3 * 4  # four masks per step, the same set each step
    got, want = packed.wait().numpy(), np.asarray(jpacked)
    assert got.shape == want.shape == (3, 6)
    np.testing.assert_allclose(got[:, [0, 1, 2, 4, 5]],
                               want[:, [0, 1, 2, 4, 5]], rtol=1e-5)
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-4)
    assert got[:, 5].sum() == N_MESHES  # the padding rides along
    avg = Trainer.finalize_train_metrics(packed)
    assert avg == pytest.approx(
        ref.loop.Trainer.finalize_train_metrics(jpacked), rel=1e-4)

    after = {k: v.numpy() for k, v in ref.utils.params_from_flax(
        ref.jax.tree_util.tree_map(np.asarray, jparams)).items()}
    for name, p in ptrainer.model.named_parameters():
        delta = np.abs(p.detach().numpy() - after[name]).max()
        assert delta <= 1e-4 * _layer_scale(after, name), (name, delta)
        assert int(ptrainer.optimizer.state[p]["step"]) == 3
    assert int(jopt.inner_state[1].count) == 3


@pytest.mark.parametrize("variant", ["light", "errors", "collect"])
def test_evaluate_scanned_matches_jax(ref, data, interpret, variant):
    """evaluate_scanned_async + finalize_eval_scanned in each variant on
    the same staged split and weights: the averages, the per-vertex errors
    and the collected meshes, labels and indices."""
    jtrainer, params, ptrainer = _paired(ref, data, "highest")
    collect, with_errors = variant == "collect", variant != "light"
    mean, std = data.norm
    jstaged = jtrainer.stage_batches(data.batches, with_index=collect)
    want = jtrainer.finalize_eval_scanned(
        jtrainer.evaluate_scanned_async(params, jstaged, mean, std,
                                        collect_meshes=collect,
                                        with_errors=with_errors),
        with_errors=with_errors)
    staged = ptrainer.stage_batches(data.batches, with_index=collect)
    got = ptrainer.finalize_eval_scanned(
        ptrainer.evaluate_scanned_async(staged, mean, std,
                                        collect_meshes=collect,
                                        with_errors=with_errors),
        with_errors=with_errors)
    assert len(got) == len(want)
    assert got[0].keys() == want[0].keys()
    for k in ("loss", "kld", "rec_loss"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got[0]["error"], want[0]["error"], rtol=1e-4)
    for k in ("accuracy", "sex_change_success_rate", "count"):
        assert got[0][k] == want[0][k], k
    assert got[0]["count"] == N_MESHES
    scale = np.abs(data.ds.original).max()
    if not with_errors:
        assert got[1] is None and want[1] is None
        assert "errors" not in ptrainer._scans["light"].outs
        return
    assert got[1].shape == (N_MESHES, data.hier.levels[0])
    assert np.abs(got[1] - want[1]).max() <= 1e-4 * scale
    if collect:
        assert got[2].keys() == want[2].keys()
        for k in ("index", "oppo_pred", "oppo_label"):
            np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)
        for k in ("recon", "oppo"):
            assert np.abs(got[2][k] - want[2][k]).max() <= 1e-4 * scale, k
        # the same as the per-batch evaluate over those batches
        avg, errors, meshes = ptrainer.evaluate(data.batches, mean, std,
                                                collect_meshes=True)
        assert avg == got[0]
        np.testing.assert_array_equal(errors, got[1])
        for k in meshes:
            np.testing.assert_array_equal(meshes[k], got[2][k], err_msg=k)


# --- the driver -------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """An 8x8 grid template, 16 synthetic meshes, a tiny fp32 config of
    2 folds x 3 epochs on the block-sparse path."""
    root = str(tmp_path_factory.mktemp("scan_driver"))
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
        "num_conv_filters": [8, 16, 16], "batch_size": 4, "epoch": 3,
        "hierarchy_cache_dir": os.path.join(root, "cache"),
        "cheb_method": "pallas", "matmul_precision": "highest",
    })
    return root, config


def _run(env, name, **overrides):
    root, config = env
    ckpt = os.path.join(root, name)
    config = dict(config, checkpoint_dir=ckpt,
                  log_file=os.path.join(ckpt, "log.txt"), **overrides)
    driver.run(config, do_train=True, do_test=False, device="cpu")
    hist = {}
    for fold in (1, 2):
        with open(os.path.join(ckpt, f"history{fold}.json")) as fp:
            hist[fold] = json.load(fp)
    with open(os.path.join(ckpt, "log.txt")) as fp:
        log = fp.read()
    return ckpt, hist, log


def _untimed(record: dict) -> dict:
    return {k: v for k, v in record.items()
            if k not in ("begin", "duration", "finalized")}


def test_pipelined_and_unpipelined_runs_are_equal(env):
    """pipeline_epochs True and False: equal histories (time fields
    aside) and equal checkpoints (params, Adam's state, lr as a float,
    epoch), though the pipelined one checkpoints from a snapshot one epoch
    late."""
    runs = {p: _run(env, f"pipeline_{p}", pipeline_epochs=p)
            for p in (True, False)}
    assert "scanned epoch" in runs[True][2] and "pipelined" in runs[True][2]
    assert "not pipelined" in runs[False][2]
    for fold in (1, 2):
        on, off = runs[True][1][fold], runs[False][1][fold]
        assert [h["epoch"] for h in on] == [1, 2, 3]
        assert [_untimed(h) for h in on] == [_untimed(h) for h in off]
        a, b = (load_checkpoint(checkpoint_path(runs[p][0], fold))
                for p in (True, False))
        assert a["epoch_num"] == b["epoch_num"]
        for k in a["model"]:
            torch.testing.assert_close(a["model"][k], b["model"][k],
                                       rtol=0, atol=0)
        assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
        assert isinstance(a["optimizer"]["param_groups"][0]["lr"], float)
        for i, st in a["optimizer"]["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(v, b["optimizer"]["state"][i][k],
                                           rtol=0, atol=0)


def test_lr_schedule_is_followed(env):
    """learning_rates [0] after epoch 1: epochs 2 and 3 leave the params
    as epoch 1 left them (the validation loss repeats, the last checkpoint
    holds epoch 1's params at lr 0), as a 1-epoch run shows."""
    ckpt, hist, _ = _run(env, "schedule", learning_rates=[0.0],
                         learning_rates_epochs=[1])
    one, _, _ = _run(env, "schedule_one", epoch=1)
    for fold in (1, 2):
        val = [h["validation"]["loss"] for h in hist[fold]]
        assert val[0] == val[1] == val[2], val
        assert hist[fold][0]["training"]["loss"] != hist[fold][1][
            "training"]["loss"]  # the epochs still ran, with dropout
        a = load_checkpoint(checkpoint_path(ckpt, fold))
        b = load_checkpoint(checkpoint_path(one, fold))
        assert (a["epoch_num"], b["epoch_num"]) == (3, 1)
        assert a["optimizer"]["param_groups"][0]["lr"] == 0.0
        for k in a["model"]:
            torch.testing.assert_close(a["model"][k], b["model"][k],
                                       rtol=0, atol=0)


def test_scan_epoch_false_takes_the_eager_loop(env, monkeypatch):
    """scan_epoch False (also as ``-p scan_epoch False``) runs train_epoch
    and evaluate and never the scanned epoch; the default never runs
    train_epoch."""
    assert apply_overrides(default_config(), [("scan_epoch", "False")])[
        "scan_epoch"] is False

    def refuse(*args, **kwargs):
        raise AssertionError("the wrong epoch loop ran")

    with monkeypatch.context() as m:
        m.setattr(Trainer, "train_epoch_scanned_async", refuse)
        m.setattr(Trainer, "evaluate_scanned_async", refuse)
        _, hist, log = _run(env, "eager", scan_epoch=False, epoch=1)
    assert "per-step epoch loop" in log
    assert [h["epoch"] for h in hist[1]] == [1]
    with monkeypatch.context() as m:
        m.setattr(Trainer, "train_epoch", refuse)
        m.setattr(Trainer, "evaluate", refuse)
        _, hist, log = _run(env, "scanned", epoch=1)
    assert "scanned epoch" in log and "eager steps on cpu" in log


@pytest.mark.parametrize("pipeline", [True, False])
def test_nonfinite_loss_halts_one_epoch_late(env, monkeypatch, pipeline):
    """A non-finite train loss at epoch 2: pipelined, epoch 3 is already
    queued when epoch 2 is read; the halt names epoch 1's checkpoint and
    the history keeps the failing epoch."""
    real = Trainer.finalize_train_metrics
    dispatched, read = [], []

    def finalize(packed):
        avg = real(packed)
        read.append(1)
        if len(read) == 2:
            avg["loss"] = float("nan")
        return avg

    real_async = Trainer.train_epoch_scanned_async

    def dispatch(self, *args, **kwargs):
        dispatched.append(1)
        return real_async(self, *args, **kwargs)

    monkeypatch.setattr(Trainer, "finalize_train_metrics",
                        staticmethod(finalize))
    monkeypatch.setattr(Trainer, "train_epoch_scanned_async", dispatch)
    with pytest.raises(RuntimeError, match="epoch 2 .*best checkpoint so "
                       "far: .*checkpoint_1.pt"):
        _run(env, f"nan_{pipeline}", pipeline_epochs=pipeline)
    assert len(dispatched) == (3 if pipeline else 2)
    ckpt = os.path.join(env[0], f"nan_{pipeline}")
    with open(os.path.join(ckpt, "history1.json")) as fp:
        assert [h["epoch"] for h in json.load(fp)] == [1, 2]
    assert load_checkpoint(checkpoint_path(ckpt, 1))["epoch_num"] == 1


def test_world_runs_eager_steps_and_says_so(data):
    """A trainer of a world (here a stand-in of dp=2, sp=1) never captures
    its steps, and the run log's epoch line says why; one process on the
    CPU runs eager steps too."""
    ptrainer = _port_trainer(data.hier, "cpu")
    assert not ptrainer.graphs
    world = types.SimpleNamespace(device=torch.device("cpu"), size=2, dp=2,
                                  sp=1, dp_rank=0)
    tr = _port_trainer(data.hier, "cpu", dist=world)
    assert not tr.graphs
    line = driver.epoch_mode({}, tr)
    assert "scanned epoch" in line and "pipelined" in line
    assert "collectives are not captured" in line
    assert driver.epoch_mode({"scan_epoch": False}, tr).startswith(
        "per-step epoch loop")
    assert "not pipelined" in driver.epoch_mode({"pipeline_epochs": "false"},
                                               ptrainer)


# --- the card ---------------------------------------------------------------

def _state(tr):
    return {"params": {k: v.detach().clone()
                       for k, v in tr.model.named_parameters()},
            "grads": {k: v.grad.detach().clone()
                      for k, v in tr.model.named_parameters()},
            "adam": {k: {n: t.clone() for n, t in
                         tr.optimizer.state[v].items()}
                     for k, v in tr.model.named_parameters()}}


@pytest.mark.cuda
def test_cuda_graphed_steps_match_eager(tmp_path):
    """On the card, the scanned epoch's CUDA graphs against the same steps
    run eagerly, from the same weights, batches, permutations and
    generator seed: two epochs (an lr change between them) bit-equal in
    the per-step metrics, the last gradients, the params and Adam's state;
    an epoch at lr 0 leaves the params as they were while fresh dropout
    draws change the loss of the same batch at every replay; the three
    eval variants equal; the launch counters count each replay; a resume
    (load_state_dict into the same optimizer) captures the graph again and
    repeats an epoch to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_grid_mesh(16, jitter=0.05)
    hier = build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2, 2, 2])
    template = TriMesh(hier.vertices[0], hier.faces[0])
    generate_synthetic_dataset(template, str(tmp_path / "data"),
                               n_samples=N_MESHES, seed=1)
    cfg = {"root_dir": str(tmp_path / "data"),
           "checkpoint_dir": str(tmp_path / "ckpt")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    batches = list(BatchIterator(ds, BATCH, shuffle=True, seed=3))
    rng = np.random.default_rng(0)
    perms = [rng.permutation(3 * BATCH) for _ in range(2)]
    same = np.tile(np.arange(BATCH), 3)  # one batch at every step
    runs = {}
    for graphs in (False, True):
        tr = _port_trainer(hier, "cuda")
        tr.graphs = graphs
        staged = tr.stage_batches(batches, with_index=True)
        norm = tr.norm_to_device(ds.mean, ds.std)
        gen = torch.Generator(device="cuda").manual_seed(7)
        out = {}
        bsr_spmm.reset_launches()
        for epoch, (lr, perm) in enumerate([(LR, perms[0]), (LR / 2,
                                                             perms[1])]):
            set_learning_rate(tr.optimizer, lr)
            out[f"metrics{epoch}"] = tr.train_epoch_scanned_async(
                staged, gen, *norm, perm=perm).wait().clone()
            out[f"state{epoch}"] = _state(tr)
        out["launches"] = sum(bsr_spmm.launches().values())
        set_learning_rate(tr.optimizer, 0.0)
        out["lr0"] = tr.train_epoch_scanned_async(
            staged, gen, *norm, perm=same).wait().clone()
        out["after_lr0"] = _state(tr)
        for variant in ("light", "errors", "collect"):
            out[variant] = tr.finalize_eval_scanned(
                tr.evaluate_scanned_async(
                    staged, *norm, collect_meshes=variant == "collect",
                    with_errors=variant != "light"),
                with_errors=variant != "light")
        if graphs:
            g = tr._scans["train"].graph
            assert g.graph is not None and g.replays == 3 * 3 - 1
        # a resume into the same optimizer replaces Adam's tensors: the
        # graph is captured again and the epoch repeats to the bit
        saved = (copy.deepcopy(tr.model.state_dict()),
                 copy.deepcopy(tr.optimizer.state_dict()))
        set_learning_rate(tr.optimizer, LR)
        repeats = []
        for _ in range(2):
            tr.model.load_state_dict(saved[0])
            # a copy: load_state_dict keeps the tensors it is given
            tr.optimizer.load_state_dict(copy.deepcopy(saved[1]))
            set_learning_rate(tr.optimizer, LR)
            gen.manual_seed(11)
            repeats.append(tr.train_epoch_scanned_async(
                staged, gen, *norm, perm=perms[0]).wait().clone())
        torch.testing.assert_close(repeats[0], repeats[1], rtol=0, atol=0)
        if graphs:  # two more warm-ups and captures, two replays each
            assert tr._scans["train"].graph.replays == 3 * 3 - 1 + 2 * 2
        out["resumed"] = repeats[0]
        runs[graphs] = out
    eager, graphed = runs[False], runs[True]
    assert graphed["launches"] == eager["launches"] > 0
    for key in ("metrics0", "metrics1", "lr0", "resumed"):
        torch.testing.assert_close(graphed[key], eager[key], rtol=0, atol=0)
    for key in ("state0", "state1", "after_lr0"):
        for part in ("params", "grads"):
            for k, v in eager[key][part].items():
                torch.testing.assert_close(graphed[key][part][k], v, rtol=0,
                                           atol=0, msg=f"{key} {part} {k}")
        for k, st in eager[key]["adam"].items():
            for n, v in st.items():
                torch.testing.assert_close(graphed[key]["adam"][k][n], v,
                                           rtol=0, atol=0)
    for k, v in graphed["state1"]["params"].items():
        torch.testing.assert_close(graphed["after_lr0"]["params"][k], v,
                                   rtol=0, atol=0)
    losses = graphed["lr0"][:, 0]
    assert len(set(losses.tolist())) == 3, losses  # fresh draws per replay
    for variant in ("light", "errors", "collect"):
        assert graphed[variant][0] == eager[variant][0]
        for g, e in zip(graphed[variant][1:], eager[variant][1:]):
            if isinstance(e, dict):
                for k in e:
                    np.testing.assert_array_equal(g[k], e[k], err_msg=k)
            elif e is not None:
                np.testing.assert_array_equal(g, e)
