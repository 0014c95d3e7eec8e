"""The training slice of meshvae_tpu_torch against the JAX package: the
losses, the dataset copy, the train-mode forward, one whole train step
(loss, every gradient, the Adam moments and the params after the update,
the packed metrics) and one eval step with the sex-change counterfactual.

Both sides get the same randomness: the dropout masks and the
reparameterisation noise are drawn with numpy and fed to the flax model
(a stand-in Dropout module, a patched reparameterize) and to the port
(patched ``_dropout`` / ``reparameterize``), in call order. The JAX
Pallas kernels run in interpret mode; the pool-backward fan-in cutoff is
set low on both sides so the block-sparse P^T is compared too.

Bars: loss and metrics rtol 1e-5 (pose error 1e-4); mu, logvar, y_hat
1e-5 and recon 1e-4; each gradient max|delta| <= 1e-4 max|g| at highest
and 1e-3 max|g| at high, max|g| taken over the layer (weight and bias);
params after one Adam step within 1e-2 lr."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.data.dataset import BatchIterator as JaxBatchIterator
from meshvae_tpu.data.dataset import MeshDataset as JaxMeshDataset
from meshvae_tpu.data.dataset import list_meshes as jax_list_meshes
from meshvae_tpu.models import losses as jax_losses
from meshvae_tpu.train import loop as jax_loop

from meshvae_tpu_torch.data import BatchIterator, MeshDataset, list_meshes
from meshvae_tpu_torch.mesh import TriMesh
from meshvae_tpu_torch.models import params_from_flax
from meshvae_tpu_torch.models import losses
from meshvae_tpu_torch.models import vae as port_vae
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops import pool as port_pool
from meshvae_tpu_torch.train import (Trainer, lr_for_epoch, set_learning_rate,
                                     unpack_metrics)

from torch_port_utils import (FedNoise, count_kernel_calls, feed_noise,
                              grid_hierarchy, paired_models, write_requests)

BATCH = 16      # B * F = 128 at F = 8: the pool backward takes P^T's kernel
TGRAD = 6       # grid up-pool fan-ins 9/7/7/5: three block-sparse P^T
DROPOUT = 0.2
LR, WD = 1e-3, 5e-4
CONFIG = {"num_classes": 2, "learning_rate": LR, "weight_decay": WD}
GRAD_BAR = {"highest": 1e-4, "high": 1e-3}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """20 synthetic meshes on the grid template, loaded by both packages'
    MeshDataset; batches of 16 (the second one padded)."""
    _, hier = grid_hierarchy()
    root = tmp_path_factory.mktemp("train")
    template = TriMesh(hier.vertices[0], hier.faces[0])
    cfg = {"root_dir": write_requests(template, str(root), n=20),
           "checkpoint_dir": str(root / "ckpt_port")}
    index, labels = list_meshes(cfg)
    port = MeshDataset(index, cfg, labels, template.v)
    jcfg = dict(cfg, checkpoint_dir=str(root / "ckpt_jax"))
    jindex, jlabels = jax_list_meshes(jcfg)
    ref = JaxMeshDataset(jindex, jcfg, jlabels, template.v)
    return hier, cfg, port, ref, (index, labels, jindex, jlabels)


def test_dataset_matches_jax(data):
    """Listing, labels, aligned and normalised arrays, inverse transforms,
    norm.npz and the padded batches, array for array."""
    hier, cfg, port, ref, (index, labels, jindex, jlabels) = data
    assert index == jindex and labels == jlabels
    assert sorted(set(labels.values())) == [0, 1]
    for name in ("aligned", "x", "labels", "r", "s", "m", "original", "mean",
                 "std"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    with np.load(f"{cfg['checkpoint_dir']}/norm.npz") as z:
        np.testing.assert_array_equal(z["mean"].astype(np.float32), port.mean)
    test = MeshDataset(index, cfg, labels, hier.vertices[0], dtype="test")
    np.testing.assert_array_equal(test.x, port.x)  # reads norm.npz
    got = list(BatchIterator(port, BATCH, shuffle=True, seed=3))
    want = list(JaxBatchIterator(ref, BATCH, shuffle=True, seed=3))
    assert len(got) == len(want) == 2
    assert got[1]["mask"].tolist() == [1.0] * 4 + [0.0] * 12
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    b, n, z = 6, 40, 5
    x, recon = (rng.standard_normal((b, n, 3)).astype(np.float32)
                for _ in range(2))
    mu, logvar = (0.5 * rng.standard_normal((b, z)).astype(np.float32)
                  for _ in range(2))
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    logits = rng.standard_normal((b, 2)).astype(np.float32)
    y_hat = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    assert losses.fixed_log_sigma() == jax_losses.fixed_log_sigma()
    for m in (None, mask):
        t = lambda a: None if a is None else torch.from_numpy(a)
        loss, aux = losses.vae_loss(t(x), t(recon), t(mu), t(logvar), t(y),
                                    t(y_hat), mask=t(m))
        jl, jaux = jax_losses.vae_loss(
            *(jnp.asarray(a) for a in (x, recon, mu, logvar, y, y_hat)),
            mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        for k in ("kld", "rec_loss", "logqy", "correct"):
            np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                       rtol=1e-5, err_msg=k)


def test_dropout_and_reparameterize_follow_the_generator(data):
    """Train mode draws every mask and eps from the given generator: the
    same seed repeats the forward exactly, another seed changes it; masks
    keep ~1 - p of the elements and scale them by 1 / (1 - p). Eval mode
    and generator-free training ignore the randomness."""
    x = torch.randn(400, 50, generator=torch.Generator().manual_seed(0))
    out = port_vae._dropout(x, DROPOUT, True,
                            torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - DROPOUT)) < 0.01
    torch.testing.assert_close(out[kept], x[kept] / (1 - DROPOUT))
    assert port_vae._dropout(x, DROPOUT, False, None) is x

    hier = data[0]
    _, _, _, model, ops = paired_models(hier, "highest", dropout=DROPOUT)
    xb = torch.from_numpy(data[2].x[:4])
    y = torch.eye(2)[torch.tensor([0, 1, 0, 1])]
    run = lambda seed: model(xb, y, ops, train=True,
                             generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c, ev = run(5), run(5), run(6), model(xb, y, ops)
    torch.testing.assert_close(a["recon"], b["recon"], rtol=0, atol=0)
    assert not torch.equal(a["recon"], c["recon"])
    assert not torch.equal(a["z"], a["mu"])
    torch.testing.assert_close(ev["z"], ev["mu"], rtol=0, atol=0)


def _paired_trainers(hier, precision):
    jmodel, jops, params, pmodel, pops = paired_models(
        hier, precision, dropout=DROPOUT, tgrad_ell_max=TGRAD)
    assert [p.t_bsr is not None for p in pops.up] == [True] * 3 + [False]
    jtrainer = jax_loop.Trainer(jmodel, jops, CONFIG)
    ptrainer = Trainer(pmodel, pops, CONFIG, device="cpu")
    return jtrainer, params, ptrainer


def _batches(data):
    _, _, port, _, _ = data
    return list(BatchIterator(port, BATCH)), (port.mean, port.std)


def _flax_named(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _layer_scale(named: dict, name: str) -> float:
    """max |g| over the layer's weight and bias: a bias gradient is the
    weight gradient's per-sample terms summed without the input factor, and
    can cancel to far below them (the 2-class classifier bias: +-6e-4
    against 5e-2), where float32 rounding of the terms sets its error."""
    layer = name.rsplit(".", 1)[0]
    return max(np.abs(v).max() for k, v in named.items()
               if k.rsplit(".", 1)[0] == layer)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_train_forward_matches_flax(data, monkeypatch, precision):
    """The train-mode forward at dropout 0.2 with the same masks and eps:
    mu, logvar, y_hat and z within 1e-5, recon within 1e-4."""
    hier = data[0]
    jmodel, jops, params, pmodel, pops = paired_models(hier, precision,
                                                       dropout=DROPOUT)
    cfg = pmodel.cfg
    noise = FedNoise(BATCH, cfg.num_hidden,
                      cfg.coarse_verts * cfg.filters[-1], cfg.latent, seed=1)
    feed_noise(monkeypatch, noise)
    batch = _batches(data)[0][0]
    x, y = batch["x"], np.eye(2, dtype=np.float32)[batch["label"]]
    ref = jax.jit(lambda p: jmodel.apply(p, jnp.asarray(x), jnp.asarray(y),
                                         jops, train=True))(params)
    noise.i = 0
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), torch.from_numpy(y), pops,
                     train=True, generator=torch.Generator())
    assert noise.i == 4
    for key in ("mu", "logvar", "y_hat", "z"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    delta = np.abs(got["recon"].numpy() - np.asarray(ref["recon"])).max()
    assert delta < 1e-4, delta


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_train_step_matches_jax(data, monkeypatch, precision):
    """One Trainer.train_step against _train_step_impl on a full batch at
    dropout 0.2 with the same masks and eps: loss, every gradient, the
    Adam moments, the params after the update and the packed metrics.
    The port's kernel calls: 2 per block-sparse conv forward (K = 3, four
    convs), 2 per backward except the first encoder conv's (x is data),
    and the three block-sparse pool transposes."""
    hier = data[0]
    batches, (mean, std) = _batches(data)
    batch = batches[0]
    jtrainer, params, ptrainer = _paired_trainers(hier, precision)
    cfg = ptrainer.model.cfg
    noise = FedNoise(BATCH, cfg.num_hidden,
                      cfg.coarse_verts * cfg.filters[-1], cfg.latent)
    feed_noise(monkeypatch, noise)

    jbatch = {k: jnp.asarray(batch[k])
              for k in ("x", "label", "r", "s", "m", "mask")}
    jargs = (jbatch, jax.random.key(0), jnp.asarray(mean), jnp.asarray(std),
             jtrainer.ops)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer._forward_loss(p, jbatch, None, True,
                                         jtrainer.ops),
        has_aux=True))(params)
    opt_state = jtrainer.init_opt_state(params)
    jparams, jopt, jmetrics = jax.jit(jtrainer._train_step_impl)(
        params, opt_state, *jargs)
    noise.i = 0

    calls = count_kernel_calls(monkeypatch, cheb=port_cheb, pool=port_pool)
    pbatch = ptrainer.to_device(batch)
    packed = ptrainer.train_step(pbatch, torch.Generator(),
                                 *ptrainer.norm_to_device(mean, std))
    # forward: enc_0, enc_1, dec_2, dec_3; backward: dec_3, up-pool 0,
    # dec_2, up-pools 1 and 2, enc_1 (up-pool 3 gathers; enc_0 has no dx)
    assert [name for name, _ in calls] == (
        ["cheb"] * 10 + ["pool"] + ["cheb"] * 2 + ["pool"] * 2
        + ["cheb"] * 2), calls
    assert noise.i == 4

    got, want = unpack_metrics(packed), unpack_metrics(jmetrics)
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    for k in ("loss", "kld", "rec_loss", "correct", "count"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-4)

    model = ptrainer.model
    params_now = dict(model.named_parameters())
    bar = GRAD_BAR[precision]
    grads = _flax_named(jgrads)
    assert set(grads) == set(params_now)
    # Adam's moments name for name: optax's (mu, nu) vs torch's
    # (exp_avg, exp_avg_sq) after one step, mu = 0.1 (g + wd p) and
    # nu = 0.001 (g + wd p)^2, so they carry the gradient's bar
    adam = jopt.inner_state[1]
    assert int(adam.count) == 1
    mu, nu = _flax_named(adam.mu), _flax_named(adam.nu)
    for name, p in params_now.items():
        state = ptrainer.optimizer.state[p]
        assert int(state["step"]) == 1
        for got_t, ref_t, scale_of in (
                (p.grad, grads, 1.0),
                (state["exp_avg"], mu, 1.0),
                (state["exp_avg_sq"], nu, 2.0)):
            delta = np.abs(got_t.numpy() - ref_t[name]).max()
            assert delta <= scale_of * bar * _layer_scale(ref_t, name), (
                name, delta)
    after = _flax_named(jparams)
    for name, p in params_now.items():
        delta = np.abs(p.detach().numpy() - after[name]).max()
        assert delta <= 1e-2 * LR, (name, delta)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_eval_step_matches_jax(data, precision):
    """One eval step on the padded batch: the packed scalars (loss, kld,
    rec_loss, correct, count, sc_correct, error sum), the original-pose
    reconstruction and the counterfactual's predicted labels."""
    hier = data[0]
    batches, (mean, std) = _batches(data)
    batch = batches[1]
    jtrainer, params, ptrainer = _paired_trainers(hier, precision)
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("x", "label", "r", "s", "m", "mask")}
    want = jax.jit(jtrainer._eval_step_impl)(
        params, jbatch, jnp.asarray(mean), jnp.asarray(std), jtrainer.ops)
    got = ptrainer.eval_step(ptrainer.to_device(batch),
                             *ptrainer.norm_to_device(mean, std))
    sc, ref = got["scalars"].numpy(), np.asarray(want["scalars"])
    np.testing.assert_allclose(sc[:6], ref[:6], rtol=1e-5)
    np.testing.assert_allclose(sc[6], ref[6], rtol=1e-4)
    scale = np.abs(batch["original"]).max()
    delta = np.abs(got["recon_orig"].numpy()
                   - np.asarray(want["recon_orig"])).max()
    assert delta <= 1e-4 * scale, delta
    np.testing.assert_array_equal(got["oppo_pred"].numpy(),
                                  np.asarray(want["oppo_pred"]))
    np.testing.assert_array_equal(got["oppo_label"].numpy(),
                                  np.asarray(want["oppo_label"]))


def test_train_epochs_lower_the_loss(data):
    """Three epochs through train_epoch (dropout on, a seeded generator)
    lower the eval loss of a fixed batch; evaluate() returns finite
    averages, a sex-change rate in [0, 1] and one error row per mesh. The
    step LR schedule and set_learning_rate agree with the JAX package."""
    hier = data[0]
    batches, (mean, std) = _batches(data)
    _, _, ptrainer = _paired_trainers(hier, "highest")
    norm = ptrainer.norm_to_device(mean, std)
    fixed = ptrainer.to_device(batches[0])
    before = ptrainer.eval_step(fixed, *norm)["scalars"][0].item()
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        avg = ptrainer.train_epoch(batches, gen, mean, std)
        assert avg["count"] == 20 and np.isfinite(avg["loss"])
    after = ptrainer.eval_step(fixed, *norm)["scalars"][0].item()
    assert after < before, (before, after)
    avg, errors = ptrainer.evaluate(batches, mean, std)
    assert avg["count"] == 20 and errors.shape == (20, hier.levels[0])
    assert all(np.isfinite(v) for v in avg.values())
    assert 0.0 <= avg["sex_change_success_rate"] <= 1.0

    for epoch in range(0, 12, 3):
        args = (epoch, LR, [5e-4, 1e-4], [4, 8])
        assert lr_for_epoch(*args) == jax_loop.lr_for_epoch(*args)
    set_learning_rate(ptrainer.optimizer, 1e-4)
    assert ptrainer.optimizer.param_groups[0]["lr"] == 1e-4
    fresh = ptrainer.init_params(3)
    assert ptrainer.optimizer.state == {}
    assert set(fresh) == set(ptrainer.model.state_dict())
