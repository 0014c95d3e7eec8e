"""meshvae_tpu_torch.models.vae against the flax MeshVAE: eval forward with
weights moved by params_from_flax, at both precisions, held to the bars of
tests/test_parity.py (mu, logvar, y_hat within 1e-5; recon within 1e-4);
the linear-head rule (``vae.dense``) of the VAE's posterior mean, the
GCN's and the joint model's heads against flax's Dense, bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.models.vae import _dense as jax_dense

from meshvae_tpu_torch.models import (GCNConfig, JointMeshVAE, MeshVAE,
                                      VAEConfig, load_params_npz,
                                      params_from_flax, save_params_npz)
from meshvae_tpu_torch.models.vae import dense

from torch_port_utils import DTYPES, grid_hierarchy, paired_models


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def hier():
    return grid_hierarchy()[1]


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_eval_forward_matches_flax(hier, precision):
    jmodel, jops, params, pmodel, pops = paired_models(hier, precision)
    assert pops.lap[0].bsr is not None and pops.lap[1].bsr is not None
    assert jops.lap[0].bsr is not None and jops.lap[2].bsr is None
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, hier.levels[0], 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    ref = jmodel.apply(params, jnp.asarray(x), jnp.asarray(y), jops,
                       train=False)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), torch.from_numpy(y), pops)
    for key in ("mu", "logvar", "y_hat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    delta = np.abs(got["recon"].numpy() - np.asarray(ref["recon"])).max()
    assert delta < 1e-4, delta


def test_params_from_flax_names_and_npz_roundtrip(hier, tmp_path):
    _, _, params, pmodel, _ = paired_models(hier, "highest")
    sd = params_from_flax(params)
    assert set(sd) == set(pmodel.state_dict())
    p = params["params"]
    np.testing.assert_array_equal(sd["enc_lin.weight"].numpy(),
                                  p["enc_lin"]["kernel"].T)
    np.testing.assert_array_equal(sd["cheb_enc_0.weight"].numpy(),
                                  p["cheb_enc_0"]["weight"])
    assert "cheb_dec_4.bias" not in sd  # the final conv has no bias
    path = str(tmp_path / "params.npz")
    save_params_npz(path, pmodel.state_dict())
    loaded = load_params_npz(path)
    fresh = MeshVAE(pmodel.cfg, generator=torch.Generator().manual_seed(5))
    fresh.load_state_dict(loaded)
    for k, v in pmodel.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_init_distributions(hier):
    """N(0, 0.1) Chebyshev weights and biases and enc_lin/dec_lin weights;
    U(+-1/sqrt(fan_in)) elsewhere; the same seed draws the same weights."""
    cfg = VAEConfig(num_features=3, filters=(16, 16, 16, 32, 32),
                    polygon_order=(6,) * 5, n_layers=4, num_hidden=64,
                    latent=8, num_classes=2, dropout=0.2, coarse_verts=20)
    a = MeshVAE(cfg, generator=torch.Generator().manual_seed(1))
    b = MeshVAE(cfg, generator=torch.Generator().manual_seed(1))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    for name in ("cheb_enc_1.weight", "cheb_dec_0.weight", "enc_lin.weight",
                 "dec_lin.weight"):
        std = a.state_dict()[name].std().item()
        assert 0.09 < std < 0.11, (name, std)
    for lin in (a.dec_lin_2, a.classifier_layer, a.z_mean):
        bound = 1.0 / np.sqrt(lin.in_features)
        for t in (lin.weight, lin.bias):
            assert t.abs().max().item() <= bound
            assert t.abs().max().item() > 0.5 * bound


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_heads_follow_flax_dense(hier, compute_dtype):
    """Every head the classifier paths added to the Dense rule, on a tiny
    joint model: the VAE's posterior_mean (and the joint model's
    delegation), the GCN's enc_lin and cls_layer and the joint model's
    sup_head and adv_head, against flax's Dense(dtype=) at the precision
    the JAX package gives them, bit for bit; in float32 also equal to
    layer(x). Weights and inputs are small dyadic numbers, so every
    product and fp32 sum is exact in any order and only the rule's
    roundings (x @ W^T to bf16, then + b in bf16) can differ; in bf16 one
    rounding of x @ W^T + b must differ somewhere, so the test sees the
    second rounding."""
    jdtype, pdtype = DTYPES[compute_dtype]
    precision = "default" if compute_dtype == "bfloat16" else "highest"
    common = dict(filters=(8, 8, 8, 16, 16), polygon_order=(3,) * 5,
                  n_layers=4, num_classes=2, coarse_verts=hier.levels[-1],
                  precision=precision, compute_dtype=compute_dtype)
    model = JointMeshVAE(
        VAEConfig(num_features=3, num_hidden=32, latent=6, dropout=0.2,
                  **common),
        GCNConfig(num_features=6, **common), 2)
    rng = np.random.default_rng(3)
    heads = {"posterior_mean": model.vae.z_mean,
             "gcn.enc_lin": model.gcn.enc_lin,
             "gcn.cls_layer": model.gcn.cls_layer,
             "sup_head": model.sup_head, "adv_head": model.adv_head}
    assert model.gcn.cfg.dtype == model.cfg.dtype == pdtype
    differs = 0
    for name, layer in heads.items():
        w = rng.integers(-8, 9, layer.weight.shape).astype(np.float32) / 16
        b = rng.integers(-64, 65, layer.bias.shape).astype(np.float32) / 64
        x = rng.integers(-8, 9, (5, layer.in_features)).astype(np.float32)
        x /= 8
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w))
            layer.bias.copy_(torch.from_numpy(b))
            xt = torch.from_numpy(x)
            if name == "posterior_mean":
                got = model.vae.posterior_mean(xt)
                torch.testing.assert_close(model.posterior_mean(xt), got,
                                           rtol=0, atol=0)
            else:
                got = dense(layer, xt, model.cfg.dtype)
            plain = layer(xt)
        flax = jax_dense(layer.out_features, layer.in_features,
                         precision=precision, dtype=jdtype)
        want = flax.apply({"params": {"kernel": w.T, "bias": b}},
                          jnp.asarray(x))
        assert got.dtype == pdtype and want.dtype == jdtype, name
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32), name)
        if compute_dtype == "float32":
            torch.testing.assert_close(got, plain, rtol=0, atol=0)
        else:
            differs += int((plain.to(pdtype) != got).sum())
    assert compute_dtype == "float32" or differs > 0
