"""meshvae_tpu_torch.models.vae against the flax MeshVAE: eval forward with
weights moved by params_from_flax, at both precisions, held to the bars of
tests/test_parity.py (mu, logvar, y_hat within 1e-5; recon within 1e-4)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc

from meshvae_tpu_torch.models import (MeshVAE, VAEConfig, load_params_npz,
                                      params_from_flax, save_params_npz)

from torch_port_utils import grid_hierarchy, paired_models


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
