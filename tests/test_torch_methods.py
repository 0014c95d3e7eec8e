"""cheb_method = ell and pool_method = dense in meshvae_tpu_torch against the
JAX package on the CPU, at matmul_precision highest: the ELL operator
layout, the ELL Chebyshev conv (a grid level and the embedded final-conv
operator's active_n corner) and the dense pool, forward and backward; one
deterministic train step (no dropout, z = mu) of a small MeshVAE under
ell, under pallas with the dense pool, and under both; the ELL byte count
of validate.py against a hand count; and the driver admitting both keys.

Bars: conv and pool forward 1e-5; gradients max|delta| <= 1e-4 max|g|
(the layer's max|g| in the train step); loss rtol 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.pallas_cheb as pc
from meshvae_tpu.models.operators import build_operators as jax_build_ops
from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig
from meshvae_tpu.ops import graph as jax_graph
from meshvae_tpu.ops.cheb import cheb_conv as jax_cheb_conv
from meshvae_tpu.ops.pool import pool_apply as jax_pool_apply
from meshvae_tpu.train import loop as jax_loop

from meshvae_tpu_torch import validate
from meshvae_tpu_torch.models import (MeshVAE, VAEConfig, build_operators,
                                      params_from_flax)
from meshvae_tpu_torch.models.operators import CHEB_METHODS
from meshvae_tpu_torch.ops import cheb as port_cheb
from meshvae_tpu_torch.ops import graph
from meshvae_tpu_torch.ops import pool as port_pool
from meshvae_tpu_torch.ops.cheb import cheb_conv
from meshvae_tpu_torch.ops.pool import pool_apply
from meshvae_tpu_torch.train import Trainer

from torch_port_utils import (BSR_MIN_N, FILTERS, ORDERS, count_kernel_calls,
                              grid_hierarchy, jax_hierarchy)

BATCH = 16     # B * F = 128 at F = 8: the gather pool's backward takes P^T
TGRAD = 6      # grid up-pool fan-ins 9/7/7/5: three block-sparse P^T
CONFIG = {"num_classes": 2, "learning_rate": 1e-3, "weight_decay": 5e-4}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


@pytest.fixture(scope="module")
def hier():
    return grid_hierarchy()[1]


def _ops(hier, cheb_method, pool_method):
    """(JAX operators, port operators) of the grid hierarchy for the two
    methods, the finest two levels block-sparse under pallas and the pool
    transposes above fan-in TGRAD block-sparse, on both sides."""
    old = (jax_graph.PALLAS_MIN_N, jax_graph.TGRAD_ELL_MAX,
           graph.TGRAD_ELL_MAX)
    jax_graph.PALLAS_MIN_N = BSR_MIN_N
    jax_graph.TGRAD_ELL_MAX = graph.TGRAD_ELL_MAX = TGRAD
    try:
        jops = jax_build_ops(jax_hierarchy(hier), cheb_method=cheb_method,
                             pool_method=pool_method)
        pops = build_operators(hier, "cpu", cheb_method=cheb_method,
                               bsr_min_n=BSR_MIN_N, pool_method=pool_method)
    finally:
        (jax_graph.PALLAS_MIN_N, jax_graph.TGRAD_ELL_MAX,
         graph.TGRAD_ELL_MAX) = old
    return jops, pops


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, "final"])
def test_ell_layout_matches_jax(hier, level):
    """Every level's neighbour list, and the embedded final operator's
    corner, as the JAX package's _to_ell(pad_self=True): the same indices
    (self-padded), the same float32 weights (0 on the padding)."""
    jops, pops = _ops(hier, "ell", "gather")
    jop, pop = ((jops.lap_final, pops.lap_final) if level == "final"
                else (jops.lap[level], pops.lap[level]))
    assert pop.dense is None and pop.bsr is None
    assert (pop.n, pop.active_n) == (jop.n, jop.active_n)
    assert pop.ell_idx.shape[1] == jop.max_degree
    if level != "final":  # the width validate.py counts the gather with
        assert validate.level0_shape(hier.adjacency[level]) == (
            pop.active_n, pop.ell_idx.shape[1])
    np.testing.assert_array_equal(pop.ell_idx.numpy(),
                                  np.asarray(jop.ell_idx))
    np.testing.assert_array_equal(pop.ell_w.numpy(), np.asarray(jop.ell_w))
    assert pop.ell_w.dtype == torch.float32 and pop.dtype == torch.float32


def _conv_inputs(n, b=4, f_in=3, f_out=8, k=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, f_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, f_in, f_out))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f_out)).astype(np.float32)
    g = rng.standard_normal((b, n, f_out)).astype(np.float32)
    return x, w, bias, g


@pytest.mark.parametrize("which", ["level0", "final"])
def test_ell_conv_and_gradients_match_jax(hier, which):
    """cheb_conv on the ELL layout: forward within 1e-5, the input and
    weight gradients (the cotangent g) within 1e-4 of their max|g|; on the
    embedded final operator the recurrence runs on the active_n corner and
    one product on the rest."""
    jops, pops = _ops(hier, "ell", "gather")
    jop, pop = ((jops.lap_final, pops.lap_final) if which == "final"
                else (jops.lap[0], pops.lap[0]))
    x, w, bias, g = _conv_inputs(pop.n)

    def jax_out(x_, w_):
        return jax_cheb_conv(x_, jop, w_, jnp.asarray(bias), method="ell",
                             precision="highest")

    ref, vjp = jax.vjp(jax_out, jnp.asarray(x), jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = cheb_conv(xt, pop, wt, torch.from_numpy(bias), precision="highest")
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for name, mine, theirs in (("dx", xt.grad, ref_dx), ("dw", wt.grad,
                                                         ref_dw)):
        theirs = np.asarray(theirs)
        delta = np.abs(mine.numpy() - theirs).max()
        assert delta <= 1e-4 * np.abs(theirs).max(), (name, delta)


@pytest.mark.parametrize("which", ["down0", "up0", "up3"])
def test_dense_pool_matches_jax(hier, which):
    """pool_apply(method="dense") forward within 1e-5 and its backward
    P^T @ g within 1e-4 of max|g|; the operator holds only the dense
    matrix."""
    jops, pops = _ops(hier, "dense", "dense")
    kind, i = which[:-1], int(which[-1])
    jpool, ppool = getattr(jops, kind)[i], getattr(pops, kind)[i]
    assert ppool.idx is None and ppool.t_bsr is None
    np.testing.assert_array_equal(ppool.dense.numpy(),
                                  np.asarray(jpool.dense))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, ppool.n_in, 8)).astype(np.float32)
    g = rng.standard_normal((4, ppool.n_out, 8)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x_: jax_pool_apply(
        x_, jpool, method="dense", precision="highest"), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = pool_apply(xt, ppool, "dense")
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    ref_dx = np.asarray(ref_dx)
    assert np.abs(xt.grad.numpy() - ref_dx).max() <= 1e-4 * np.abs(
        ref_dx).max()
    with pytest.raises(ValueError, match="dense layout"):
        pool_apply(xt, getattr(_ops(hier, "dense", "gather")[1], kind)[i],
                   "dense")


def _layer_scale(named: dict, name: str) -> float:
    layer = name.rsplit(".", 1)[0]
    return max(np.abs(v).max() for k, v in named.items()
               if k.rsplit(".", 1)[0] == layer)


def _batch(n, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, n, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.standard_normal((BATCH, 3, 3)))[0]
    mask = np.ones(BATCH, np.float32)
    mask[-3:] = 0.0  # a padded batch's last rows
    return {"x": x, "label": rng.integers(0, 2, BATCH).astype(np.int32),
            "r": rot.astype(np.float32),
            "s": rng.uniform(0.5, 2.0, BATCH).astype(np.float32),
            "m": rng.standard_normal((BATCH, 1, 3)).astype(np.float32),
            "mask": mask}


@pytest.mark.parametrize("cheb_method,pool_method", [
    ("ell", "gather"), ("pallas", "dense"), ("ell", "dense")])
def test_train_step_matches_jax(hier, monkeypatch, cheb_method, pool_method):
    """One deterministic train step (no dropout, z = mu) of the grid
    MeshVAE against the JAX package's loss and gradients at highest: loss
    rtol 1e-5, every gradient within 1e-4 of its layer's max|g|. The
    port's kernel calls: under ell none in the convs (the pool backward
    still runs the three block-sparse P^T), under the dense pool none in
    the pools."""
    jops, pops = _ops(hier, cheb_method, pool_method)
    common = dict(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                  n_layers=4, num_hidden=32, latent=6, num_classes=2,
                  dropout=0.2, coarse_verts=hier.levels[-1],
                  precision="highest", pool_method=pool_method)
    jmodel = JaxMeshVAE(JaxVAEConfig(**common, cheb_method=cheb_method))
    n = hier.levels[0]
    dense_ops = jax_build_ops(jax_hierarchy(hier), cheb_method="dense",
                              pool_method="gather")
    params = jax.tree_util.tree_map(np.asarray, JaxMeshVAE(
        dataclasses.replace(jmodel.cfg, cheb_method="dense",
                            pool_method="gather")).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, n, 3)),
        jnp.zeros((1, 2)), dense_ops, train=False))
    pmodel = MeshVAE(VAEConfig(**common))
    pmodel.load_state_dict(params_from_flax(params))

    batch = _batch(n)
    mean = np.zeros((n, 3), np.float32)
    std = np.ones((n, 3), np.float32)
    jtrainer = jax_loop.Trainer(jmodel, jops, CONFIG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer._forward_loss(p, jbatch, None, False, jops),
        has_aux=True))(params)

    calls = count_kernel_calls(monkeypatch, cheb=port_cheb, pool=port_pool)
    ptrainer = Trainer(pmodel, pops, CONFIG, device="cpu")
    packed = ptrainer.train_step(ptrainer.to_device(batch), None,
                                 *ptrainer.norm_to_device(mean, std))
    names = [name for name, _ in calls]
    assert names.count("cheb") == (0 if cheb_method == "ell" else 14)
    assert names.count("pool") == (0 if pool_method == "dense" else 3)

    np.testing.assert_allclose(packed[0].item(), float(jloss), rtol=1e-5)
    grads = {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    named = dict(pmodel.named_parameters())
    assert set(grads) == set(named)
    for name, p in named.items():
        delta = np.abs(p.grad.numpy() - grads[name]).max()
        assert delta <= 1e-4 * _layer_scale(grads, name), (name, delta)


def test_ell_step_bytes_matches_a_hand_count():
    """validate.ell_step_bytes at a grid shape, counted by hand: B = 4,
    N = 256, D = 6, float32; the VAE's level-0 convs 3 -> 8 (K = 3) and
    8 -> 8 (K = 3), and in the joint model the decoder's at 8 rows and the
    GCN's 6 -> 8."""
    cfg = {"num_conv_filters": list(FILTERS), "polygon_order": list(ORDERS),
           "n_layers": 4}
    assert validate.level0_convs(cfg) == [(1, 3, 3, 8), (1, 3, 8, 8)]
    got = validate.ell_step_bytes(4, 256, 6, validate.level0_convs(cfg), 4)
    gather = 4 * 256 * 6 * 8 * 4                       # the 8-wide conv's
    kept = 4 * 256 * (3 * 3 + 8) * 4 + 4 * 256 * (3 * 8 + 8) * 4
    assert got == {"gather": gather, "transient": 2 * gather, "kept": kept,
                   "total": kept + 2 * gather}
    joint = validate.level0_convs(dict(cfg, type="joint_VAE"))
    assert joint == [(1, 3, 3, 8), (2, 3, 8, 8), (1, 3, 6, 8)]
    got = validate.ell_step_bytes(4, 256, 6, joint, 2)
    kept = (4 * 256 * (3 * 3 + 8) + 8 * 256 * (3 * 8 + 8)
            + 4 * 256 * (3 * 6 + 8)) * 2
    assert got["total"] == kept + 2 * 8 * 256 * 6 * 8 * 2
    finest = validate.level0_convs(dict(cfg,
                                        final_conv_adjacency="finest"))
    assert finest[-1] == (1, 3, 8, 3)


def test_validate_refuses_an_ell_config_that_cannot_fit():
    """On CUDA a cheb_method = ell config whose level-0 bytes exceed the
    card is refused with the batch that fits; on the CPU, and for another
    cheb_method, the check does not run."""
    cfg = {"num_conv_filters": [16, 16, 16, 32, 32],
           "polygon_order": [10] * 5, "n_layers": 4, "batch_size": 1024,
           "cheb_method": "ell", "compute_dtype": "float32"}
    level0 = (79968, 12)
    need = validate.ell_step_bytes(
        1024, *level0, validate.level0_convs(cfg), 4)["total"]
    card = 80 * 2**30
    assert need > card
    with pytest.raises(validate.ConfigError, match="batch_size to at most"):
        validate.validate_config(cfg, "cuda", n_devices=1, level0=level0,
                                 card_bytes=card)
    validate.validate_config(cfg, "cpu", level0=level0, card_bytes=card)
    validate.validate_config(dict(cfg, cheb_method="pallas"), "cuda",
                             n_devices=1, level0=level0, card_bytes=card)
    validate.validate_config(dict(cfg, batch_size=32), "cuda", n_devices=1,
                             level0=level0, card_bytes=card)


def test_ell_memory_counts_the_rank_rows_under_sp():
    """Under seq_parallel validate.ell_step_bytes counts a card's rows of
    level 0 (R = 128 * ceil(N / (sp * 128))) for the kept bases and the
    gather, plus the all-gathered [B, sp * R, F_in] operand; by hand at
    B = 4, N = 256, D = 6, sp = 2 (R = 128). A config that does not fit
    one card in one process is admitted over seq_parallel 4, where each
    card holds a quarter of the rows."""
    cfg = {"num_conv_filters": list(FILTERS), "polygon_order": list(ORDERS),
           "n_layers": 4}
    convs = validate.level0_convs(cfg)
    got = validate.ell_step_bytes(4, 256, 6, convs, 4, sp=2)
    gather = 4 * 128 * 6 * 8 * 4
    operand = 4 * 256 * 8 * 4
    kept = 4 * 128 * (3 * 3 + 8) * 4 + 4 * 128 * (3 * 8 + 8) * 4
    assert got == {"gather": gather, "transient": 2 * gather + operand,
                   "kept": kept, "total": kept + 2 * gather + operand}
    assert validate.ell_step_bytes(4, 256, 6, convs, 4, sp=1) == \
        validate.ell_step_bytes(4, 256, 6, convs, 4)
    big = {"num_conv_filters": [16, 16, 16, 32, 32],
           "polygon_order": [10] * 5, "n_layers": 4, "batch_size": 512,
           "cheb_method": "ell", "compute_dtype": "float32"}
    level0 = (79968, 12)
    one = validate.ell_step_bytes(512, *level0, validate.level0_convs(big),
                                  4)["total"]
    four = validate.ell_step_bytes(512, *level0, validate.level0_convs(big),
                                   4, sp=4)["total"]
    card = (one + four) // 2
    assert four < card < one
    with pytest.raises(validate.ConfigError, match="seq_parallel 1"):
        validate.validate_config(big, "cuda", n_devices=4, level0=level0,
                                 card_bytes=card)
    validate.validate_config(dict(big, seq_parallel=4), "cuda", n_devices=4,
                             level0=level0, card_bytes=card)


def test_driver_admits_both_methods_and_the_reference_hierarchy():
    """The drivers' preflight (validate_config) admits pool_method dense,
    cheb_method ell and hierarchy_mode reference, in one process and in a
    world (no key of the JAX config schema is refused since the
    classifiers run in a world); build_operators knows every JAX
    cheb_method."""
    assert set(CHEB_METHODS) == {"dense", "ell", "pallas"}
    methods = {"pool_method": "dense", "cheb_method": "ell",
               "hierarchy_mode": "reference", "batch_size": 16}
    validate.validate_config(methods, "cpu")
    validate.validate_config(dict(methods, data_parallel=2), "cpu")
    with pytest.raises(ValueError, match="unknown pool method"):
        build_operators(grid_hierarchy()[1], "cpu", pool_method="scatter")
