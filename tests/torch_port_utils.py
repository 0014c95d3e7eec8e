"""Shared set-up for the tests that hold meshvae_tpu_torch against the JAX
package end to end: one grid-mesh hierarchy fed to both packages, a flax
MeshVAE (or ChebGCN, or joint model) with its params, and the port's model
loaded from the same params through params_from_flax."""
import dataclasses
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import flax.linen as flax_nn

import meshvae_tpu.ops.graph as jax_graph
from meshvae_tpu.mesh.hierarchy import MeshHierarchy as JaxHierarchy
from meshvae_tpu.models.gcn import ChebGCN as JaxChebGCN
from meshvae_tpu.models.gcn import GCNConfig as JaxGCNConfig
from meshvae_tpu.models.joint import JointMeshVAE as JaxJointMeshVAE
from meshvae_tpu.models.operators import build_operators as jax_build_ops
from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig

from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy
from meshvae_tpu_torch.models import (ChebGCN, GCNConfig, JointMeshVAE,
                                      MeshVAE, VAEConfig, build_operators,
                                      params_from_flax)
from meshvae_tpu_torch.models import vae as port_vae
from meshvae_tpu_torch.ops import graph as port_graph

from conftest import make_grid_mesh

# a 256-vertex grid: levels 256/128/64/32/16, so at this cutoff the two
# finest levels take the block-sparse path, as 4998/1250 do at config 1
BSR_MIN_N = 128
FILTERS = (8, 8, 8, 16, 16)
ORDERS = (3, 3, 3, 3, 3)  # K = 3 runs both the alpha=1 and the seeded step


def grid_hierarchy():
    mesh = make_grid_mesh(16, jitter=0.05)
    return mesh, build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2, 2, 2])


def jax_hierarchy(h):
    return JaxHierarchy(h.vertices, h.faces, h.adjacency, h.downsample,
                        h.upsample)


# compute_dtype -> (the JAX package's dtype, the port's)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def paired_models(hier, precision, dropout=0.2, tgrad_ell_max=None,
                  compute_dtype="float32", orders=ORDERS, jit_init=False):
    """(jax_model, jax_ops, flax params as numpy, port_model, port_ops) with
    identical weights. The JAX side takes the Pallas path (run it under
    pallas_cheb.INTERPRET = True). tgrad_ell_max, when given, is the
    pool-backward fan-in cutoff on both sides while the operators are
    built (6 on the grid gives up-pools 0-2 a block-sparse P^T and up-pool
    3 gathers, as config 1 has). compute_dtype "bfloat16" builds both
    models and both operator sets in bf16; orders sets K per layer.
    jit_init draws the params under jit (faster; other values than the
    eager init's)."""
    jdtype, pdtype = DTYPES[compute_dtype]
    jcfg = JaxVAEConfig(num_features=3, filters=FILTERS, polygon_order=orders,
                        n_layers=4, num_hidden=32, latent=6, num_classes=2,
                        dropout=dropout, coarse_verts=hier.levels[-1],
                        cheb_method="pallas", precision=precision,
                        compute_dtype=compute_dtype)
    jops, pops = paired_operators(hier, "pallas", tgrad_ell_max, jdtype,
                                  pdtype)
    # params do not depend on the operator layout: init on the dense path
    init_model = JaxMeshVAE(dataclasses.replace(
        jcfg, cheb_method="dense", compute_dtype="float32"))
    init_args = ({"params": jax.random.key(0)},
                 jnp.zeros((1, hier.levels[0], 3), jnp.float32),
                 jnp.zeros((1, 2), jnp.float32))
    if jit_init:
        params = _jit_init(init_model, hier, *init_args, train=False)
    else:
        dense_ops = jax_build_ops(jax_hierarchy(hier), cheb_method="dense",
                                  pool_method="gather")
        params = init_model.init(*init_args, dense_ops, train=False)
        params = jax.tree_util.tree_map(np.asarray, params)

    pcfg = VAEConfig(num_features=3, filters=FILTERS, polygon_order=orders,
                     n_layers=4, num_hidden=32, latent=6, num_classes=2,
                     dropout=dropout, coarse_verts=hier.levels[-1],
                     precision=precision, compute_dtype=compute_dtype)
    pmodel = MeshVAE(pcfg)
    pmodel.load_state_dict(params_from_flax(params))
    pmodel.eval()
    return JaxMeshVAE(jcfg), jops, params, pmodel, pops


def paired_operators(hier, cheb_method="pallas", tgrad_ell_max=None,
                     jdtype=jnp.float32, pdtype=torch.float32):
    """(JAX operators, port operators) of one hierarchy, the finest two
    grid levels block-sparse on both sides with cheb_method "pallas";
    tgrad_ell_max, when given, is the pool-backward fan-in cutoff on both
    sides while they are built."""
    old = (jax_graph.PALLAS_MIN_N, jax_graph.TGRAD_ELL_MAX,
           port_graph.TGRAD_ELL_MAX)
    jax_graph.PALLAS_MIN_N = BSR_MIN_N
    if tgrad_ell_max is not None:
        jax_graph.TGRAD_ELL_MAX = port_graph.TGRAD_ELL_MAX = tgrad_ell_max
    try:
        jops = jax_build_ops(jax_hierarchy(hier), cheb_method=cheb_method,
                             pool_method="gather", dtype=jdtype)
        pops = build_operators(hier, "cpu", cheb_method=cheb_method,
                               bsr_min_n=BSR_MIN_N, dtype=pdtype)
    finally:
        (jax_graph.PALLAS_MIN_N, jax_graph.TGRAD_ELL_MAX,
         port_graph.TGRAD_ELL_MAX) = old
    return jops, pops


ULP = 2.0 ** -8  # one bf16 ulp relative to the largest |y|
BAR = 5e-2       # the JAX package's bf16 bar


def to_np(t) -> np.ndarray:
    """float32 numpy of a torch tensor or a jax array (bf16 included)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def bf16_ulp(v) -> np.ndarray:
    """One bf16 ulp at |v|: the spacing of bf16 numbers there (8
    significant bits)."""
    mag = np.maximum(np.abs(np.asarray(v, np.float64)),
                     np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def closer(name, got, j16, j32, scale, ulp=None):
    """The bf16 bar of the port's tests (max abs deltas), got the port's
    bf16 result, j16 and j32 the JAX package's bf16 and fp32 results:
    1. |port - jax_bf16| <= |jax_bf16 - jax_fp32| + one bf16 ulp of the
       scale. The ulp is the port's own final rounding: where XLA's CPU
       reduction of bf16 terms (a bias gradient) puts JAX bf16 further
       from fp32 than the port's fp32 accumulation, the two bf16 results
       round apart by up to it. By default it is taken as 2^-8 scale
       (half to one ulp; test_torch_bf16.py's tests); the classifier and
       inference tests pass ulp = bf16_ulp(scale), one ulp as bf16 spaces
       numbers at the scale, since a batch reduction of bf16 terms (a
       bias gradient) can round one ulp apart where the scale sits just
       above a power of two.
    2. |port - jax_bf16| <= 5e-2 scale, unless JAX's own bf16 result is
       further than that from fp32 (gradients deep in the bf16 backward:
       dec_lin's and dec_lin_2's weights at 7.3e-2 and 1.8e-1 of their
       layer's max|g|): there 1 holds alone, since a port equal to JAX
       bf16 could not meet 2."""
    d_port = np.abs(to_np(got) - to_np(j16)).max()
    d_bf16 = np.abs(to_np(j16) - to_np(j32)).max()
    print(f"{name}: |port - jax_bf16| {d_port:.3e}, |jax_bf16 - jax_fp32| "
          f"{d_bf16:.3e}, scale {scale:.3e}")
    ulp = ULP * scale if ulp is None else ulp
    assert d_port <= d_bf16 + ulp, (name, d_port, d_bf16)
    if d_bf16 <= BAR * scale:
        assert d_port <= BAR * scale, (name, d_port, scale)


def settled_rows(logits) -> np.ndarray:
    """Rows of [B, 2] logits whose two values differ by more than 2 bf16
    ulps of their magnitude: rows whose argmax another bf16 order of the
    same sums keeps. A row inside that margin may flip its prediction."""
    lg = to_np(logits)
    return np.abs(lg[:, 0] - lg[:, 1]) > 2 * bf16_ulp(np.abs(lg).max(-1))


GCN_FEATURES = 6  # 2 x the mesh's 3 coordinates


def gcn_configs(hier, precision, cheb_method="pallas",
                compute_dtype="float32"):
    """(JAX GCNConfig, port GCNConfig) of the grid-sized GCN."""
    common = dict(num_features=GCN_FEATURES, filters=FILTERS,
                  polygon_order=ORDERS, n_layers=4, num_classes=2,
                  coarse_verts=hier.levels[-1], precision=precision,
                  compute_dtype=compute_dtype)
    return (JaxGCNConfig(**common, cheb_method=cheb_method),
            GCNConfig(**common))


def _jit_init(module, hier, key, *inputs, **kwargs):
    """flax params of `module` as numpy, initialised under jit on the dense
    operators (params do not depend on the operator layout)."""
    dense_ops = jax_build_ops(jax_hierarchy(hier), cheb_method="dense",
                              pool_method="gather")
    params = jax.jit(lambda k: module.init(k, *inputs, dense_ops, **kwargs))(
        key)
    return jax.tree_util.tree_map(np.asarray, params)


def paired_gcn(hier, precision, cheb_method="pallas",
               compute_dtype="float32"):
    """(jax ChebGCN, jax_ops, flax params as numpy, port ChebGCN, port_ops)
    with identical weights; compute_dtype "bfloat16" builds both configs
    and both operator sets in bf16 (the params do not depend on it)."""
    jcfg, pcfg = gcn_configs(hier, precision, cheb_method, compute_dtype)
    jops, pops = paired_operators(hier, cheb_method, None,
                                  *DTYPES[compute_dtype])
    params = _jit_init(
        JaxChebGCN(dataclasses.replace(jcfg, cheb_method="dense",
                                       compute_dtype="float32")), hier,
        jax.random.key(1),
        jnp.zeros((1, hier.levels[0], GCN_FEATURES), jnp.float32))
    pmodel = ChebGCN(pcfg)
    pmodel.load_state_dict(params_from_flax(params))
    return JaxChebGCN(jcfg), jops, params, pmodel, pops


JOINT_SPLIT = 2


def paired_joint(hier, precision, cheb_method="pallas", dropout=0.2,
                 tgrad_ell_max=None, compute_dtype="float32"):
    """(jax JointMeshVAE, jax_ops, flax params as numpy, port JointMeshVAE,
    port_ops) with identical weights: paired_models' VAE, the grid GCN and
    a latent split of JOINT_SPLIT; compute_dtype "bfloat16" builds both
    packages' configs and operators in bf16."""
    jvae = JaxVAEConfig(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                        n_layers=4, num_hidden=32, latent=6, num_classes=2,
                        dropout=dropout, coarse_verts=hier.levels[-1],
                        cheb_method=cheb_method, precision=precision,
                        compute_dtype=compute_dtype)
    jgcn, pgcn = gcn_configs(hier, precision, cheb_method, compute_dtype)
    jops, pops = paired_operators(hier, cheb_method, tgrad_ell_max,
                                  *DTYPES[compute_dtype])
    fp32 = dict(cheb_method="dense", compute_dtype="float32")
    params = _jit_init(
        JaxJointMeshVAE(dataclasses.replace(jvae, **fp32),
                        dataclasses.replace(jgcn, **fp32),
                        JOINT_SPLIT), hier, {"params": jax.random.key(2)},
        jnp.zeros((1, hier.levels[0], 3), jnp.float32),
        jnp.zeros((1, 2), jnp.float32), train=False)
    pvae = VAEConfig(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                     n_layers=4, num_hidden=32, latent=6, num_classes=2,
                     dropout=dropout, coarse_verts=hier.levels[-1],
                     precision=precision, compute_dtype=compute_dtype)
    pmodel = JointMeshVAE(pvae, pgcn, JOINT_SPLIT)
    pmodel.load_state_dict(params_from_flax(params))
    return (JaxJointMeshVAE(jvae, jgcn, JOINT_SPLIT), jops, params,
            pmodel.eval(), pops)


def write_requests(template: TriMesh, root: str, n: int = 6) -> str:
    """n synthetic meshes (random similarity poses) under root/data."""
    from meshvae_tpu_torch.data.synthetic import generate_synthetic_dataset

    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(template, data_dir, n_samples=n, seed=1)
    return data_dir


def count_kernel_calls(monkeypatch, **modules):
    """Wrap bsr_grouped_spmm, and pool_transpose (the pool backward's
    kernel), where each named module calls them; returns the calls in
    order as (name, mode) pairs."""
    calls = []
    for name, module in modules.items():
        if hasattr(module, "bsr_grouped_spmm"):
            real = module.bsr_grouped_spmm

            def counted(*args, _real=real, _name=name, **kwargs):
                calls.append((_name, args[2] if len(args) > 2
                              else kwargs.get("mode", "fp32")))
                return _real(*args, **kwargs)

            monkeypatch.setattr(module, "bsr_grouped_spmm", counted)
        if hasattr(module, "pool_transpose"):
            real_t = module.pool_transpose

            def counted_t(pool, g, _real=real_t, _name=name):
                calls.append((_name, "bf16" if pool.t_val.dtype
                              == torch.bfloat16 else "fp32"))
                return _real(pool, g)

            monkeypatch.setattr(module, "pool_transpose", counted_t)
    return calls


class FedNoise:
    """numpy dropout masks (in call order) and reparameterisation noise,
    fed to both packages (feed_noise). decode_rows: the decoder's rows per
    sample (2 for the joint model's one pass over both labels)."""

    def __init__(self, b, hidden, flat, latent, seed=0, rate=0.2,
                 decode_rows=1):
        rng = np.random.default_rng(seed)
        keep = lambda shape: (rng.random(shape) >= rate).astype(np.float32)
        # encode's h, classify's input, dec_lin, dec_lin_2
        d = decode_rows * b
        self.masks = [keep((b, hidden)), keep((b, hidden)),
                      keep((d, hidden)), keep((d, flat))]
        self.eps = rng.standard_normal((b, latent)).astype(np.float32)
        self.i = 0

    def next_mask(self, shape):
        mask = self.masks[self.i % len(self.masks)]
        assert tuple(shape) == mask.shape, (shape, mask.shape, self.i)
        self.i += 1
        return mask


def feed_noise(monkeypatch, noise):
    """Patch flax's Dropout and the JAX reparameterize, and the port's
    _dropout and reparameterize, to apply `noise`'s masks (in the
    activation's dtype) and eps."""
    class FedDropout(flax_nn.Module):
        rate: float

        def __call__(self, x, deterministic=False):
            if deterministic or self.rate == 0.0:
                return x
            mask = jnp.asarray(noise.next_mask(x.shape), x.dtype)
            return x * mask / (1 - self.rate)

    def port_dropout(x, rate, train, generator, rows=None):
        if not train or rate == 0.0:
            return x
        mask = torch.from_numpy(noise.next_mask(x.shape)).to(x.dtype)
        return x * mask / (1 - rate)

    monkeypatch.setattr(flax_nn, "Dropout", FedDropout)
    monkeypatch.setattr(
        JaxMeshVAE, "reparameterize",
        lambda self, mu, logvar: jnp.asarray(noise.eps)
        * jnp.exp(0.5 * logvar) + mu)
    monkeypatch.setattr(port_vae, "_dropout", port_dropout)
    monkeypatch.setattr(
        MeshVAE, "reparameterize",
        lambda self, mu, logvar, generator, rows=None: torch.from_numpy(
            noise.eps)
        * torch.exp(0.5 * logvar) + mu)
