"""Shared set-up for the tests that hold meshvae_tpu_torch against the JAX
package end to end: one grid-mesh hierarchy fed to both packages, a flax
MeshVAE with its params, and the port's MeshVAE loaded from the same params
through params_from_flax."""
import dataclasses
import os

import numpy as np

import jax
import jax.numpy as jnp

import meshvae_tpu.ops.graph as jax_graph
from meshvae_tpu.mesh.hierarchy import MeshHierarchy as JaxHierarchy
from meshvae_tpu.models.operators import build_operators as jax_build_ops
from meshvae_tpu.models.vae import MeshVAE as JaxMeshVAE
from meshvae_tpu.models.vae import VAEConfig as JaxVAEConfig

from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy
from meshvae_tpu_torch.models import (MeshVAE, VAEConfig, build_operators,
                                      params_from_flax)
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


def paired_models(hier, precision, dropout=0.2, tgrad_ell_max=None):
    """(jax_model, jax_ops, flax params as numpy, port_model, port_ops) with
    identical weights. The JAX side takes the Pallas path (run it under
    pallas_cheb.INTERPRET = True). tgrad_ell_max, when given, is the
    pool-backward fan-in cutoff on both sides while the operators are
    built (6 on the grid gives up-pools 0-2 a block-sparse P^T and up-pool
    3 gathers, as config 1 has)."""
    jcfg = JaxVAEConfig(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                        n_layers=4, num_hidden=32, latent=6, num_classes=2,
                        dropout=dropout, coarse_verts=hier.levels[-1],
                        cheb_method="pallas", precision=precision)
    old = (jax_graph.PALLAS_MIN_N, jax_graph.TGRAD_ELL_MAX,
           port_graph.TGRAD_ELL_MAX)
    jax_graph.PALLAS_MIN_N = BSR_MIN_N
    if tgrad_ell_max is not None:
        jax_graph.TGRAD_ELL_MAX = port_graph.TGRAD_ELL_MAX = tgrad_ell_max
    try:
        jops = jax_build_ops(jax_hierarchy(hier), cheb_method="pallas",
                             pool_method="gather")
        pops = build_operators(hier, "cpu", cheb_method="pallas",
                               bsr_min_n=BSR_MIN_N)
    finally:
        (jax_graph.PALLAS_MIN_N, jax_graph.TGRAD_ELL_MAX,
         port_graph.TGRAD_ELL_MAX) = old
    # params do not depend on the operator layout: init on the dense path
    dense_ops = jax_build_ops(jax_hierarchy(hier), cheb_method="dense",
                              pool_method="gather")
    params = JaxMeshVAE(dataclasses.replace(jcfg, cheb_method="dense")).init(
        {"params": jax.random.key(0)},
        jnp.zeros((1, hier.levels[0], 3), jnp.float32),
        jnp.zeros((1, 2), jnp.float32), dense_ops, train=False)
    params = jax.tree_util.tree_map(np.asarray, params)

    pcfg = VAEConfig(num_features=3, filters=FILTERS, polygon_order=ORDERS,
                     n_layers=4, num_hidden=32, latent=6, num_classes=2,
                     dropout=dropout, coarse_verts=hier.levels[-1],
                     precision=precision)
    pmodel = MeshVAE(pcfg)
    pmodel.load_state_dict(params_from_flax(params))
    pmodel.eval()
    return JaxMeshVAE(jcfg), jops, params, pmodel, pops


def write_requests(template: TriMesh, root: str, n: int = 6) -> str:
    """n synthetic meshes (random similarity poses) under root/data."""
    from meshvae_tpu_torch.data.synthetic import generate_synthetic_dataset

    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(template, data_dir, n_samples=n, seed=1)
    return data_dir


def count_kernel_calls(monkeypatch, **modules):
    """Wrap bsr_grouped_spmm where each named module calls it; returns the
    calls in order as (name, mode) pairs."""
    calls = []
    for name, module in modules.items():
        real = module.bsr_grouped_spmm

        def counted(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, args[2] if len(args) > 2
                          else kwargs.get("mode", "fp32")))
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, "bsr_grouped_spmm", counted)
    return calls
