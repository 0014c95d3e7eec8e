"""meshvae_tpu_torch.models.experimental against
meshvae_tpu.models.experimental on the 6x6 grid of test_experimental.py,
with the same weights on both sides (a flax tree drawn by numpy, carried
across by params_from_flax): forward within 1e-5 of max|y|, the gradient
of the output's sum within 1e-4 of each layer's max|g|, PointCNN's
updated batch_stats within 1e-6 of their max, sort_pool and pc2mesh bit
for bit. Also the four other helpers the port copies: softclip,
bernoulli_nll, edge_list and write_default_config."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import meshvae_tpu.models.experimental as jexp
from meshvae_tpu import config as jax_config
from meshvae_tpu.mesh import connectivity as jax_connectivity
from meshvae_tpu.models import losses as jax_losses
from meshvae_tpu.ops.graph import cheb_operator as jax_cheb_operator

from meshvae_tpu_torch import config as port_config
from meshvae_tpu_torch.mesh import connectivity as port_connectivity
from meshvae_tpu_torch.models import experimental as pexp
from meshvae_tpu_torch.models import losses as port_losses
from meshvae_tpu_torch.models.vae import params_from_flax
from meshvae_tpu_torch.ops.graph import cheb_operator

from conftest import make_grid_mesh

B, F = 2, 8
FWD_BAR, GRAD_BAR, STATS_BAR = 1e-5, 1e-4, 1e-6
# the sum of a normalised output does not depend on the input (its input
# gradient is 0 up to rounding), so only their parameter gradients count
SUM_FREE_OF_INPUT = ("AdaptiveInstanceNorm", "GraphNorm")


@pytest.fixture(scope="module")
def graph():
    mesh = make_grid_mesh(6, jitter=0.05)
    adj = jax_connectivity.vertex_adjacency(mesh.num_vertices, mesh.f)
    jop = jax_cheb_operator(adj)
    pop = cheb_operator(adj, "cpu")
    x = np.random.default_rng(0).standard_normal(
        (B, pop.n, F)).astype(np.float32)
    return adj, jop, pop, x


def _numpy_tree(jax_module, args, seed):
    """A variable tree of jax_module's init shapes (eval_shape: no init
    is run), params ~ 0.5 N(0, 1) and batch_stats means ~ 0.1 N(0, 1),
    variances ~ U(0.5, 1.5), from numpy's generator at `seed`."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.key(0), *args))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.1 if "'mean'" in name else 0.5
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(port_module, tree):
    port_module.load_state_dict(params_from_flax(tree))  # strict
    return port_module


def _close(name, got, want, bar):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= bar * max(float(np.abs(want).max()), 1e-30), \
        (name, err, float(np.abs(want).max()))


def _layer(name: str) -> str:
    return name.rsplit(".", 1)[0] if "." in name else ""


def _hold_grads(port_module, jax_grads):
    """torch's .grad of every parameter against jax.grad mapped onto the
    port's names, per layer: max|diff| <= GRAD_BAR * the layer's max|g|."""
    want = params_from_flax(jax_grads)
    got = dict(port_module.named_parameters())
    assert set(got) == set(want)
    scale = {}
    for name, g in want.items():
        scale[_layer(name)] = max(scale.get(_layer(name), 0.0),
                                  float(g.abs().max()))
    for name, g in want.items():
        err = float((got[name].grad - g).abs().max())
        assert err <= GRAD_BAR * scale[_layer(name)], (name, err)


def _scalar(out, weights=None):
    """out.sum(), or sum_i (out_i * w_i).sum() over a tuple's outputs (a
    None weight: the plain sum)."""
    if weights is None:
        return out.sum()
    return sum(o.sum() if w is None else (o * w).sum()
               for o, w in zip(out, weights))


def _cases(graph):
    adj, jop, pop, x = graph
    rng = np.random.default_rng(1)
    style = rng.standard_normal((B, 4)).astype(np.float32)
    rows = (3.0 * rng.standard_normal((16, F)) + 2.0).astype(np.float32)
    a = np.abs(np.sign(np.asarray(jop.dense)))
    # DiffPool's pooled.sum() and coarse_adj.sum() do not depend on s (its
    # softmax rows sum to 1), so their gradient is rounding noise: weigh
    # them at random, beside link_loss
    dp_weights = (rng.standard_normal((B, 8, F)).astype(np.float32),
                  rng.standard_normal((8, 8)).astype(np.float32), None)
    return {
        "EqualLinear": (jexp.EqualLinear(4), pexp.EqualLinear(F, 4), (x,),
                        (), None),
        "AdaptiveInstanceNorm": (jexp.AdaptiveInstanceNorm(F),
                                 pexp.AdaptiveInstanceNorm(F, 4),
                                 (x, style), (), None),
        "GraphNorm": (jexp.GraphNorm(F), pexp.GraphNorm(F), (rows,), (),
                      None),
        "SpatialConv": (jexp.SpatialConv(F), pexp.SpatialConv(F, F), (x,),
                        ((jop, pop),), None),
        "GraphAttention": (jexp.GraphAttention(F), pexp.GraphAttention(F, F),
                           (x,), ((jop, pop),), None),
        "DiffPool": (jexp.DiffPool(pop.n, 8), pexp.DiffPool(pop.n, 8), (x,),
                     ((jnp.asarray(a), torch.from_numpy(a.astype(np.float32))),
                      ), dp_weights),
    }


@pytest.mark.parametrize("name", ["EqualLinear", "AdaptiveInstanceNorm",
                                  "GraphNorm", "SpatialConv",
                                  "GraphAttention", "DiffPool"])
def test_module_matches_jax(graph, name):
    jm, pm, arrays, statics, weights = _cases(graph)[name]
    convert = lambda fn: None if weights is None else [
        None if w is None else fn(w) for w in weights]
    jw, tw = convert(jnp.asarray), convert(torch.from_numpy)
    jargs = [jnp.asarray(a) for a in arrays] + [s[0] for s in statics]
    targs = [torch.from_numpy(a) for a in arrays] + [s[1] for s in statics]
    tree = _numpy_tree(jm, jargs, seed=len(name))
    pm = _port(pm, tree)

    def loss(params, first):
        out = jm.apply({"params": params}, first, *jargs[1:])
        return _scalar(out, jw), out

    (_, want), (g_params, g_x) = (
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            tree["params"], jargs[0]))
    first = targs[0].clone().requires_grad_(True)
    got = pm(first, *targs[1:])
    _scalar(got, tw).backward()
    for i, (g, w) in enumerate(zip(got if isinstance(got, tuple) else (got,),
                                   want if isinstance(want, tuple)
                                   else (want,))):
        _close(f"{name} output {i}", g, w, FWD_BAR)
    _hold_grads(pm, g_params)
    if name not in SUM_FREE_OF_INPUT:
        _close(f"{name} d input", first.grad, g_x, GRAD_BAR)


def test_point_cnn_train_then_eval():
    """Train mode: the output, its gradients and the updated batch_stats
    (the port updates its buffers in place and returns them); then eval
    mode on those statistics."""
    x = np.random.default_rng(2).standard_normal((4, 36, 3)).astype(
        np.float32)
    jm = jexp.PointCNN()
    tree = _numpy_tree(jm, (jnp.asarray(x),), seed=3)
    pm = _port(pexp.PointCNN(36), tree)
    stats = {"batch_stats": tree["batch_stats"]}

    def train_loss(params):
        y, upd = jm.apply({"params": params, **stats}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
        return y.sum(), (y, upd)

    (_, (want, updated)), grads = jax.value_and_grad(
        train_loss, has_aux=True)(tree["params"])
    got, got_stats = pm(torch.from_numpy(x), train=True)
    got.sum().backward()
    _close("train output", got, want, FWD_BAR)
    _hold_grads(pm, grads)
    for key in ("mean", "var"):
        _close(f"batch_stats {key}", got_stats["BatchNorm_0"][key],
               updated["batch_stats"]["BatchNorm_0"][key], STATS_BAR)

    pm.zero_grad()
    new = {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                 updated["batch_stats"])}

    def eval_loss(params):
        y = jm.apply({"params": params, **new}, jnp.asarray(x))
        return y.sum(), y

    (_, want), grads = jax.value_and_grad(eval_loss, has_aux=True)(
        tree["params"])
    got = pm(torch.from_numpy(x))
    got.sum().backward()
    _close("eval output", got, want, FWD_BAR)
    _hold_grads(pm, grads)


@torch.no_grad()
def test_initialisers_follow_flax(graph):
    """The port's own init: flax's tree (names, shapes, the constant
    leaves) and each random leaf inside its initialiser's support."""
    _, jop, pop, x = graph
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((2, pop.n, 3)).astype(np.float32)
    a = np.abs(np.sign(np.asarray(jop.dense))).astype(np.float32)
    pairs = [
        (jexp.EqualLinear(4), pexp.EqualLinear(F, 4), (x,)),
        (jexp.AdaptiveInstanceNorm(F), pexp.AdaptiveInstanceNorm(F, 4),
         (x, x[:, 0, :4])),
        (jexp.GraphNorm(F), pexp.GraphNorm(F), (x[:, 0],)),
        (jexp.SpatialConv(F), pexp.SpatialConv(F, F), (x, jop)),
        (jexp.GraphAttention(F), pexp.GraphAttention(F, F), (x, jop)),
        (jexp.DiffPool(pop.n, 8), pexp.DiffPool(pop.n, 8), (x, a)),
        (jexp.PointCNN(), pexp.PointCNN(pop.n), (pts,)),
    ]
    for jm, pm, args in pairs:
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))
        want = params_from_flax(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        got = pm.state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}, type(pm).__name__
        assert all(v.dtype == torch.float32 for v in got.values())
    eq, ada, gn, sc, gat, dp, cnn = (p[1] for p in pairs)
    assert float(eq.kernel.detach().std()) == pytest.approx(1.0, abs=0.35)
    assert torch.equal(ada.style_bias, torch.cat([torch.ones(F),
                                                  torch.zeros(F)]))
    assert torch.equal(gn.gamma, torch.zeros(F))
    assert torch.equal(gn.beta, torch.ones(F))
    for lim, w in ((np.sqrt(6 / (F + 1)), gat.a_src),
                   (np.sqrt(6 / (F + 1)), gat.a_dst),
                   (np.sqrt(6 / (pop.n + 8)), dp.s)):
        assert float(w.abs().max()) <= lim
    for layer in (sc.Dense_0, gat.Dense_0, cnn.Conv_0, cnn.Dense_1):
        fan_in = layer.weight[0].numel()
        assert float(layer.weight.abs().max()) <= \
            2 * np.sqrt(1 / fan_in) / 0.87962566103423978
    assert torch.equal(sc.Dense_0.bias, torch.zeros(F))
    bn = cnn.BatchNorm_0
    assert [t.tolist() for t in (bn.scale, bn.bias, bn.mean, bn.var)] == \
        [[1.0] * 3, [0.0] * 3, [0.0] * 3, [1.0] * 3]


@pytest.mark.parametrize("n,k", [(10, 6), (4, 7)])
def test_sort_pool_bit_equal(n, k):
    """Ties in the sort channel keep their order (stable sort); k > n
    zero-pads."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n, 4)).astype(np.float32)
    x[:, :, -1] = rng.integers(0, 3, (3, n))
    want = np.asarray(jexp.sort_pool(jnp.asarray(x), k))
    got = pexp.sort_pool(torch.from_numpy(x), k).numpy()
    assert got.shape == (3, k * 4)
    np.testing.assert_array_equal(got, want)


def test_pc2mesh_bit_equal():
    """The seeded 600-point ball of test_experimental.py: the same vertices
    and the same faces in the same order; degenerate clouds raise in both."""
    rng = np.random.default_rng(0)
    n = 600
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * rng.uniform(0, 1, (n, 1)) ** (1 / 3)
    want_v, want_f = jexp.pc2mesh(pts)
    got_v, got_f = pexp.pc2mesh(pts)
    np.testing.assert_array_equal(got_v, want_v)
    assert got_f.dtype == want_f.dtype and got_f.shape[0] > 100
    np.testing.assert_array_equal(got_f, want_f)
    for bad in (np.zeros((3, 3)), np.zeros((5, 3))):
        for fn in (jexp.pc2mesh, pexp.pc2mesh):
            with pytest.raises(ValueError):
                fn(bad)


@pytest.mark.parametrize("layout", ["bsr", "ell"])
@pytest.mark.parametrize("cls", ["SpatialConv", "GraphAttention"])
def test_dense_layout_required(graph, layout, cls):
    """An operator without the dense layout is refused with a ValueError
    that names its layout."""
    adj, _, _, x = graph
    op = (cheb_operator(adj, "cpu", bsr_min_n=1) if layout == "bsr"
          else cheb_operator(adj, "cpu", ell=True))
    module = getattr(pexp, cls)(F, F)
    with pytest.raises(ValueError, match="block-sparse" if layout == "bsr"
                       else "ELL"):
        module(torch.from_numpy(x), op)


def test_softclip_and_bernoulli_nll():
    rng = np.random.default_rng(5)
    v = (4.0 * rng.standard_normal(64)).astype(np.float32)
    _close("softclip", port_losses.softclip(torch.from_numpy(v), -2.0),
           jax_losses.softclip(jnp.asarray(v), -2.0), 1e-6)
    assert float(port_losses.softclip(1.0, -6)) == pytest.approx(
        port_losses.fixed_log_sigma(), rel=1e-6)
    x_hat = rng.uniform(0, 1, (3, 10, 4)).astype(np.float32)
    x = rng.integers(0, 2, (3, 10, 4)).astype(np.float32)
    x_hat[0, 0, 0], x[0, 0, 0] = 0.0, 1.0  # eps inside the log
    got = port_losses.bernoulli_nll(torch.from_numpy(x_hat),
                                    torch.from_numpy(x))
    assert got.shape == (3,)
    _close("bernoulli_nll", got,
           jax_losses.bernoulli_nll(jnp.asarray(x_hat), jnp.asarray(x)),
           1e-6)


def test_edge_list_bit_equal():
    mesh = make_grid_mesh(5)
    adj = jax_connectivity.vertex_adjacency(mesh.num_vertices, mesh.f)
    rand = sp.random(30, 30, density=0.2, random_state=7, format="csr")
    for a in (adj + sp.eye(adj.shape[0]), rand, rand.tocoo()):
        want = jax_connectivity.edge_list(a)
        got = port_connectivity.edge_list(a)
        assert got.dtype == np.int64 and got.shape[0] == 2
        assert not np.any(got[0] == got[1])
        np.testing.assert_array_equal(got, want)


def test_write_default_config_matches_jax(tmp_path):
    """The file the port writes is byte-equal to the JAX package's, and
    each package reads both back to the same dict (its defaults)."""
    port_file, jax_file = tmp_path / "port.cfg", tmp_path / "jax.cfg"
    port_config.write_default_config(str(port_file))
    jax_config.write_default_config(str(jax_file))
    assert port_file.read_bytes() == jax_file.read_bytes()
    assert "[ChebModel  Parameters]" in port_file.read_text()
    for read in (port_config.read_config, jax_config.read_config):
        assert read(str(port_file)) == read(str(jax_file))
    assert port_config.read_config(str(port_file)) == \
        port_config.default_config()
