"""Experimental / auxiliary modules (counterpart of
meshvae_tpu/models/experimental.py): the reference's layers that its
shipped configs never enable. The StyleGAN-style equalized-LR linear and
adaptive instance norm, a graph batch-norm, spatial graph convolution and
graph attention over the static topology, SortPool / DiffPool, a tiny
point classifier and the point-cloud mesher.

Everything here is dense torch (products, argsort, softmax, a 1-wide
convolution, a batch norm): no block-sparse kernel runs, so the modules
take no launch of the port's kernels. SpatialConv and GraphAttention read
the operator's ``dense`` layout (``cheb_method = dense``, or a level below
the hybrid cutoff) and raise on a block-sparse or ELL operator, as the JAX
modules do.

Parameters are float32 and carry flax's names (``kernel``, ``style_kernel``,
``gamma``, ``a_src``, ``s``, ``Dense_0``, ``Conv_0``, ``BatchNorm_0``), so
``models.vae.params_from_flax`` maps a JAX tree onto ``load_state_dict``.
They are drawn on the CPU from an explicit ``torch.Generator`` (a fresh one
seeded 0 when None) with the JAX package's initialisers, then moved to
``device``. Unlike flax's shape inference from the first input, each module
takes its input widths as arguments.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cheb import resolve_precision
from ..ops.graph import GraphOperator
from .vae import dense

DTYPE = torch.float32  # the modules' parameter and computation dtype

# flax's lecun_normal draws N(0, 1) truncated to [-2, 2] and scales it by
# sqrt(1 / fan_in) / this constant (the truncated normal's own std)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     gen: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-limit, limit, generator=gen)


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=DTYPE))


@torch.no_grad()
def _dense_layer(in_features: int, out_features: int, gen: torch.Generator,
                 bias: bool = True) -> nn.Linear:
    """nn.Linear with flax Dense's init: lecun_normal weight, zero bias."""
    layer = nn.Linear(in_features, out_features, bias=bias, dtype=DTYPE)
    _lecun_normal_(layer.weight, in_features, gen)
    if bias:
        layer.bias.zero_()
    return layer


def _neighbours(op: GraphOperator, name: str) -> torch.Tensor:
    """[n, n] bool: (i, j) share a mesh edge (|L_hat| > 0). Only the dense
    layout holds them as a matrix; an embedded operator's rows and
    columns at or beyond active_n have none."""
    if op.dense is None:
        layout = "block-sparse" if op.bsr is not None or op.bsr_sp is not None \
            else "ELL"
        raise ValueError(f"{name} reads the operator's dense layout; this "
                         f"operator is {layout} (build it with cheb_method "
                         "dense, or bsr_min_n=None)")
    pad = op.n - op.dense.shape[0]
    return F.pad(op.dense.abs() > 0, (0, pad, 0, pad))


class EqualLinear(nn.Module):
    """Linear with runtime weight scaling by sqrt(2 / fan_in) (equalized
    learning rate); kernel [in, out] ~ N(0, 1) in flax's layout, bias 0."""

    def __init__(self, in_features: int, features: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.kernel = _param(in_features, features)
        self.bias = _param(features)
        with torch.no_grad():
            self.kernel.normal_(0.0, 1.0, generator=gen)
            self.bias.zero_()
        self.scale = math.sqrt(2.0 / in_features)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel * self.scale) + self.bias


class AdaptiveInstanceNorm(nn.Module):
    """AdaIN conditioned on a style vector: normalise x [B, N, C] over the
    vertex dim (unbiased variance, eps inside the root), then scale and
    shift with gamma / beta predicted from style [B, S] by an equalized
    linear whose bias starts at 1 for gamma and 0 for beta."""

    def __init__(self, channels: int, style_dim: int, eps: float = 1e-9,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.channels, self.eps = channels, eps
        self.style_kernel = _param(style_dim, 2 * channels)
        self.style_bias = _param(2 * channels)
        with torch.no_grad():
            self.style_kernel.normal_(0.0, 1.0, generator=gen)
            self.style_bias.zero_()
            self.style_bias[:channels] = 1.0
        self.scale = math.sqrt(2.0 / style_dim)
        self.to(device)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gb = (torch.matmul(style, self.style_kernel * self.scale)
              + self.style_bias)[:, None, :]
        gamma, beta = gb.split(self.channels, dim=-1)
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, correction=1, keepdim=True)
        return gamma * (x - mean) / torch.sqrt(var + self.eps) + beta


class GraphNorm(nn.Module):
    """Normalisation over the batch dim (biased variance) with a learned
    affine where beta multiplies and gamma shifts (beta starts at 1, gamma
    at 0), as the reference's graph_norm."""

    def __init__(self, num_features: int, eps: float = 1e-9, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.zeros(num_features, dtype=DTYPE))
        self.beta = nn.Parameter(torch.ones(num_features, dtype=DTYPE))
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=0, keepdim=True)
        var = ((x - mean) ** 2).sum(dim=0, keepdim=True) / x.shape[0]
        return self.beta * (x - mean) / torch.sqrt(var + self.eps) + self.gamma


class SpatialConv(nn.Module):
    """Spatial (GCN-style) graph convolution: a Dense layer, then the sum
    over each vertex's neighbours and itself (A + I, from the operator's
    nonzeros). `precision` is validated as matmul_precision is; the
    aggregation runs in plain fp32, as the port's dense levels do."""

    def __init__(self, in_features: int, features: int,
                 precision: str | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        resolve_precision(precision, DTYPE)
        self.precision = precision
        self.Dense_0 = _dense_layer(in_features, features, gen)
        self.to(device)

    def forward(self, x: torch.Tensor, op: GraphOperator) -> torch.Tensor:
        h = dense(self.Dense_0, x, DTYPE)
        agg = _neighbours(op, "SpatialConv").to(h.dtype)
        agg = agg + torch.eye(op.n, dtype=h.dtype, device=h.device)
        return torch.einsum("nm,bmf->bnf", agg, h)


class GraphAttention(nn.Module):
    """Single-head GAT layer over the static topology: logits a_src.h_i +
    a_dst.h_j through a leaky ReLU, softmax over each vertex's neighbours
    and itself (-inf elsewhere), then the attention-weighted sum of h."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.negative_slope = negative_slope
        self.Dense_0 = _dense_layer(in_features, features, gen, bias=False)
        self.a_src = _param(features, 1)
        self.a_dst = _param(features, 1)
        with torch.no_grad():
            _glorot_uniform_(self.a_src, features, 1, gen)
            _glorot_uniform_(self.a_dst, features, 1, gen)
        self.to(device)

    def forward(self, x: torch.Tensor, op: GraphOperator) -> torch.Tensor:
        h = dense(self.Dense_0, x, DTYPE)                      # [B, N, F]
        logits = (torch.matmul(h, self.a_src)
                  + torch.matmul(h, self.a_dst).transpose(1, 2))  # [B, N, N]
        logits = F.leaky_relu(logits, self.negative_slope)
        mask = _neighbours(op, "GraphAttention")
        mask = mask | torch.eye(op.n, dtype=torch.bool, device=mask.device)
        logits = logits.masked_fill(~mask[None], float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        return torch.einsum("bnm,bmf->bnf", attn, h)


def sort_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """SortPool: order each graph's vertices by the last feature channel,
    descending (ties keep their order, as jnp.argsort's stable sort), keep
    the top k and flatten to [B, k * F]; short graphs are zero-padded."""
    b, n, f = x.shape
    order = torch.argsort(-x[:, :, -1], dim=1, stable=True)
    sorted_x = torch.gather(x, 1, order[:, :, None].expand(b, n, f))
    if n >= k:
        kept = sorted_x[:, :k]
    else:
        kept = F.pad(sorted_x, (0, 0, 0, k - n))
    return kept.reshape(b, k * f)


class DiffPool(nn.Module):
    """Differentiable pooling with a learned soft assignment s [N_in,
    N_out] (softmax over N_out): returns the pooled features, the
    coarsened adjacency s^T A s and the link-prediction loss
    ||A - s s^T||_F."""

    def __init__(self, in_nodes: int, out_nodes: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.s = _param(in_nodes, out_nodes)
        with torch.no_grad():
            _glorot_uniform_(self.s, in_nodes, out_nodes, gen)
        self.to(device)

    def forward(self, x: torch.Tensor, adj: torch.Tensor):
        s = torch.softmax(self.s, dim=-1)
        pooled = torch.einsum("nm,bnf->bmf", s, x)
        coarse_adj = s.T @ adj @ s
        # the root of the summed squares, as jnp.linalg.norm computes it:
        # torch's CPU linalg.norm lost 3e-4 relative over a 4998^2 fp32
        # matrix (torch 2.11), where sum() stays within 1e-7
        # (chip_smoke.py phase 20 prints both)
        d = adj - s @ s.T
        link_loss = torch.sqrt(torch.sum(d * d))
        return pooled, coarse_adj, link_loss


class _BatchNorm(nn.Module):
    """flax's nn.BatchNorm(axis=-1) at its defaults: statistics over every
    axis but the last, the batch variance as E[x^2] - E[x]^2 (clipped at
    0) in training and in the running update, running = 0.99 * running +
    0.01 * batch, eps 1e-5. (torch's BatchNorm1d keeps the unbiased
    variance in its running statistics and calls 0.01 its momentum.)"""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features, dtype=DTYPE))
        self.bias = nn.Parameter(torch.zeros(features, dtype=DTYPE))
        self.register_buffer("mean", torch.zeros(features, dtype=DTYPE))
        self.register_buffer("var", torch.ones(features, dtype=DTYPE))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class PointCNN(nn.Module):
    """Tiny point classifier: a 1-wide convolution, batch norm, flatten,
    then Dense(vertices_out * 3) -> ReLU(Dense(hidden[0])) ->
    ReLU(Dense(hidden[1])) -> Dense(1).

    The JAX module convolves swapaxes(x) = [B, 3, N] with flax's nn.Conv,
    which takes the last axis as the features: the N vertices are the
    input channels and the 3 coordinates the length, so it mixes vertices
    into 3 channels per coordinate ([B, 3, 3], kernel [1, N, 3]). Here
    that is a Conv1d(N, 3, 1) on x [B, N, 3] (weight [3, N, 1]), computed
    as one product straight into flax's [B, length, features] layout
    before the norm and the flatten.

    forward(x, train=True) normalises with the batch's statistics, updates
    the running ones in place and returns (y, batch_stats), as flax's
    apply(..., mutable=["batch_stats"]); train=False uses the running
    statistics and returns y."""

    def __init__(self, num_vertices: int, vertices_out: int = 30,
                 hidden: tuple = (10, 5), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.Conv_0 = nn.Conv1d(num_vertices, 3, kernel_size=1, dtype=DTYPE)
        with torch.no_grad():
            _lecun_normal_(self.Conv_0.weight, num_vertices, gen)
            self.Conv_0.bias.zero_()
        self.BatchNorm_0 = _BatchNorm(3)
        widths = (9, vertices_out * 3, hidden[0], hidden[1], 1)
        for i in range(4):
            setattr(self, f"Dense_{i}",
                    _dense_layer(widths[i], widths[i + 1], gen))
        self.to(device)

    def batch_stats(self) -> dict:
        """The running statistics in flax's batch_stats layout."""
        bn = self.BatchNorm_0
        return {"BatchNorm_0": {"mean": bn.mean, "var": bn.var}}

    def forward(self, x: torch.Tensor, train: bool = False):
        # Conv_0 as one product over the whole batch's B * 3 rows, in
        # flax's [B, length, features] layout: on an H100 it kept the
        # 4998-term sums on template coordinates within 1.6e-6 of fp64,
        # where F.conv1d reached 8.3e-6 (chip_smoke.py phase 20 prints
        # both)
        w = self.Conv_0.weight[:, :, 0]
        h = torch.einsum("bnl,on->blo", x, w) + self.Conv_0.bias
        h = self.BatchNorm_0(h, train)
        h = h.reshape(h.shape[0], -1)
        h = dense(self.Dense_0, h, DTYPE)
        h = torch.relu(dense(self.Dense_1, h, DTYPE))
        h = torch.relu(dense(self.Dense_2, h, DTYPE))
        y = dense(self.Dense_3, h, DTYPE)
        return (y, self.batch_stats()) if train else y


def pc2mesh(points, alpha: float | None = None):
    """Point cloud -> triangle surface mesh: the alpha-shape boundary of the
    3D Delaunay tetrahedralization (scipy). Tetrahedra whose circumradius
    reaches `alpha` are dropped and the surface is the set of faces left
    with exactly one incident tetrahedron; `alpha` defaults to 3x the mean
    nearest-neighbour spacing of the distinct points (the reference's
    ball-pivoting radius ladder). Host-side numpy, run once, offline.

    Returns (vertices [N, 3] float64, faces [F, 3] int64); face winding is
    not globally oriented. Exactly cospherical inputs are degenerate (every
    circumsphere is the common sphere): jitter them or pass a larger
    alpha. Raises ValueError on fewer than 4 points, coincident points or
    a coplanar cloud."""
    import scipy.spatial as sps

    pts = np.asarray(points, dtype=np.float64)
    if pts.shape[0] < 4:
        raise ValueError("pc2mesh needs at least 4 points")
    tree = sps.cKDTree(pts)
    dist, _ = tree.query(pts, k=2)
    # duplicated points contribute zero NN spacing: estimate the scale from
    # the distinct-point spacings so auto-alpha does not collapse to 0
    positive = dist[:, 1][dist[:, 1] > 0]
    if positive.size == 0:
        raise ValueError("pc2mesh: all points coincide")
    avg = float(positive.mean())
    if alpha is None:
        alpha = 3.0 * avg

    try:
        tet = sps.Delaunay(pts)
    except sps.QhullError as exc:  # coplanar/degenerate cloud
        raise ValueError(f"pc2mesh: degenerate point cloud ({exc})") from exc
    simp = tet.simplices  # [T, 4]
    a, b, c, d = (pts[simp[:, i]] for i in range(4))
    # circumcenter p (relative to a) solves (p - a) . (p - a) = r^2 against
    # the other three vertices: a 3x3 linear system per tetrahedron
    ba, ca, da = b - a, c - a, d - a
    sq = lambda v: (v * v).sum(-1)
    m = np.stack([ba, ca, da], axis=1)                     # [T, 3, 3]
    rhs = 0.5 * np.stack([sq(ba), sq(ca), sq(da)], axis=1)  # [T, 3]
    det = np.linalg.det(m)
    # scale-relative degeneracy cutoff: det scales as length^3
    good = np.abs(det) > 1e-9 * avg**3
    center = np.zeros((simp.shape[0], 3))
    center[good] = np.linalg.solve(m[good], rhs[good][..., None])[..., 0]
    radius = np.full(simp.shape[0], np.inf)
    radius[good] = np.sqrt(sq(center[good]))
    keep = simp[radius < alpha]

    faces: dict = {}
    combos = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
    for i, j, k in combos:
        tris = np.sort(keep[:, (i, j, k)], axis=1)
        for t in map(tuple, tris):
            faces[t] = faces.get(t, 0) + 1
    boundary = np.asarray([f for f, n in faces.items() if n == 1],
                          dtype=np.int64)
    return pts, boundary.reshape(-1, 3)
