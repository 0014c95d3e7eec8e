"""The plain reference of the label-conditioned mesh VAE: its forward pass,
loss, gradients (autograd) and the Adam update with L2 added to the
gradient, in plain PyTorch on the Laplacians and pool matrices of
reference/mesh.py. It imports nothing of the program.

The architecture (the published reference's cheb_VAE, files/default.cfg):
  encoder    n_layers x (ChebConv -> ReLU -> down-pool), flatten,
             ReLU(enc_lin), dropout                                  -> h
  classifier softmax(classifier_layer(dropout(h)))                   -> y_hat
  posterior  z_mean / z_log_var(concat[y, h]); z = mu + eps exp(logvar / 2)
  decoder    ReLU(dec_lin(concat[y, z])), dropout, ReLU(dec_lin_2), dropout,
             reshape to the coarsest level, n_layers x (up-pool -> ChebConv
             -> ReLU), a bias-free ChebConv on the coarsest L_hat embedded
             in the finest level's index space                       -> recon
  loss       mean_B(KL + sum N(x; recon, sigma) NLL - 2 log q(y)), with
             log sigma = softclip(1, -6)
where ChebConv(x) = sum_k T_k(L_hat) x W_k + b, T_0 = x, T_1 = L_hat x,
T_k = 2 L_hat T_{k-1} - T_{k-2}. Parameter names and shapes follow the
published model's (``cheb_enc_i``, ``enc_lin``, ...; Chebyshev weights
[K, F_in, F_out], linear weights [out, in]).

Arithmetic is float32 with TF32 off. ``Precision`` rounds the operands
and results of every product to fewer mantissa bits: the control of the
correctness check, the reference computed one precision below the
configuration's (TF32: 10 bits, for a float32 configuration; fp8, 3 bits
as e4m3 has, for a bfloat16 one). The rounding keeps float32's exponent
range, as a per-tensor scale keeps fp8 values in range.

Randomness: train mode draws its dropout masks and noise through a
``draw(shape, dtype)`` callable, in the order the published model draws
them (encoder dropout, classifier dropout, noise, the decoder's two
dropouts), so a caller that draws from a copy of a generator's state sees
the same values as whatever drew from it before.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

MANTISSA_BITS = {"fp32": None, "tf32": 10, "bf16": 7, "fp8": 3}


def round_mantissa(t: torch.Tensor, bits: int | None) -> torch.Tensor:
    """t (float32) rounded to nearest even at `bits` mantissa bits."""
    if bits is None:
        return t
    shift = 23 - bits
    i = t.contiguous().view(torch.int32)
    lsb = (i >> shift) & 1
    i = (i + ((1 << (shift - 1)) - 1) + lsb) & ~((1 << shift) - 1)
    return i.view(torch.float32)


class _Round(torch.autograd.Function):
    """Round forward, and round the cotangent backward: the products of the
    backward then read rounded operands too."""

    @staticmethod
    def forward(ctx, t, bits):
        ctx.bits = bits
        return round_mantissa(t, bits)

    @staticmethod
    def backward(ctx, g):
        return round_mantissa(g, ctx.bits), None


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in MANTISSA_BITS:
            raise ValueError(f"precision {name!r}: one of "
                             f"{sorted(MANTISSA_BITS)}")
        self.name = name
        self.bits = MANTISSA_BITS[name]

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.bits is None:
            return t
        return _Round.apply(t, self.bits)


def exact_fp32() -> None:
    """No TF32 in float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Sparse:
    """A scipy matrix and its transpose as float32 torch CSR tensors on the
    device, values rounded by the precision."""

    def __init__(self, mat: sp.spmatrix, device, prec: Precision):
        self.shape = mat.shape
        self.a = self._csr(sp.csr_matrix(mat), device, prec)
        self.at = self._csr(sp.csr_matrix(mat.T), device, prec)

    @staticmethod
    def _csr(m, device, prec):
        vals = prec(torch.from_numpy(m.data.astype(np.float32)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # "beta state"
            return torch.sparse_csr_tensor(
                torch.from_numpy(m.indptr.astype(np.int64)),
                torch.from_numpy(m.indices.astype(np.int64)), vals,
                size=m.shape, check_invariants=True).to(device)


def _sparse_apply(a, x):
    b, n, f = x.shape
    y = torch.sparse.mm(a, x.permute(1, 0, 2).reshape(n, b * f))
    return y.reshape(a.shape[0], b, f).permute(1, 0, 2)


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mat):
        ctx.mat = mat
        return _sparse_apply(mat.a, x)

    @staticmethod
    def backward(ctx, g):
        return _sparse_apply(ctx.mat.at, g.contiguous()), None


def spmm(mat: Sparse, x: torch.Tensor) -> torch.Tensor:
    """mat @ x[b] for each batch row b: [B, N, F] -> [B, M, F]."""
    return _SpMM.apply(x, mat)


class Operators:
    """The hierarchy's operators on the device: L_hat per level, the pool
    matrices and the final conv's embedded operator."""

    def __init__(self, hier, device, prec: Precision):
        self.lap = [Sparse(m, device, prec) for m in hier.laplacians]
        self.down = [Sparse(m, device, prec) for m in hier.down]
        self.up = [Sparse(m, device, prec) for m in hier.up]
        self.final = Sparse(hier.final_operator(), device, prec)
        self.levels = hier.levels


def param_specs(cfg: dict, coarse_verts: int, features: int = 3) -> list:
    """(name, shape, init) of every parameter in the published model's
    order; init is ("normal", std) or ("uniform", bound)."""
    filters = [features] + list(cfg["num_conv_filters"])
    k, n_layers = list(cfg["polygon_order"]), int(cfg["n_layers"])
    hidden, latent = int(cfg["num_hidden"]), int(cfg["num_style"])
    classes = int(cfg["num_classes"])
    specs = []
    for i in range(len(filters) - 2):
        specs += [(f"cheb_enc_{i}.weight", (k[i], filters[i], filters[i + 1]),
                   ("normal", 0.1)),
                  (f"cheb_enc_{i}.bias", (filters[i + 1],), ("normal", 0.1))]
    n_dec = len(filters) - 1
    for i in range(n_dec):
        fin, fout = filters[-i - 1], filters[-i - 2]
        specs.append((f"cheb_dec_{i}.weight", (k[i], fin, fout),
                      ("normal", 0.1)))
        if i != n_dec - 1:
            specs.append((f"cheb_dec_{i}.bias", (fout,), ("normal", 0.1)))
    flat = coarse_verts * filters[-1]

    def linear(name, fin, fout, normal_weight=False):
        bound = 1.0 / math.sqrt(fin)
        return [(f"{name}.weight", (fout, fin),
                 ("normal", 0.1) if normal_weight else ("uniform", bound)),
                (f"{name}.bias", (fout,), ("uniform", bound))]

    specs += linear("enc_lin", flat, hidden, normal_weight=True)
    specs += linear("dec_lin", latent + classes, hidden, normal_weight=True)
    specs += linear("dec_lin_2", hidden, flat)
    specs += linear("classifier_layer", hidden, classes)
    specs += linear("z_mean", hidden + classes, latent)
    specs += linear("z_log_var", hidden + classes, latent)
    if n_layers != len(filters) - 2:
        raise ValueError("n_layers must be one less than the encoder's "
                         "filter count")
    return specs


LOG_SIGMA = -6.0 + math.log1p(math.exp(1.0 - (-6.0)))


class VAE:
    """The reference model on a parameter dict (name -> float32 tensor)."""

    def __init__(self, cfg: dict, ops: Operators, prec: Precision,
                 mask_dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.ops = ops
        self.r = prec
        self.k = list(cfg["polygon_order"])
        self.n_layers = int(cfg["n_layers"])
        self.filters = [3] + list(cfg["num_conv_filters"])
        self.dropout = float(cfg["dropout"])
        self.mask_dtype = mask_dtype

    # products -----------------------------------------------------------
    def conv(self, x, mat, p, name, k):
        r = self.r
        x = r(x)
        ts = [x]
        if k > 1:
            ts.append(r(spmm(mat, x)))
        for _ in range(2, k):
            ts.append(r(2.0 * spmm(mat, ts[-1]) - ts[-2]))
        basis = torch.cat(ts, dim=-1)
        w = p[f"{name}.weight"]
        out = r(basis @ r(w).reshape(k * w.shape[1], w.shape[2]))
        bias = p.get(f"{name}.bias")
        return out if bias is None else r(out + r(bias))

    def pool(self, x, mat):
        return self.r(spmm(mat, self.r(x)))

    def dense(self, x, p, name):
        r = self.r
        out = r(r(x) @ r(p[f"{name}.weight"]).t())
        return r(out + r(p[f"{name}.bias"]))

    def _dropout(self, x, draw):
        if draw is None or self.dropout == 0.0:
            return x
        keep = 1.0 - self.dropout
        return x * draw(x.shape, self.mask_dtype, keep).float() / keep

    # the model ------------------------------------------------------------
    def encode(self, p, x, draw=None):
        ops = self.ops
        for i in range(self.n_layers):
            x = torch.relu(self.conv(x, ops.lap[i], p, f"cheb_enc_{i}",
                                     self.k[i]))
            x = self.pool(x, ops.down[i])
        h = torch.relu(self.dense(x.reshape(x.shape[0], -1), p, "enc_lin"))
        return self._dropout(h, draw)

    def logits(self, p, h, draw=None):
        return self.dense(self._dropout(h, draw), p, "classifier_layer")

    def decode(self, p, yz, draw=None):
        ops, nl = self.ops, self.n_layers
        x = self._dropout(torch.relu(self.dense(yz, p, "dec_lin")), draw)
        x = self._dropout(torch.relu(self.dense(x, p, "dec_lin_2")), draw)
        x = x.reshape(x.shape[0], ops.levels[-1], self.filters[-1])
        for i in range(nl):
            x = self.pool(x, ops.up[nl - 1 - i])
            x = torch.relu(self.conv(x, ops.lap[nl - 1 - i], p,
                                     f"cheb_dec_{i}", self.k[i]))
        last = len(self.filters) - 2
        return self.conv(x, ops.final, p, f"cheb_dec_{last}", self.k[last])

    def forward(self, p, x, label, draw=None):
        """(the training loss of a batch, every row real; the
        reconstruction); draw None runs the deterministic forward (no
        dropout, z = mu), as the evaluation step does."""
        y = F.one_hot(label, int(self.cfg["num_classes"])).float()
        h = self.encode(p, x, draw)
        y_hat = torch.softmax(self.logits(p, h, draw), dim=-1)
        hy = torch.cat([y, h], dim=-1)
        mu = self.dense(hy, p, "z_mean")
        logvar = self.dense(hy, p, "z_log_var")
        z = mu
        if draw is not None:
            z = draw(mu.shape, torch.float32, None) * torch.exp(
                0.5 * logvar) + mu
        recon = self.decode(p, torch.cat([y, z], dim=-1), draw)
        kl = -0.5 * torch.sum(1.0 + logvar - mu.square() - logvar.exp(),
                              dim=-1)
        nll = (0.5 * ((x - recon) / math.exp(LOG_SIGMA)).square()
               + LOG_SIGMA + 0.5 * math.log(2.0 * math.pi))
        rec = nll.sum(-1).sum(-1)
        logqy = torch.log(torch.sum(y_hat * y, dim=-1))
        return (kl + rec - 2.0 * logqy).mean(), recon

    def loss(self, p, x, label, draw=None):
        return self.forward(p, x, label, draw)[0]


def generator_draw(generator: torch.Generator, device):
    """A draw(shape, dtype, keep) over `generator`: Bernoulli(keep) masks
    in `dtype`, standard normal noise when keep is None."""
    def draw(shape, dtype, keep):
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        if keep is None:
            return t.normal_(generator=generator)
        return t.bernoulli_(keep, generator=generator)
    return draw


def leaf_norms(tree: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tree.items()}


def train_steps(model: VAE, params0: dict, batches: list, draw,
                lr: float, weight_decay: float,
                betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Adam steps from params0, one per (x, label) batch, with L2 added to
    the gradient before the moments (not AdamW). Returns each step's
    loss, the norms of the first gradient as Adam takes it (L2 included)
    and of the raw first gradient, and the norms of each leaf's change
    after the last step."""
    names = list(params0)
    p = {k: params0[k].detach().clone().float().requires_grad_(True)
         for k in names}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    b1, b2 = betas
    out = {"loss": []}
    for t, (x, label) in enumerate(batches, start=1):
        loss = model.loss(p, x, label, draw)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                out["raw_grad_norm"] = leaf_norms(dict(zip(names, grads)))
            for k, g in zip(names, grads):
                g = g + weight_decay * p[k]
                if t == 1:
                    out.setdefault("grad", {})[k] = g
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mh = m[k] / (1.0 - b1 ** t)
                vh = v[k] / (1.0 - b2 ** t)
                p[k].sub_(lr * mh / (vh.sqrt() + eps))
        del loss, grads
    out["grad_norm"] = leaf_norms(out.pop("grad"))
    out["update_norm"] = leaf_norms({k: p[k].detach() - params0[k]
                                     for k in names})
    return out


@torch.no_grad()
def evaluate(model: VAE, p: dict, x, label, r, s, m, mean, std) -> dict:
    """The light evaluation step of one batch (every row real): its loss,
    the mean over the meshes of each one's mean vertex error with the
    reconstruction and x taken back to the mesh's original pose
    (aligned @ R * s + m, aligned = x * std + mean), and its rows."""
    loss, recon = model.forward(p, x, label)

    def to_orig(t):
        return torch.bmm((t * std + mean) * s[:, None, None], r) + m

    err = torch.sqrt(torch.sum((to_orig(recon) - to_orig(x)) ** 2, dim=-1))
    return {"loss": float(loss), "error": float(err.mean(-1).mean()),
            "rows": float(x.shape[0])}
