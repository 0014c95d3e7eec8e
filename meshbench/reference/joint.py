"""The plain reference of the joint disentangled VAE + Chebyshev-GCN
classifier (BASELINE config 3, the published repository's files/joint.cfg):
its forward pass, loss, gradients (autograd), the Adam update with L2 and
the light evaluation step, in plain PyTorch on reference/mesh.py's
operators. It imports only reference/model.py, whose VAE, products,
rounding and Adam it reuses, and nothing of the program.

The model on a parameter dict whose names follow the joint tree (``vae.*``,
``gcn.*``, ``sup_head``, ``adv_head``):
  VAE        reference/model.py's cheb_VAE: h, y_hat, mu, logvar, z
  latent     sup_logits = sup_head(mu[:, :split]); adv_logits =
  split      adv_head(R(mu[:, split:])), R the identity with a negated
             gradient (the gradient reversal)
  decodes    one decoder pass over 2B rows, concat[y, z] then
             concat[1 - y, z]: recon (true label) and recon_oppo
  GCN        the published cheb_cls over diff = concat[x - recon_oppo,
             x - recon] (6 channels): n_layers x (ChebConv -> ReLU ->
             down-pool), flatten, ReLU(enc_lin -> 128), cls_layer
  loss       the VAE loss + sup_weight CE(sup) + adv_weight CE(adv)
             + cls_weight CE(cls), each a mean over the batch
Its gradient flows from the GCN back through the 2B decode into the
encoder.

Departures from the published description, each on purpose:
  * the GCN's ChebConv is the VAE's, T_k of L_hat = -D^-1/2 A D^-1/2:
    PyG's symmetric-normalised ChebConv with its default lambda_max 2
    reduces to the same operator (the +1 diagonal of its Laplacian and
    the -1 of its scaling cancel), so one operator serves both models;
  * the true- and opposite-label decodes are one pass at 2B rows (the
    published code decodes them one after the other): the same
    arithmetic per row, with the dropout masks of the 2B rows drawn in one
    draw per dropout, as the program draws them;
  * the GCN's initialisation (glorot-uniform Chebyshev weights over their
    last two axes, zero biases, N(0, 0.1) head weights, U(+-1/sqrt(fan_in))
    head biases) and the latent heads' (U(+-1/sqrt(fan_in))) are drawn
    from the run's seed, not by PyG's or torch's generators.

Randomness is reference/model.py's: a ``draw(shape, dtype, keep)`` callable,
called in the program's order (the encoder's dropout, the classifier's, the
noise, the decoder's two dropouts over the 2B rows). ``Precision`` rounds
every product's operands and results as reference/model.py does: fp8 for
the control of a bfloat16 configuration, bf16 for the first gradient at the
configuration's own precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import model as ref_model


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def param_specs(cfg: dict, coarse_verts: int, features: int = 3,
                gcn_hidden: int = 128) -> list:
    """(name, shape, init) of every parameter of the joint tree: the VAE's
    (reference/model.py's specs under ``vae.``), the GCN's, then the two
    latent heads."""
    specs = [(f"vae.{name}", shape, init) for name, shape, init in
             ref_model.param_specs(cfg, coarse_verts, features)]
    k, n_layers = list(cfg["polygon_order"]), int(cfg["n_layers"])
    # the published cheb_cls's chain: 2 x features difference channels in
    filters = [2 * features] + [int(f) for f in cfg["num_conv_filters"]]
    for i in range(n_layers):
        fin, fout = filters[i], filters[i + 1]
        specs += [(f"gcn.cheb_{i}.weight", (k[i], fin, fout),
                   ("uniform", math.sqrt(6.0 / (fin + fout)))),
                  (f"gcn.cheb_{i}.bias", (fout,), ("normal", 0.0))]
    classes, latent = int(cfg["num_classes"]), int(cfg["num_style"])
    split = int(cfg["latent_split"])
    flat = coarse_verts * filters[n_layers]

    def linear(name, fin, fout, normal_weight=False):
        bound = 1.0 / math.sqrt(fin)
        return [(f"{name}.weight", (fout, fin),
                 ("normal", 0.1) if normal_weight else ("uniform", bound)),
                (f"{name}.bias", (fout,), ("uniform", bound))]

    specs += linear("gcn.enc_lin", flat, gcn_hidden, normal_weight=True)
    specs += linear("gcn.cls_layer", gcn_hidden, classes, normal_weight=True)
    specs += linear("sup_head", split, classes)
    specs += linear("adv_head", latent - split, classes)
    return specs


def _cross_entropy(logits: torch.Tensor, label: torch.Tensor):
    return -F.log_softmax(logits, dim=-1).gather(1, label[:, None]).mean()


class JointVAE:
    """The reference joint model on a parameter dict (name -> float32
    tensor), over reference/model.py's VAE on the same operators."""

    def __init__(self, cfg: dict, ops: ref_model.Operators,
                 prec: ref_model.Precision,
                 mask_dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.vae = ref_model.VAE(cfg, ops, prec, mask_dtype=mask_dtype)
        self.ops = ops
        self.split = int(cfg["latent_split"])
        self.n_layers = int(cfg["n_layers"])
        self.k = list(cfg["polygon_order"])
        self.weights = tuple(float(cfg[key]) for key in
                             ("sup_weight", "adv_weight", "cls_weight"))

    @staticmethod
    def _part(p: dict, prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in p.items()
                if k.startswith(prefix)}

    def gcn(self, p: dict, diff: torch.Tensor) -> torch.Tensor:
        """diff [B, N, 6] -> the GCN's logits [B, C]."""
        vae, g, x = self.vae, self._part(p, "gcn."), diff
        for i in range(self.n_layers):
            x = torch.relu(vae.conv(x, self.ops.lap[i], g, f"cheb_{i}",
                                    self.k[i]))
            x = vae.pool(x, self.ops.down[i])
        h = torch.relu(vae.dense(x.reshape(x.shape[0], -1), g, "enc_lin"))
        return vae.dense(h, g, "cls_layer")

    def outputs(self, p: dict, x: torch.Tensor, label: torch.Tensor,
                draw=None) -> dict:
        """Every output of the joint forward; draw None is the
        deterministic forward (no dropout, z = mu) of the evaluation."""
        vae, v = self.vae, self._part(p, "vae.")
        y = F.one_hot(label, int(self.cfg["num_classes"])).float()
        h = vae.encode(v, x, draw)
        y_hat = torch.softmax(vae.logits(v, h, draw), dim=-1)
        hy = torch.cat([y, h], dim=-1)
        mu = vae.dense(hy, v, "z_mean")
        logvar = vae.dense(hy, v, "z_log_var")
        z = mu
        if draw is not None:
            z = draw(mu.shape, torch.float32, None) * torch.exp(
                0.5 * logvar) + mu
        s = self.split
        sup_logits = vae.dense(mu[:, :s], p, "sup_head")
        adv_logits = vae.dense(_GradReverse.apply(mu[:, s:]), p, "adv_head")
        yz = torch.cat([torch.cat([y, z], dim=-1),
                        torch.cat([1.0 - y, z], dim=-1)], dim=0)
        both = vae.decode(v, yz, draw)
        b = x.shape[0]
        recon, recon_oppo = both[:b], both[b:]
        diff = torch.cat([x - recon_oppo, x - recon], dim=-1)
        return {"y": y, "y_hat": y_hat, "mu": mu, "logvar": logvar, "z": z,
                "sup_logits": sup_logits, "adv_logits": adv_logits,
                "recon": recon, "recon_oppo": recon_oppo,
                "cls_logits": self.gcn(p, diff)}

    def terms(self, x: torch.Tensor, label: torch.Tensor, out: dict) -> dict:
        """The loss's terms, each a mean over the batch (every row real)."""
        mu, logvar, recon = out["mu"], out["logvar"], out["recon"]
        kl = -0.5 * torch.sum(1.0 + logvar - mu.square() - logvar.exp(),
                              dim=-1)
        sigma = ref_model.LOG_SIGMA
        nll = (0.5 * ((x - recon) / math.exp(sigma)).square() + sigma
               + 0.5 * math.log(2.0 * math.pi))
        logqy = torch.log(torch.sum(out["y_hat"] * out["y"], dim=-1))
        return {"vae": (kl + nll.sum(-1).sum(-1) - 2.0 * logqy).mean(),
                "sup": _cross_entropy(out["sup_logits"], label),
                "adv": _cross_entropy(out["adv_logits"], label),
                "cls": _cross_entropy(out["cls_logits"], label)}

    def forward(self, p, x, label, draw=None):
        """(the joint loss of a batch, its outputs)."""
        out = self.outputs(p, x, label, draw)
        t = self.terms(x, label, out)
        w_sup, w_adv, w_cls = self.weights
        loss = t["vae"] + w_sup * t["sup"] + w_adv * t["adv"] + w_cls * t[
            "cls"]
        return loss, out

    def loss(self, p, x, label, draw=None):
        return self.forward(p, x, label, draw)[0]


@torch.no_grad()
def evaluate(model: JointVAE, p: dict, x, label, r, s, m, mean, std) -> dict:
    """The light evaluation step of one batch (every row real): the joint
    loss, the mean over the meshes of each one's mean vertex error in its
    original pose (as reference/model.py's evaluate), the rows, and the
    sex-change counterfactual through the VAE: the opposite-label decode of
    mu re-encoded and re-classified, counted where it reads the opposite
    label (``sc_correct``)."""
    loss, out = model.forward(p, x, label)

    def to_orig(t):
        return torch.bmm((t * std + mean) * s[:, None, None], r) + m

    err = torch.sqrt(torch.sum((to_orig(out["recon"]) - to_orig(x)) ** 2,
                               dim=-1))
    vae, v = model.vae, model._part(p, "vae.")
    oppo = 1.0 - out["y"]
    x_oppo = vae.decode(v, torch.cat([oppo, out["mu"]], dim=-1))
    pred = torch.argmax(vae.logits(v, vae.encode(v, x_oppo)), dim=-1)
    return {"loss": float(loss), "error": float(err.mean(-1).mean()),
            "rows": float(x.shape[0]),
            "sc_correct": float((pred == oppo.argmax(-1)).sum())}
