"""The joint model's operations per step, for ``mfu.*`` and
``spmm_roofline.*`` of a joint cell: workcount.py's counts of the VAE with
what the joint step adds, counted by the same rules (from shapes and the
operators' nonzeros, never from a kernel's layout; the backward twice the
forward; elementwise work, the loss and Adam not counted):

  * the decode of both labels: two decodes per sample, the true label's
    and the opposite one's (one pass at 2B rows in the program);
  * the GCN on the 6 difference channels: n_layers x (a Chebyshev conv and
    a down-pool) on the VAE's levels, enc_lin to its 128 hidden units and
    cls_layer;
  * the latent-split heads: 2 split C and 2 (latent - split) C.

A joint cell's kernel calls run at B and at 2B rows (the decodes), so its
context's ``batches`` are [B, 2B]; ``widths`` adds the GCN's 6 input
channels, so that workcount.needed_columns counts the model columns of the
GCN's padded calls (F_pad 8 at B 32: 192 of 256 columns).
"""
from __future__ import annotations

from .workcount import ModelShape, conv_flops

GCN_HIDDEN = 128


class JointShape(ModelShape):
    def __init__(self, hier, cfg: dict, features: int = 3):
        super().__init__(hier, cfg, features)
        self.gcn_filters = [2 * features] + self.filters[1:]
        self.split = int(cfg["latent_split"])

    def gcn(self) -> int:
        """Operations of one sample's GCN, its two heads included."""
        f, total = self.gcn_filters, 0
        for i in range(self.layers):
            total += conv_flops(self.n[i], self.nnz[i], f[i], f[i + 1],
                                self.k[i])
            total += 2 * self.down_nnz[i] * f[i + 1]
        flat = self.n[self.layers] * f[self.layers]
        return total + 2 * flat * GCN_HIDDEN + 2 * GCN_HIDDEN * self.classes

    def heads(self, with_logvar: bool = True) -> int:
        """The VAE's heads and the two latent-split heads of one sample."""
        return super().heads(with_logvar) + 2 * self.latent * self.classes

    def forward(self) -> int:
        """One sample's joint forward: encode, the heads, both decodes and
        the GCN."""
        return (self.encode() + self.heads() + 2 * self.decode()
                + self.gcn())

    def train_step(self, batch: int) -> int:
        return 3 * batch * self.forward()

    def eval_step(self, batch: int) -> int:
        """The light eval step: the joint forward, then the counterfactual
        (the opposite-label decode, its re-encoding and
        re-classification)."""
        again = self.decode() + self.encode() + 2 * self.hidden * self.classes
        return batch * (self.forward() + again)

    def widths(self) -> list[int]:
        return sorted(set(self.filters) | set(self.gcn_filters))
