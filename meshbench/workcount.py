"""The yardstick's arithmetic: the device's peaks, the model's operations
per step and per request, and the least time of a Laplacian kernel call.

Everything here is counted from the model's shapes and the operators'
nonzeros (reference/mesh.py's hierarchy), never from a kernel's layout, so
a change to tiles, blocks or row orders in the program does not move it.

Model operations (``mfu.*``): a Chebyshev conv of order K from F_in to
F_out channels on a level of n vertices whose L_hat has nnz nonzeros does
(K - 1) products at 2 operations per nonzero per column and one mix of
2 n K F_in F_out; a pool does 2 operations per nonzero of its matrix per
column; a linear head 2 in out. The final decoder conv acts on the
coarsest L_hat embedded in the finest level: its corner is a conv at the
coarsest level, and every other vertex (eigenvalue 0) needs one product
with sum_k T_k(0) W_k, 2 F_in F_out. The backward counts twice the
forward. Elementwise work, the loss and Adam are not counted.

Kernel calls (``spmm_roofline.*``): the bound of the chip-smoke harness's
``bound_nnz`` count. A call y = alpha L x + seeds on a level reads the
operator as CSR (a value and a 4-byte column per nonzero, 4-byte row
pointers), x, each seed and y once, at the mode's element size; it does 2
operations per nonzero per column (6 in the three-pass bf16x3 mode). Its
least time is the larger of the bytes at the HBM rate and the operations
at the mode's peak. Columns are counted as the model needs them: feature
padding of a call is not work.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp64": 67e12, "fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
              "fp8": 1979e12}
# the Laplacian kernel's modes: element bytes and the rate of their products
KERNEL_MODES = {"fp32": (4, PEAK_FLOPS["fp32"], 2),
                "bf16x3": (4, PEAK_FLOPS["bf16"], 6),
                "bf16": (2, PEAK_FLOPS["bf16"], 2)}
COL_PANEL = 128


def conv_flops(n: int, nnz: int, f_in: int, f_out: int, k: int) -> int:
    return (k - 1) * 2 * nnz * f_in + 2 * n * k * f_in * f_out


class ModelShape:
    """The sizes the counts need: level vertex counts and nonzeros of L_hat
    and of the pool matrices (a reference/mesh.py Hierarchy), and the
    config's widths."""

    def __init__(self, hier, cfg: dict, features: int = 3):
        self.n = [int(v) for v in hier.levels]
        self.nnz = [int(m.nnz) for m in hier.laplacians]
        self.down_nnz = [int(m.nnz) for m in hier.down]
        self.up_nnz = [int(m.nnz) for m in hier.up]
        self.filters = [features] + [int(f) for f in cfg["num_conv_filters"]]
        self.k = [int(k) for k in cfg["polygon_order"]]
        self.layers = int(cfg["n_layers"])
        self.hidden = int(cfg["num_hidden"])
        self.latent = int(cfg["num_style"])
        self.classes = int(cfg["num_classes"])

    @property
    def flat(self) -> int:
        return self.n[-1] * self.filters[-1]

    def encode(self) -> int:
        """Operations of one sample's encoder, enc_lin included."""
        f, total = self.filters, 0
        for i in range(self.layers):
            total += conv_flops(self.n[i], self.nnz[i], f[i], f[i + 1],
                                self.k[i])
            total += 2 * self.down_nnz[i] * f[i + 1]
        return total + 2 * self.flat * self.hidden

    def heads(self, with_logvar: bool = True) -> int:
        """The classifier and the posterior heads of one sample."""
        post = 2 * (self.hidden + self.classes) * self.latent
        return (2 * self.hidden * self.classes
                + post * (2 if with_logvar else 1))

    def decode(self) -> int:
        """Operations of one sample's decoder."""
        f, nl, total = self.filters, self.layers, 0
        total += 2 * (self.latent + self.classes) * self.hidden
        total += 2 * self.hidden * self.flat
        for i in range(nl):
            lvl = nl - 1 - i
            fin, fout = f[-i - 1], f[-i - 2]
            total += 2 * self.up_nnz[lvl] * fin
            total += conv_flops(self.n[lvl], self.nnz[lvl], fin, fout,
                                self.k[i])
        fin, fout, k = f[1], f[0], self.k[len(f) - 2]
        total += conv_flops(self.n[-1], self.nnz[-1], fin, fout, k)
        total += 2 * (self.n[0] - self.n[-1]) * fin * fout
        return total

    def train_step(self, batch: int) -> int:
        return 3 * batch * (self.encode() + self.heads() + self.decode())

    def eval_step(self, batch: int) -> int:
        """The eval step: the forward, the label-swapped decode, its
        re-encoding and re-classification."""
        fwd = self.encode() + self.heads() + self.decode()
        again = self.decode() + self.encode() + 2 * self.hidden * self.classes
        return batch * (fwd + again)

    def widths(self) -> list[int]:
        return sorted(set(self.filters))

    def level_of_rows(self, n_pad: int) -> int | None:
        """The level a kernel call of n_pad (padded) rows runs on: the
        largest level of at most n_pad vertices, if its padding is less
        than its size (levels are factors apart)."""
        fits = [(n, i) for i, n in enumerate(self.n) if n <= n_pad < 2 * n]
        return max(fits)[1] if fits else None


def _pad_width(batch: int, f: int) -> int:
    f_pad = f
    while (batch * f_pad) % COL_PANEL:
        f_pad += 1
    return f_pad


def needed_columns(c: int, batches, widths) -> int:
    """Columns of a kernel call that carry model features: for a call of
    c columns over a batch of b rows (b among `batches`), f_pad = c / b
    holds the widest model width f <= f_pad whose panel padding is f_pad;
    c itself when none fits."""
    for b in batches:
        if c % b:
            continue
        f_pad = c // b
        fits = [w for w in widths if w <= f_pad]
        if fits and _pad_width(b, max(fits)) == f_pad:
            return b * max(fits)
    return c


def spmm_call_seconds(mode: str, n: int, nnz: int, columns: int,
                      seeds: int) -> float:
    """Least time of one Laplacian kernel call (module docstring)."""
    elt, peak, ops_per_nz = KERNEL_MODES[mode]
    nbytes = nnz * (elt + 4) + 4 * (n + 1) + elt * columns * n * (2 + seeds)
    ops = ops_per_nz * nnz * columns
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def spmm_least_seconds(calls: dict, shape: ModelShape, batches) -> float:
    """Least time of the calls counted by the program's launch counter,
    {(mode, n_pad, n_pad_cols, C, kind): count}; a kind names its seeds
    (" plus", " prev", " dot"). A call whose level is not one of the
    hierarchy's raises."""
    total = 0.0
    for (mode, n_pad, _, c, kind), count in calls.items():
        lvl = shape.level_of_rows(n_pad)
        if lvl is None:
            raise ValueError(f"a kernel call on {n_pad} rows matches no "
                             f"level of {shape.n}")
        seeds = sum(s in kind for s in (" plus", " prev", " dot"))
        cols = needed_columns(c, batches, shape.widths())
        total += count * spmm_call_seconds(mode, shape.n[lvl],
                                           shape.nnz[lvl], cols, seeds)
    return total
