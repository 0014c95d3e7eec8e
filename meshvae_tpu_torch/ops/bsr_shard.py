"""Vertex-sharded ("sp") block-sparse SpMM: the distributed form of the
Chebyshev propagation (counterpart of meshvae_tpu/ops/pallas_shard.py).

The square block-CSR Laplacian is cut on the host into ``sp`` row shards
(``shard_block_sparse``, block for block as the JAX package cuts it). Each
rank of an ``sp`` group keeps its own shard, a rectangular
``BlockSparseOperator`` of ``rows_per * 128`` rows whose columns are the
global ones. ``mapped_product`` is the port of the TPU function
``_mapped_product`` (pallas_shard.py:150): it all-gathers the row-sharded
activation over the ``sp`` group into ``[n_pad_global, C]`` and runs the
hand-written kernel ``bsr_grouped_spmm`` (csrc/bsr_spmm.cu) on the shard,
so each rank computes its own output rows. The seeds ``t_prev``, ``t_plus``
and the lazy seed's ``gm`` are row-sharded like the output and never cross
the group. A CPU tensor runs the kernel's plain twin on the shard, a CUDA
tensor the kernel; no other product stands in for it.

The operator is globally symmetric (L = -D^{-1/2} A D^{-1/2}), so every
backward is the same sharded product on the row-sharded cotangent:
``bsr_matmul_sharded``, ``cheb_step_sharded`` and ``_BasisMixSharded``, the
sharded form of ops/cheb.py's ``_BasisMix`` with its two-seed adjoint
recurrence and, behind ``cheb.FUSED_SEED_DOT`` on square mixes, the lazy
seed. The local column count is always whole (batch item, f_pad) pairs
(the batch is not split inside a conv), so the JAX package's
``(c // dp) % f_pad`` condition (pallas_shard.py:328-329) always holds.

Activations between the convs (``RowShard``): in an sp world
(parallel.sharding.shard_operators) a tensor at a row-sharded level holds
only the rank's rows [row0, row0 + rows_local) of the level, the rows the
Laplacian shard computes, and ``cheb_conv_bsr_sharded`` takes and returns
them: a product or a pool all-gathers its input for the call only, and
nothing whole is kept. The same RowShard serves a level whose operator is
an ELL or dense row shard (``RowShard.for_level``, ops/cheb.py). Where a
row-sharded level meets a whole-tensor consumer (the flatten into a head,
the final conv's embedded corner) ``from_rows`` all-gathers its rows, and
``to_rows`` cuts a whole tensor's rows out again; their adjoints are each
other's (a whole tensor's gradient is the same full gradient on every
rank). A replicated parameter used on the rank's rows (dW of the basis
mix, ``rows_matmul``, ``add_bias_rows``) has its gradient contracted over
the local rows and summed over the group in fp32, where the JAX package's
partitioner sums it over "sp". The JAX package pads each dp shard's
columns to 128 (pallas_shard.py:368-372, TPU tuning); the port keeps its
own ``pad_features``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .block_sparse import (BLOCK, BlockSparseOperator, padded_rows,
                           row_order, tile_mask)
from .bsr_spmm import bsr_grouped_spmm, pad_features
from .cheb_mix import cheb_mix, cheb_mix_dw_fp32


@dataclasses.dataclass(frozen=True)
class ShardedBlockSparse:
    """One rank's row shard: global block rows [sp_rank * rows_per,
    (sp_rank + 1) * rows_per) of a square operator of `n` rows padded to
    `n_pad_global` (a multiple of sp * 128). `op` is rectangular:
    [rows_per * 128, n_pad_global], block rows local, block columns
    global."""

    op: BlockSparseOperator
    n: int
    n_pad_global: int
    sp: int
    sp_rank: int

    @property
    def rows_per(self) -> int:
        """Block rows per shard."""
        return self.n_pad_global // (self.sp * BLOCK)

    @property
    def row0(self) -> int:
        """First global row of the shard."""
        return self.sp_rank * self.rows_per * BLOCK

    @property
    def rows_local(self) -> int:
        return self.rows_per * BLOCK


def _shard_arrays(blocks: np.ndarray, brow: np.ndarray, bcol: np.ndarray,
                  rows_per: int, s: int):
    """Shard s's blocks, local block rows and global block columns, sorted
    by (row, column), with an explicit zero block (column 0) for every
    local block row that has none (pallas_shard.py:82-95)."""
    r0 = s * rows_per
    m = (brow >= r0) & (brow < r0 + rows_per)
    b, r, c = blocks[m], brow[m] - r0, bcol[m]
    missing = sorted(set(range(rows_per)) - set(r.tolist()))
    if missing:
        b = np.concatenate(
            [b, np.zeros((len(missing), BLOCK, BLOCK), np.float32)])
        r = np.concatenate([r, np.array(missing, np.int64)])
        c = np.concatenate([c, np.zeros(len(missing), np.int64)])
    order = np.lexsort((c, r))
    return b[order], r[order].astype(np.int32), c[order].astype(np.int32)


def _grouped_view(b: np.ndarray, r: np.ndarray, c: np.ndarray,
                  rows_per: int):
    """The row-grouped view of a shard (pallas_shard.py:123-146): only
    blocks with content join a row's slots, in column order; padded slots
    index num_blocks and alias the row's last real column; a row of
    placeholders only has every slot padded, at column 0."""
    nb = b.shape[0]
    per_row = [[] for _ in range(rows_per)]
    for i in range(nb):
        if np.any(b[i]):
            per_row[int(r[i])].append(i)
    g = max(1, max(len(v) for v in per_row))
    g_idx = np.full((rows_per, g), nb, np.int32)
    g_bcol = np.zeros((rows_per, g), np.int32)
    for row, idxs in enumerate(per_row):
        for i, bi in enumerate(idxs):
            g_idx[row, i] = bi
            g_bcol[row, i] = c[bi]
        if idxs:
            g_bcol[row, len(idxs):] = c[idxs[-1]]
    return g_idx, g_bcol, g


def shard_block_sparse(bsr: BlockSparseOperator, sp: int,
                       sp_rank: int) -> ShardedBlockSparse:
    """Rank sp_rank's row shard of a square operator (host-side, block
    granularity, as meshvae_tpu.ops.pallas_shard.shard_block_sparse): the
    padded dimension grows to a multiple of sp * 128, and every local block
    row carries an explicit zero block when it has none. Unlike the JAX
    package's stacked shards, a shard keeps only its own blocks (no common
    nb_max) and its own group width G; its tile_mask and row_order are
    computed on it."""
    if bsr.n_pad != bsr.n_pad_cols:
        raise ValueError("only square operators shard over rows, got "
                         f"[{bsr.n_pad}, {bsr.n_pad_cols}]")
    total_block_rows = -(-bsr.n_pad // (sp * BLOCK)) * sp
    rows_per = total_block_rows // sp
    n_pad_global = total_block_rows * BLOCK
    b, r, c = _shard_arrays(bsr.blocks.float().cpu().numpy(),  # exact
                            bsr.block_row.cpu().numpy().astype(np.int64),
                            bsr.block_col.cpu().numpy().astype(np.int64),
                            rows_per, sp_rank)
    g_idx, g_bcol, g = _grouped_view(b, r, c, rows_per)
    mask = tile_mask(torch.from_numpy(b)).numpy()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        bsr.blocks.device)
    op = BlockSparseOperator(
        blocks=t(b).to(bsr.blocks.dtype), block_row=t(r), block_col=t(c),
        g_idx=t(g_idx), g_bcol=t(g_bcol.reshape(-1)),
        n=rows_per * BLOCK, n_pad=rows_per * BLOCK, n_pad_cols=n_pad_global,
        g_width=g, tile_mask=t(mask),
        row_order=t(row_order(mask, g_idx, g_bcol, n_pad_global // BLOCK)))
    return ShardedBlockSparse(op=op, n=bsr.n, n_pad_global=n_pad_global,
                              sp=sp, sp_rank=sp_rank)


def shard_block_sparse_all(bsr: BlockSparseOperator,
                           sp: int) -> list[ShardedBlockSparse]:
    """Every shard of a square operator (tests, and timing the shards in
    one process)."""
    return [shard_block_sparse(bsr, sp, s) for s in range(sp)]


def mapped_product(sbsr: ShardedBlockSparse, x_local: torch.Tensor, group,
                   mode: str, alpha: float = 1.0,
                   t_prev: torch.Tensor | None = None,
                   t_plus: torch.Tensor | None = None,
                   t_plus_dot: tuple | None = None) -> torch.Tensor:
    """y_local = alpha * (L_shard @ all_gather_sp(x_local)) + t_plus -
    t_prev [+ gm @ kron(I, wt)]: x_local and the seeds are this rank's rows
    [rows_per * 128, C]; `group` is the sp communicator
    (parallel.sharding.Comm), whose all_gather concatenates the ranks' rows
    in rank order."""
    x_full = group.all_gather(x_local)
    return bsr_grouped_spmm(sbsr.op, x_full, mode, alpha, t_plus=t_plus,
                            t_prev=t_prev, t_plus_dot=t_plus_dot)


class _MatmulSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_local, sbsr, group, mode):
        ctx.args = (sbsr, group, mode)
        return mapped_product(sbsr, x_local, group, mode)

    @staticmethod
    def backward(ctx, g):
        sbsr, group, mode = ctx.args
        # L symmetric: dx = L^T g = L g, the same sharded product
        return (mapped_product(sbsr, g.contiguous(), group, mode), None,
                None, None)


def bsr_matmul_sharded(sbsr: ShardedBlockSparse, x_local: torch.Tensor,
                       group, mode: str = "fp32") -> torch.Tensor:
    """y = L @ x with the rows of x and y sharded over the sp group
    (pallas_shard.bsr_matmul_sharded); differentiable in x."""
    return _MatmulSharded.apply(x_local, sbsr, group, mode)


class _StepSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t1, t0, sbsr, group, mode):
        ctx.args = (sbsr, group, mode)
        return mapped_product(sbsr, t1, group, mode, 2.0, t_prev=t0)

    @staticmethod
    def backward(ctx, g):
        sbsr, group, mode = ctx.args
        return (mapped_product(sbsr, g.contiguous(), group, mode, 2.0), -g,
                None, None, None)


def cheb_step_sharded(sbsr: ShardedBlockSparse, t1: torch.Tensor,
                      t0: torch.Tensor, group,
                      mode: str = "fp32") -> torch.Tensor:
    """T_k = 2 L T_{k-1} - T_{k-2} on row-sharded states, the seed folded
    into the kernel (pallas_shard.cheb_step_sharded); VJP (2 L g, -g)."""
    return _StepSharded.apply(t1, t0, sbsr, group, mode)


class _BasisMixSharded(torch.autograd.Function):
    """_BasisMix on the rank's rows [rows_local, B, F_pad]: the basis
    T_0..T_{K-1} as sharded products (each all-gathers its input over sp),
    the mix on the local rows (ops/cheb_mix.py, as _BasisMix: a row's mix
    is the same on a shard as on the whole level). Backward: dW contracts
    the local orders with g in fp32 (cheb_mix_dw_fp32, the twin's
    contraction before its rounding) and is summed over the group; dx runs
    the two-seed adjoint recurrence as sharded products, with the lazy
    seed under FUSED_SEED_DOT (pallas_shard._basis_mix_sharded)."""

    @staticmethod
    def forward(ctx, xt, w, sbsr, group, mode):
        rows, b, f_pad = xt.shape
        k, _, f_out = w.shape
        c = b * f_pad

        def mm(t, alpha, t_prev=None):
            prev = None if t_prev is None else t_prev.reshape(rows, c)
            return mapped_product(sbsr, t.reshape(rows, c), group, mode,
                                  alpha, t_prev=prev).reshape(rows, b, f_pad)

        txs = [xt.contiguous()]
        if k > 1:
            txs.append(mm(txs[0], 1.0))
        for _ in range(2, k):
            txs.append(mm(txs[-1], 2.0, txs[-2]))
        ctx.save_for_backward(w, *txs)
        ctx.args = (sbsr, group, mode)
        return cheb_mix([t.view(rows * b, f_pad) for t in txs],
                        w).view(rows, b, f_out)

    @staticmethod
    def backward(ctx, g):
        from . import cheb

        w, *txs = ctx.saved_tensors
        sbsr, group, mode = ctx.args
        rows, b, _ = txs[0].shape
        k, f_pad, f_out = w.shape
        c = b * f_pad
        gm = g.reshape(rows * b, f_out)
        # the partial contractions over the rows, summed over the group in
        # fp32 and rounded to w's dtype once (as the JAX partitioner sums
        # the fp32 dot before its cast)
        dw = cheb_mix_dw_fp32([t.view(rows * b, f_pad) for t in txs], gm)
        dw = group.all_reduce_(dw).to(w.dtype)
        if not ctx.needs_input_grad[0]:
            return None, dw, None, None, None
        c_of = lambda j: torch.matmul(gm, w[j].t()).reshape(rows, c)
        if k == 1:
            dx = c_of(0)
        else:
            if cheb.FUSED_SEED_DOT and f_pad == f_out and mode != "bf16x3":
                gm2 = gm.reshape(rows, c).contiguous()
                seeds = [{"t_plus_dot": (gm2, w[j].t().contiguous())}
                         for j in range(k - 1)]
            else:
                seeds = [{"t_plus": c_of(j)} for j in range(k - 1)]
            u, prev_u = c_of(k - 1), None
            for j in range(k - 1, 1, -1):
                u, prev_u = mapped_product(sbsr, u, group, mode, 2.0,
                                           t_prev=prev_u, **seeds[j - 1]), u
            dx = mapped_product(sbsr, u, group, mode, 1.0, t_prev=prev_u,
                                **seeds[0])
        return dx.reshape(rows, b, f_pad), dw, None, None, None


@dataclasses.dataclass(frozen=True, eq=False)
class RowShard:
    """The vertex rows of one level that an sp rank holds when the
    activations are row-sharded: global rows [row0, row0 + rows_local) of
    the level's `n` vertices padded to n_pad_global = sp * rows_local, the
    rows of the level's Laplacian shard. A row-sharded tensor is
    [B, rows_local, F] in the model layout; its rows at or past n are
    padding and hold zeros. `group` is the sp communicator."""

    n: int
    n_pad_global: int
    row0: int
    rows_local: int
    group: object

    @staticmethod
    def of(sbsr: ShardedBlockSparse, group) -> "RowShard":
        return RowShard(n=sbsr.n, n_pad_global=sbsr.n_pad_global,
                        row0=sbsr.row0, rows_local=sbsr.rows_local,
                        group=group)

    @staticmethod
    def for_level(n: int, sp: int, sp_rank: int, group) -> "RowShard":
        """The rows of a level of n vertices on rank sp_rank of `sp`:
        those of the level's block-sparse shard (shard_block_sparse:
        n_pad_global = sp * 128 * ceil(n_pad / (sp * 128)), n_pad the
        operator's padded rows), whatever layout its operator has."""
        rows_local = -(-padded_rows(n) // (sp * BLOCK)) * BLOCK
        return RowShard(n=n, n_pad_global=sp * rows_local,
                        row0=sp_rank * rows_local, rows_local=rows_local,
                        group=group)

    def count(self, n: int | None = None) -> int:
        """This rank's rows below n (default: the level's n)."""
        n = self.n if n is None else n
        return max(0, min(n - self.row0, self.rows_local))

    def gather(self, t: torch.Tensor, dim: int = 1,
               n: int | None = None) -> torch.Tensor:
        """Rows [0, n) of a row-sharded tensor, whole on every rank (no
        autograd): each rank's first min(rows_local, n) rows (t's missing
        rows taken as zeros), all-gathered in rank order. Rank 0 holds all
        of [0, n) when n <= rows_local, so the gathered rows start with
        [0, n) either way."""
        n = self.n if n is None else n
        m = min(self.rows_local, n)
        have = t.shape[dim]
        if have > m:
            t = t.narrow(dim, 0, m)
        elif have < m:
            shape = list(t.shape)
            shape[dim] = m - have
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
        return self.group.all_gather(t, dim=dim).narrow(dim, 0, n)

    def local(self, t: torch.Tensor, dim: int = 1, n: int | None = None,
              rows: int | None = None) -> torch.Tensor:
        """This rank's rows of a whole tensor of rows [0, n) (no
        autograd; host tensors too), padded with zero rows to `rows`
        (default rows_local)."""
        c = self.count(n)
        rows = self.rows_local if rows is None else rows
        own = t.narrow(dim, self.row0 if c else 0, c)
        if rows > c:
            shape = list(t.shape)
            shape[dim] = rows - c
            own = torch.cat([own, t.new_zeros(shape)], dim=dim)
        return own.contiguous()


class _ToRows(torch.autograd.Function):
    """A whole tensor of rows [0, n) -> this rank's rows; the gradient of
    the whole tensor is the all-gather of the ranks' row gradients (every
    rank then holds the same full gradient)."""

    @staticmethod
    def forward(ctx, t, shard, dim, n, rows):
        ctx.args = (shard, dim, n)
        return shard.local(t, dim, n, rows)

    @staticmethod
    def backward(ctx, g):
        shard, dim, n = ctx.args
        return shard.gather(g, dim, n), None, None, None, None


class _FromRows(torch.autograd.Function):
    """This rank's rows -> the whole tensor of rows [0, n) on every rank;
    every rank computes the same full gradient of the whole tensor and
    keeps its own rows of it."""

    @staticmethod
    def forward(ctx, t, shard, dim, n):
        ctx.args = (shard, dim, n, t.shape[dim])
        return shard.gather(t, dim, n)

    @staticmethod
    def backward(ctx, g):
        shard, dim, n, rows = ctx.args
        return shard.local(g, dim, n, rows), None, None, None


def to_rows(t: torch.Tensor, shard: RowShard, dim: int = 1,
            n: int | None = None, rows: int | None = None) -> torch.Tensor:
    """This rank's rows of a whole tensor (RowShard.local), differentiable:
    where a whole tensor feeds a row-sharded level."""
    return _ToRows.apply(t, shard, dim, n, rows)


def from_rows(t: torch.Tensor, shard: RowShard, dim: int = 1,
              n: int | None = None) -> torch.Tensor:
    """The whole tensor of rows [0, n) from every rank's rows
    (RowShard.gather), differentiable: where a row-sharded level feeds a
    whole-tensor consumer."""
    return _FromRows.apply(t, shard, dim, n)


class _GroupSum(torch.autograd.Function):
    """The sum over the group of every rank's t; the backward is the
    identity: each rank's t is a partial sum of one scalar per item (the
    loss's vertex sums), so its gradient is the sum's."""

    @staticmethod
    def forward(ctx, t, group):
        return group.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    return _GroupSum.apply(t, group)


class _BiasRows(torch.autograd.Function):
    """t + bias on the first `valid` rows of a row-sharded [B, rows, F]
    tensor (the padding rows keep their zeros). bias is replicated: its
    gradient, contracted over this rank's rows in fp32, is summed over the
    group and rounded to bias's dtype once."""

    @staticmethod
    def forward(ctx, t, bias, valid, group):
        ctx.valid, ctx.group, ctx.dtype = valid, group, bias.dtype
        mask = torch.zeros((t.shape[1], 1), dtype=t.dtype, device=t.device)
        mask[:valid] = 1
        return t + mask * bias

    @staticmethod
    def backward(ctx, g):
        gb = g[:, :ctx.valid].float().sum(dim=(0, 1))
        gb = ctx.group.all_reduce_(gb).to(ctx.dtype)
        return g, gb, None, None


def add_bias_rows(t: torch.Tensor, bias: torch.Tensor, valid: int,
                  group) -> torch.Tensor:
    return _BiasRows.apply(t, bias, valid, group)


class _RowsMatmul(torch.autograd.Function):
    """x @ w with x's rows row-sharded and w replicated: dW, contracted over
    this rank's rows in fp32, is summed over the group and rounded once
    (as _BasisMixSharded's dW)."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.matmul(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.reshape(-1, w.shape[0]).t().float(),
                              g.reshape(-1, w.shape[1]).float())
            dw = ctx.group.all_reduce_(dw).to(w.dtype)
        return dx, dw, None


def rows_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    return _RowsMatmul.apply(x, w, group)


def cheb_conv_bsr_sharded(x: torch.Tensor, op, weight: torch.Tensor,
                          bias: torch.Tensor | None,
                          precision=None) -> torch.Tensor:
    """Chebyshev conv with the vertex-sharded kernel (the counterpart of
    pallas_shard.cheb_conv_pallas_sharded): `op` is a GraphOperator with
    bsr_sp and sp_group set, and x this rank's rows [B, rows_local, F_in]
    of its level (op.rows), zero past the level's n; so is the result.
    bias is added to the rows below n only, and its gradient summed over
    the group. The recurrence state, the seeds and the basis are
    row-sharded; bf16 blocks keep a bf16 state."""
    from .cheb import _KERNEL_MODE, resolve_precision

    sbsr: ShardedBlockSparse = op.bsr_sp
    group = op.sp_group
    mode = _KERNEL_MODE[resolve_precision(precision, sbsr.op.blocks.dtype)]
    shard = op.rows
    b, rows, f_in = x.shape
    if rows != shard.rows_local:
        raise ValueError(f"the sharded conv takes the rank's "
                         f"{shard.rows_local} rows of its level, got {rows}")
    f_pad = pad_features(b, f_in)
    xt = F.pad(x.transpose(0, 1), (0, f_pad - f_in))
    w = F.pad(weight, (0, 0, 0, f_pad - f_in))
    out = _BasisMixSharded.apply(xt, w, sbsr, group, mode).transpose(0, 1)
    return out if bias is None else add_bias_rows(out, bias, shard.count(),
                                                  group)
