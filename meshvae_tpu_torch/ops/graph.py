"""Static graph operands (counterpart of meshvae_tpu/ops/graph.py).

  * the scaled Laplacian L_hat = -D^{-1/2} A D^{-1/2} (self-loops removed)
    in the one layout the configured cheb_method reads: "pallas"
    block-sparse at or above the hybrid cutoff and dense below it, "dense"
    dense, "ell" a padded neighbour list (self-padded, weight 0 on the
    padding) at every level;
  * pool/unpool sampling matrices in the layout the configured pool_method
    reads: "gather" as gather indices + weights (rows of D are one-hot
    selections, rows of U have <= 3 barycentric entries), with the
    transpose P^T for the pool backward, always as gathers and above a
    fan-in cutoff also in CSR (the pool backward's kernel reads it) and as
    a rectangular block-sparse operator (the JAX package's layout); "dense"
    as the dense [M, N] matrix.

Every value (dense operator, neighbour weights, BSR blocks, pool weights w
/ t_w / dense, P^T blocks) is stored in the operator dtype: float32, or
bfloat16 under compute_dtype=bfloat16, rounded to nearest even from
float32 as the JAX package stores them. Indices stay integer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .block_sparse import BlockSparseOperator, to_block_sparse
from .bsr_shard import RowShard, ShardedBlockSparse  # noqa: F401

# Hybrid cutoff of cheb_method="pallas": levels with fewer vertices use a
# dense operator (the whole operator is tiny and one dense product beats a
# kernel launch that pads the level to 128-row blocks).
BSR_MIN_N = 1024

# Pool-backward layout cutoff: P^T fan-ins at or below this run as unrolled
# weighted gathers; above it (hub coarse vertices: config 1's three finest
# up-pools reach 51, 28 and 19) the backward runs P^T through its CSR
# kernel (ops/pool_transpose.py). Read when a PoolOperator is built.
TGRAD_ELL_MAX = 16


def normalized_neg_adjacency(adjacency: sp.spmatrix) -> sp.csr_matrix:
    """-D^{-1/2} A D^{-1/2} with unit edge weights and self-loops removed;
    the degree counts edges, ignoring the adjacency's stored values."""
    coo = sp.coo_matrix(adjacency)
    mask = coo.row != coo.col
    row, col = coo.row[mask], coo.col[mask]
    n = adjacency.shape[0]
    ones = np.ones(row.shape[0], dtype=np.float64)
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, row, ones)
    with np.errstate(divide="ignore"):
        dis = np.power(deg, -0.5)
    dis[~np.isfinite(dis)] = 0.0
    vals = -dis[row] * dis[col]
    return sp.csr_matrix((vals, (row, col)), shape=(n, n))


POOL_METHODS = ("gather", "dense")


@dataclasses.dataclass(frozen=True)
class GraphOperator:
    """The Chebyshev propagation operator at one hierarchy level: exactly
    one layout is set, `dense` [active_n, active_n], `bsr`, `bsr_sp`, or
    the neighbour list `ell_idx` / `ell_w` [active_n, max_degree].

    `active_n` < `n` marks the embedded final-conv operator: rows/columns
    at or beyond active_n are empty, and only the corner is stored.

    `bsr_sp` is this rank's row shard of the block-sparse operator under
    seq_parallel > 1 (ops/bsr_shard.py; parallel.sharding.shard_operators
    sets it) and `sp_group` the communicator of the ranks that hold the
    other shards. In an sp world the activations at a row-sharded level
    are this rank's rows of it, ``rows``: `row_shard`, which
    shard_operators sets at every such level (the rows of bsr_sp; of an
    ELL or dense operator cut to the rank's rows by
    ``shard_graph_operator``, whose ell_idx / ell_w or dense hold rows
    [row0, row0 + rows_local) of the level, a padding row gathering row 0
    with weight 0; level 0's for the embedded operator, whose corner
    keeps its own layout, a block-sparse corner its own shard), else the
    rows of bsr_sp."""

    dense: torch.Tensor | None
    bsr: BlockSparseOperator | None
    n: int
    active_n: int
    bsr_sp: "ShardedBlockSparse | None" = None
    sp_group: object = None
    row_shard: RowShard | None = None
    ell_idx: torch.Tensor | None = None   # int64, self-padded rows
    ell_w: torch.Tensor | None = None     # operator dtype, 0 on padding

    @property
    def rows(self) -> RowShard | None:
        """The RowShard of the activations at this level (None where they
        are whole)."""
        if self.row_shard is not None:
            return self.row_shard
        if self.bsr_sp is not None:
            return RowShard.of(self.bsr_sp, self.sp_group)
        return None

    @property
    def dtype(self) -> torch.dtype:
        if self.bsr_sp is not None:
            return self.bsr_sp.op.blocks.dtype
        if self.ell_w is not None:
            return self.ell_w.dtype
        return (self.dense if self.bsr is None else self.bsr.blocks).dtype


def shard_graph_operator(op: GraphOperator, rows: RowShard) -> GraphOperator:
    """An ELL or dense operator of a whole level (active_n == n) cut to
    the rank's rows `rows` (RowShard.for_level): ell_idx / ell_w
    [rows_local, D] or dense [rows_local, n]; a padding row gathers row 0
    with weight 0 (a zero row of dense). The columns stay global."""
    if op.ell_idx is not None:
        return dataclasses.replace(op, ell_idx=rows.local(op.ell_idx, dim=0),
                                   ell_w=rows.local(op.ell_w, dim=0),
                                   row_shard=rows)
    return dataclasses.replace(op, dense=rows.local(op.dense, dim=0),
                               row_shard=rows)


def _operator_from_laplacian(lap: sp.csr_matrix, device, n: int,
                             bsr_min_n: int | None, dtype: torch.dtype,
                             ell: bool = False) -> GraphOperator:
    active_n = lap.shape[0]
    if ell:
        idx, w = _to_ell(lap, pad_self=True)
        return GraphOperator(dense=None, bsr=None, n=n, active_n=active_n,
                             ell_idx=torch.from_numpy(idx).to(device),
                             ell_w=torch.from_numpy(w).to(device).to(dtype))
    if bsr_min_n is not None and active_n >= bsr_min_n:
        return GraphOperator(dense=None,
                             bsr=to_block_sparse(lap, device, dtype=dtype),
                             n=n, active_n=active_n)
    dense = torch.from_numpy(lap.toarray().astype(np.float32)).to(device)
    return GraphOperator(dense=dense.to(dtype), bsr=None, n=n,
                         active_n=active_n)


def cheb_operator(adjacency: sp.spmatrix, device,
                  bsr_min_n: int | None = BSR_MIN_N,
                  dtype: torch.dtype = torch.float32,
                  ell: bool = False) -> GraphOperator:
    """Block-sparse at or above bsr_min_n vertices, dense below; None keeps
    the operator dense (cheb_method="dense"). ell stores the neighbour
    list whatever the size (cheb_method="ell")."""
    lap = normalized_neg_adjacency(adjacency)
    return _operator_from_laplacian(lap, device, n=lap.shape[0],
                                    bsr_min_n=bsr_min_n, dtype=dtype, ell=ell)


def embed_operator(op_coarse: sp.spmatrix, n_full: int, device,
                   bsr_min_n: int | None = BSR_MIN_N,
                   dtype: torch.dtype = torch.float32,
                   ell: bool = False) -> GraphOperator:
    """A coarse-level operator acting on the top-left corner of an
    [n_full, n_full] index space: the reference's final-decoder-conv quirk
    (the last ChebConv sees the coarsest level's adjacency at full
    resolution). Only the corner is stored; cheb_conv runs the recurrence
    on it and one closed-form product on the rest."""
    lap = normalized_neg_adjacency(op_coarse)
    return _operator_from_laplacian(lap, device, n=n_full,
                                    bsr_min_n=bsr_min_n, dtype=dtype, ell=ell)


@dataclasses.dataclass(frozen=True)
class PoolOperator:
    """A sampling matrix P applied as out = P @ x per batch item.

    pool_method "gather": padded per-row gathers, out[m] = sum_k w[m, k] *
    x[idx[m, k]]; the backward dx = P^T @ g reads the transpose: `t_idx` /
    `t_w`, the same gathers over P^T, always; only when the largest fan-in
    exceeds TGRAD_ELL_MAX, P^T in CSR, `t_ptr` / `t_col` / `t_val`
    (transpose_csr), and `t_bsr`, P^T as a rectangular block-sparse
    operator (rows = pool inputs, columns = pool outputs; the JAX package's
    layout, held against it in the tests). pool_method "dense": `dense`
    [M, N] alone, the gather fields None.

    Under the row layout (``shard_pool_operator``) `in_rows` / `out_rows`
    are the RowShard of the input / output level when it is row-sharded:
    then idx / w hold P's rows of the output level's shard, and t_idx /
    t_w and the CSR P^T's rows of the input level's shard (t_ptr rebased
    to 0), zero-weight rows past the level's n; t_bsr is dropped."""

    idx: torch.Tensor | None     # [M, R] int64
    w: torch.Tensor | None       # [M, R] operator dtype (0 on padding)
    n_in: int
    n_out: int
    t_idx: torch.Tensor | None   # [N, T] int64 into output rows
    t_w: torch.Tensor | None     # [N, T] operator dtype (0 on padding)
    t_bsr: BlockSparseOperator | None = None
    dense: torch.Tensor | None = None  # [M, N] operator dtype
    t_ptr: torch.Tensor | None = None  # [N + 1] int32
    t_col: torch.Tensor | None = None  # [nnz] int32, ascending in a row
    t_val: torch.Tensor | None = None  # [nnz] operator dtype
    in_rows: RowShard | None = None
    out_rows: RowShard | None = None

    @property
    def x_rows(self) -> int:
        """Rows of x (and of dx) that this rank holds."""
        return self.n_in if self.in_rows is None else self.in_rows.rows_local

    @property
    def g_rows(self) -> int:
        """Rows of the cotangent the backward reads: the output level's
        n_pad_global after its all-gather when it is row-sharded."""
        return (self.n_out if self.out_rows is None
                else self.out_rows.n_pad_global)


def transpose_csr(csr_t: sp.spmatrix) -> tuple[np.ndarray, ...]:
    """P^T as (t_ptr [N + 1] int32, t_col int32, t_val float32), scipy's
    canonical CSR: columns ascending within each row, one entry each. A
    value is its entry rounded to float32, as block_sparse_arrays stores
    it in t_bsr's blocks (the two would differ only where the matrix holds
    duplicate entries, which the hierarchy's pool matrices do not)."""
    t = sp.csr_matrix(csr_t, copy=True)
    t.sum_duplicates()
    return (t.indptr.astype(np.int32), t.indices.astype(np.int32),
            t.data.astype(np.float32))


def _to_ell(mat: sp.csr_matrix,
            pad_self: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> padded neighbor list; padding carries weight 0 and index 0,
    or, with pad_self, the row's own index where the row has a column of
    that number (the Laplacian's self-padded layout, as the JAX package's
    _to_ell(pad_self=True))."""
    n, n_cols = mat.shape
    mat = mat.tocsr()
    counts = np.diff(mat.indptr)
    max_deg = max(int(counts.max()) if n else 0, 1)
    idx = np.zeros((n, max_deg), dtype=np.int64)
    w = np.zeros((n, max_deg), dtype=np.float32)
    for i in range(n):
        lo, hi = mat.indptr[i], mat.indptr[i + 1]
        idx[i, :hi - lo] = mat.indices[lo:hi]
        w[i, :hi - lo] = mat.data[lo:hi]
        if pad_self and i < n_cols:
            idx[i, hi - lo:] = i
    return idx, w


def pool_operator(mat: sp.spmatrix, device,
                  dtype: torch.dtype = torch.float32,
                  pool_method: str = "gather") -> PoolOperator:
    """Only the layout that pool_method reads is built (class docstring)."""
    if pool_method not in POOL_METHODS:
        raise ValueError(f"unknown pool method: {pool_method!r}; expected "
                         f"one of {POOL_METHODS}")
    csr = sp.csr_matrix(mat)
    if pool_method == "dense":
        dense = torch.from_numpy(csr.toarray().astype(np.float32))
        return PoolOperator(idx=None, w=None, n_in=csr.shape[1],
                            n_out=csr.shape[0], t_idx=None, t_w=None,
                            dense=dense.to(device).to(dtype))
    csr_t = sp.csr_matrix(csr.T)
    idx, w = _to_ell(csr)
    t_idx, t_w = _to_ell(csr_t)
    fan_in = int(np.diff(csr_t.indptr).max()) if csr_t.shape[0] else 0
    t = lambda a: torch.from_numpy(a).to(device)
    sparse = {}
    if fan_in > TGRAD_ELL_MAX:
        t_ptr, t_col, t_val = transpose_csr(csr_t)
        sparse = dict(t_ptr=t(t_ptr), t_col=t(t_col), t_val=t(t_val).to(dtype),
                      t_bsr=to_block_sparse(csr_t, device, allow_rect=True,
                                            dtype=dtype))
    return PoolOperator(
        idx=t(idx), w=t(w).to(dtype), n_in=csr.shape[1], n_out=csr.shape[0],
        t_idx=t(t_idx), t_w=t(t_w).to(dtype), **sparse)


def shard_pool_operator(pool: PoolOperator, in_rows: RowShard | None,
                        out_rows: RowShard | None) -> PoolOperator:
    """The pool operator of the row layout (PoolOperator docstring), cut
    once: P's gather rows of the output level's shard, P^T's gather and
    CSR rows of the input level's shard. A padding row of P gathers row 0
    with weight 0; one of P^T has no entries."""
    if in_rows is None and out_rows is None:
        return pool
    fields = dict(in_rows=in_rows, out_rows=out_rows, t_bsr=None)
    if pool.idx is not None and out_rows is not None:
        fields.update(idx=out_rows.local(pool.idx, dim=0),
                      w=out_rows.local(pool.w, dim=0))
    if pool.t_idx is not None and in_rows is not None:
        fields.update(t_idx=in_rows.local(pool.t_idx, dim=0),
                      t_w=in_rows.local(pool.t_w, dim=0))
        if pool.t_ptr is not None:
            r0, c = in_rows.row0, in_rows.count()
            ptr = pool.t_ptr.cpu().long()
            own = ptr[r0:r0 + c + 1] if c else torch.zeros(1, dtype=ptr.dtype)
            lo, hi = int(own[0]), int(own[-1])
            t_ptr = torch.full((in_rows.rows_local + 1,), hi - lo,
                               dtype=torch.int32)
            t_ptr[:c + 1] = own - lo
            fields.update(t_ptr=t_ptr.to(pool.t_ptr.device),
                          t_col=pool.t_col[lo:hi].contiguous(),
                          t_val=pool.t_val[lo:hi].contiguous())
    return dataclasses.replace(pool, **fields)
