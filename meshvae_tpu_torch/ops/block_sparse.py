"""Host-side block-CSR (BSR) conversion for the block-sparse SpMM kernel
(counterpart of meshvae_tpu/ops/block_sparse.py, same layout).

Occupied 128x128 blocks are sorted by (block_row, block_col); every block-row
is present (absent rows get an explicit zero block); the row count is padded
to a multiple of 8 when that adds at most 5% rows. The row-grouped view
``g_idx [nR, G]`` / ``g_bcol [nR * G]`` lists each row's blocks, with padded
slots set to ``num_blocks`` (a zero block that is never stored) and their
``g_bcol`` aliasing the row's last real column.

``tile_mask [nb, 8]`` (uint8) records which 16x16 tiles of each block hold
a nonzero: bit t of byte s is set when rows 16s..16s+15, columns
16t..16t+15 of the block do. The kernel skips every tile whose bit is
clear. It is derived from the float32 sums, before any cast to bfloat16,
so it is a superset of the nonzeros in every storage dtype.

``row_order [nR]`` (int32) is the work list of the persistent kernel
``emitted_spmm``: the row blocks sorted by their occupied 16-deep k chunks
(``row_chunks``), most first, ties in row order. It is built from
``tile_mask`` when the operator is made; any permutation of the rows gives
the same product, so an operator made by hand may leave it None.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

BLOCK = 128
TILE = 16                   # edge of a tile_mask tile
TILES = BLOCK // TILE       # tiles per block edge: 8 strips x 8 bits


@dataclasses.dataclass(frozen=True)
class BlockSparseOperator:
    """BSR operator: [nb, BLOCK, BLOCK] blocks (float32, or bfloat16 under
    compute_dtype=bfloat16) + coordinates, as tensors on one device. `n` is
    the true row count, `n_pad` the padded one; rectangular operators carry
    n_pad_cols != n_pad."""

    blocks: torch.Tensor      # [nb, BLOCK, BLOCK] float32 or bfloat16
    block_row: torch.Tensor   # [nb] int32
    block_col: torch.Tensor   # [nb] int32
    g_idx: torch.Tensor       # [nR, G] int32 into blocks (num_blocks = pad)
    g_bcol: torch.Tensor      # [nR * G] int32 column block of each slot
    n: int
    n_pad: int
    n_pad_cols: int
    g_width: int
    tile_mask: torch.Tensor   # [nb, 8] uint8, bit t of byte s: tile (s, t)
    row_order: torch.Tensor | None = None  # [nR] int32, longest rows first

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]


def tile_mask(blocks: torch.Tensor) -> torch.Tensor:
    """The tile_mask of a [nb, 128, 128] blocks tensor, on its device (also
    for an operator built without to_block_sparse)."""
    nb = blocks.shape[0]
    nonzero = (blocks != 0).reshape(nb, TILES, TILE, TILES, TILE).any(4)
    weights = 1 << torch.arange(TILES, device=blocks.device)
    return (nonzero.any(2).long() * weights).sum(-1).to(torch.uint8)


def row_chunks(tile_mask: np.ndarray, g_idx: np.ndarray,
               g_bcol: np.ndarray, n_col_blocks: int) -> np.ndarray:
    """Per row block, the 16-deep k chunks that some strip of it needs:
    over the row's real slots (g_idx < num_blocks, g_bcol inside x), the
    chunks t whose bit is set in any of the slot block's 8 mask bytes."""
    mask = np.asarray(tile_mask, np.uint8)
    nb = mask.shape[0]
    per_block = np.unpackbits(np.bitwise_or.reduce(mask, axis=1)[:, None],
                              axis=1).sum(1)
    g_idx = np.asarray(g_idx).astype(np.int64)
    bcol = np.asarray(g_bcol).astype(np.int64).reshape(g_idx.shape)
    real = (g_idx >= 0) & (g_idx < nb) & (bcol >= 0) & (bcol < n_col_blocks)
    chunks = np.where(real, per_block[np.clip(g_idx, 0, max(nb - 1, 0))], 0)
    return chunks.sum(1)


def row_order(tile_mask, g_idx, g_bcol, n_col_blocks: int) -> np.ndarray:
    """The work list: row blocks by row_chunks, most first, stable."""
    chunks = row_chunks(tile_mask, g_idx, g_bcol, n_col_blocks)
    return np.argsort(-chunks, kind="stable").astype(np.int32)


def padded_rows(n: int, block: int = BLOCK) -> int:
    """n_pad of an operator of n rows: whole blocks, their count rounded
    up to a multiple of 8 when that adds at most 5%."""
    nr = -(-n // block)
    nr8 = -(-nr // 8) * 8
    return (nr8 if nr8 > nr and (nr8 - nr) * 20 <= nr else nr) * block


def block_sparse_arrays(mat: sp.spmatrix, block: int = BLOCK,
                        allow_rect: bool = False) -> dict:
    """The BSR layout of `mat` as numpy arrays (see the module docstring)."""
    coo = sp.coo_matrix(mat)
    n = coo.shape[0]
    if not allow_rect and coo.shape[0] != coo.shape[1]:
        raise ValueError(f"square operators only, got {coo.shape}")
    n_pad = padded_rows(n, block)

    keys = {}
    for r, c, v in zip(coo.row, coo.col, coo.data):
        br, bc = int(r // block), int(c // block)
        blk = keys.setdefault((br, bc), np.zeros((block, block), np.float32))
        blk[r - br * block, c - bc * block] += v

    order = sorted(keys)
    if not order:  # degenerate: one explicit zero block keeps shapes static
        order = [(0, 0)]
        keys[(0, 0)] = np.zeros((block, block), np.float32)

    blocks = np.stack([keys[k] for k in order])
    block_row = np.array([k[0] for k in order], np.int32)
    block_col = np.array([k[1] for k in order], np.int32)

    # every block-row must appear (empty output rows need zeroing): insert an
    # explicit zero block for absent rows
    present = set(block_row.tolist())
    missing = [r for r in range(n_pad // block) if r not in present]
    if missing:
        zb = np.zeros((len(missing), block, block), np.float32)
        blocks = np.concatenate([blocks, zb])
        block_row = np.concatenate([block_row, np.array(missing, np.int32)])
        block_col = np.concatenate([block_col,
                                    np.zeros(len(missing), np.int32)])
        reorder = np.lexsort((block_col, block_row))
        blocks, block_row, block_col = (blocks[reorder], block_row[reorder],
                                        block_col[reorder])

    nb = len(block_row)
    n_rows = n_pad // block
    per_row = [[] for _ in range(n_rows)]
    for i in range(nb):
        per_row[int(block_row[i])].append(i)
    g = max(len(v) for v in per_row)
    g_idx = np.full((n_rows, g), nb, np.int32)
    g_bcol = np.zeros((n_rows, g), np.int32)
    for r, idxs in enumerate(per_row):
        for i, bi in enumerate(idxs):
            g_idx[r, i] = bi
            g_bcol[r, i] = block_col[bi]
        g_bcol[r, len(idxs):] = block_col[idxs[-1]]

    mask = tile_mask(torch.from_numpy(blocks)).numpy()
    n_pad_cols = (-(-coo.shape[1] // block) * block if allow_rect
                  else n_pad)
    return dict(blocks=blocks, block_row=block_row, block_col=block_col,
                g_idx=g_idx, g_bcol=g_bcol.reshape(-1), tile_mask=mask, n=n,
                n_pad=n_pad, n_pad_cols=n_pad_cols, g_width=g,
                row_order=row_order(mask, g_idx, g_bcol, n_pad_cols // block))


def to_block_sparse(mat: sp.spmatrix, device, block: int = BLOCK,
                    allow_rect: bool = False,
                    dtype: torch.dtype = torch.float32) -> BlockSparseOperator:
    """The blocks are summed in float32 and stored in `dtype` (bfloat16
    rounds each value to nearest even, as jnp.asarray(..., bfloat16))."""
    a = block_sparse_arrays(mat, block=block, allow_rect=allow_rect)
    t = lambda arr: torch.from_numpy(arr).to(device)
    return BlockSparseOperator(
        blocks=t(a["blocks"]).to(dtype), block_row=t(a["block_row"]),
        block_col=t(a["block_col"]), g_idx=t(a["g_idx"]),
        g_bcol=t(a["g_bcol"]), n=a["n"], n_pad=a["n_pad"],
        n_pad_cols=a["n_pad_cols"], g_width=a["g_width"],
        tile_mask=t(a["tile_mask"]), row_order=t(a["row_order"]))


def bsr_to_dense(bsr: BlockSparseOperator) -> np.ndarray:
    out = np.zeros((bsr.n_pad, bsr.n_pad_cols), np.float32)
    blocks = bsr.blocks.cpu().float().numpy()
    rows = bsr.block_row.cpu().numpy()
    cols = bsr.block_col.cpu().numpy()
    for i in range(bsr.num_blocks):
        r, c = int(rows[i]) * BLOCK, int(cols[i]) * BLOCK
        out[r:r + BLOCK, c:c + BLOCK] += blocks[i]
    return out[:bsr.n]
