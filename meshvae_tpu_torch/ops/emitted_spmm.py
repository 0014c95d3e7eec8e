"""Persistent block-sparse SpMM behind a TMA pipeline: y = L @ x.

``emitted_spmm`` launches the hand-written CUDA kernel
(``csrc/emitted_spmm.cu``) for CUDA tensors and runs the plain PyTorch twin
``emitted_spmm_reference`` for CPU tensors. It replaces TPU kernel #10,
``emitted_spmm`` of benchmarks/emitted_probe.py (the "emitted pipeline"
probe: one grid step per column panel with manual double-buffered DMAs),
and computes what it computes: y = L @ x over the row-grouped view
(``g_idx`` / ``g_bcol``; padded slots add nothing), x [n_pad_cols, C] with
C % 128 == 0 in the blocks' dtype (fp32, or bf16), an fp32 sum and one
rounding to x's dtype. There is no alpha and no seed. The kernel skips the
16x16 tiles that ``tile_mask`` clears, and the twin zeroes them, so a test
of the twin against the JAX package also shows that the mask drops no
nonzero. On the card the kernel is a persistent grid whose CTAs take
(128-row block row, 64-column) work items from the operator's work list
(``row_order``, longest rows first), with one producer warp feeding eight
consumer warps through TMA copies and mbarriers (see the source);
``bench/emitted_probe.py`` holds it against ``bsr_grouped_spmm`` and times
the two. Nothing on the model's path calls it, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .block_sparse import BLOCK, TILES, BlockSparseOperator, row_order
from .bsr_spmm import masked_blocks

DTYPES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
PANEL = 128  # C must be a multiple of this (the TPU kernel's column panel)

# Launches of the CUDA kernel per dtype, counted where the wrapper launches
# it (never on the CPU twin path). Readers reset and read them around a run.
LAUNCHES = {name: 0 for name in DTYPES.values()}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library("emitted_spmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.emitted_spmm.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                 p]
    lib.emitted_spmm.restype = ctypes.c_int
    lib.emitted_spmm_info.argtypes = [i] + [ctypes.POINTER(i)] * 6
    lib.emitted_spmm_info.restype = ctypes.c_int
    return lib


def emitted_spmm_reference(bsr: BlockSparseOperator,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: zero the tiles that tile_mask clears, then for
    each of the G slots in order, every row's block of that slot (index
    num_blocks selects a zero block) times the x slab of its column block,
    batched over the rows and added to an fp32 sum; bf16 operands are
    widened to fp32 first (each product of two bf16 values is exact in
    fp32); y is rounded to x's dtype once."""
    _check_dtypes(bsr, x)
    n_rows, g = bsr.g_idx.shape
    c = x.shape[1]
    zero = bsr.blocks.new_zeros((1, BLOCK, BLOCK))
    blocks = torch.cat([masked_blocks(bsr), zero])
    slabs = x.reshape(-1, BLOCK, c)
    bcol = bsr.g_bcol.long().reshape(n_rows, g)
    y = torch.zeros(n_rows, BLOCK, c, dtype=torch.float32, device=x.device)
    for s in range(g):
        y += torch.matmul(blocks[bsr.g_idx[:, s].long()].float(),
                          slabs[bcol[:, s]].float())
    return y.reshape(n_rows * BLOCK, c).to(x.dtype)


def _check_dtypes(bsr: BlockSparseOperator, x: torch.Tensor) -> None:
    if x.dtype not in DTYPES or bsr.blocks.dtype != x.dtype:
        raise TypeError(f"emitted_spmm takes fp32 or bf16 x in the blocks' "
                        f"dtype, got blocks {bsr.blocks.dtype} and x "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[0] != bsr.n_pad_cols or x.shape[1] <= 0 \
            or x.shape[1] % PANEL:
        raise ValueError(f"x must be [n_pad_cols={bsr.n_pad_cols}, C] with C "
                         f"a positive multiple of {PANEL}, got "
                         f"{tuple(x.shape)}")


def work_order(bsr: BlockSparseOperator) -> torch.Tensor:
    """The operator's work list (row blocks, longest first) on its device:
    bsr.row_order, or, for an operator made without one, the same list
    built here from tile_mask (a host copy of the layout)."""
    if bsr.row_order is not None:
        return bsr.row_order
    order = row_order(bsr.tile_mask.cpu().numpy(), bsr.g_idx.cpu().numpy(),
                      bsr.g_bcol.cpu().numpy(), bsr.n_pad_cols // BLOCK)
    return torch.from_numpy(order).to(bsr.g_idx.device)


def _check(name: str, t: torch.Tensor, shape, device, dtype) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def emitted_spmm(bsr: BlockSparseOperator, x: torch.Tensor,
                 ctas_per_sm: int = 0) -> torch.Tensor:
    """y [n_pad, C] = L @ x in x's dtype (fp32 or bf16, the blocks' dtype),
    x [n_pad_cols, C] with C % 128 == 0. A CPU tensor runs the plain twin;
    a CUDA tensor launches the kernel or raises. ctas_per_sm > 0 caps the
    persistent grid's CTAs per SM (0: as many as stay resident)."""
    _check_dtypes(bsr, x)
    if x.device.type == "cpu":
        return emitted_spmm_reference(bsr, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev, dt = x.device, x.dtype
    n_rows, g = bsr.g_idx.shape
    _check("x", x, (bsr.n_pad_cols, x.shape[1]), dev, dt)
    _check("blocks", bsr.blocks, (bsr.num_blocks, BLOCK, BLOCK), dev, dt)
    _check("g_idx", bsr.g_idx, (bsr.n_pad // BLOCK, g), dev, torch.int32)
    _check("g_bcol", bsr.g_bcol, (n_rows * g,), dev, torch.int32)
    _check("tile_mask", bsr.tile_mask, (bsr.num_blocks, TILES), dev,
           torch.uint8)
    order = work_order(bsr)
    _check("row_order", order, (n_rows,), dev, torch.int32)
    y = torch.empty((bsr.n_pad, x.shape[1]), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().emitted_spmm(
            bsr.blocks.data_ptr(), bsr.g_idx.data_ptr(),
            bsr.g_bcol.data_ptr(), bsr.tile_mask.data_ptr(),
            order.data_ptr(), x.data_ptr(), y.data_ptr(),
            bsr.num_blocks, n_rows, g, bsr.n_pad_cols // BLOCK, x.shape[1],
            list(DTYPES).index(dt), int(ctas_per_sm), stream)
    if rc != 0:
        raise RuntimeError(f"emitted_spmm[{DTYPES[dt]}] launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[DTYPES[dt]] += 1
    return y


def kernel_info(dtype: torch.dtype, device="cuda") -> dict:
    """What the compiler and the occupancy API gave the kernel of `dtype`:
    registers per thread, static and dynamic shared memory and local
    (spill) bytes, resident CTAs per SM and the SM count."""
    vals = [ctypes.c_int() for _ in range(6)]
    with torch.cuda.device(device):
        rc = _lib().emitted_spmm_info(list(DTYPES).index(dtype),
                                      *[ctypes.byref(v) for v in vals])
    if rc != 0:
        raise RuntimeError(f"emitted_spmm_info failed: CUDA error {rc}")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes",
            "ctas_per_sm", "sms")
    return dict(zip(keys, (v.value for v in vals)))
