"""Row-grouped block-sparse SpMM: y = alpha * (L @ x) + t_plus - t_prev.

``bsr_grouped_spmm`` launches the hand-written CUDA kernel
(``csrc/bsr_spmm.cu``) for CUDA tensors and runs the plain PyTorch twin
``bsr_grouped_spmm_reference`` for CPU tensors. It replaces the TPU kernels
that meshvae_tpu/ops/pallas_cheb.py ``_grouped_matmul`` launches:

  mode "fp32"   (matmul_precision highest): ``_make_multirow_kernel`` and
                its R=1 case ``_make_grouped_kernel`` — IEEE fp32 products;
  mode "bf16x3" (matmul_precision high): ``_make_multirow_kernel_bf16x3``
                and ``_make_grouped_kernel_bf16x3`` — both operands split
                into a bf16 hi part and a bf16 residual (round to nearest
                even), hi*hi + (hi*lo + lo*hi) accumulated in fp32;
  mode "bf16"   (compute_dtype bfloat16): the same two kernels with bf16
                blocks, x and seeds and a bf16 output (pallas_cheb.py
                ``:682-688``, BF16_STATE) — exact fp32 products of the bf16
                values, fp32 accumulation, alpha and the seeds applied in
                fp32, one round-to-nearest-even to bf16 per output.

It also stands in for the TPU kernels that ``_bsr_matmul_impl`` takes when
a row spans more than 8 column blocks or grouping is off: the column-major
``_make_colmajor_kernel`` (on the rectangular P^T of the wide up-pools,
fp32 or bf16; the pool backward itself runs ops/pool_transpose.py, bit for
bit the same in fp32) and ``_make_colmajor_kernel_bf16x3``, and the
per-block ``_make_spmm_kernel`` / ``_make_spmm_kernel_bf16x3``. The row-
grouped layout keeps any number of slots per row, so one kernel covers
them; tests/test_torch_grad.py and tests/test_torch_bf16.py hold the twin
against each. In bf16 those TPU kernels round their output block after
every slot; this kernel, like ``_make_grouped_kernel``, rounds once.

``t_plus_dot=(gm, wt)`` is the lazy form of t_plus (TPU kernel #4b,
``_seed_dot_fn``): the seed c = gm @ kron(I, wt), the backward's mix
cotangent, is computed inside the kernel in fp32 and added before the one
rounding, so no c_j goes through HBM. Modes fp32 and bf16 take it in the
kernel; mode bf16x3, and any f that does not divide the 128-column panel,
compute c here, round it to the mode's dtype and pass it as t_plus (the
JAX package's eager fallback, pallas_cheb.py:669-677).

The kernel skips every 16x16 tile of a block whose ``tile_mask`` bit is
clear (block_sparse.py), and the twin zeroes those tiles before its
product, so a test of the twin against the JAX package also shows that
the mask drops no nonzero.

The kernel is also the registered operator ``meshvae_torch::bsr_grouped_spmm``
(``bsr_grouped_spmm_op``: the operator's tensors, x, the optional seeds,
n_pad, n_pad_cols, the mode's index and alpha), whose CPU implementation
is the twin and whose CUDA implementation is the launch. ``torch.export``
records that operator where the wrapper is called while exporting
(infer/export.py); outside an export the wrapper launches the kernel
directly and counts the launch (an exported program's launches are counted
by a profiler, by the kernel's name ``bsr_grouped_spmm_kernel``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .block_sparse import BLOCK, TILE, TILES, BlockSparseOperator

MODES = ("fp32", "bf16x3", "bf16")
# storage dtype of blocks, x, seeds and y in each mode
MODE_DTYPE = {"fp32": torch.float32, "bf16x3": torch.float32,
              "bf16": torch.bfloat16}

# Launches of the CUDA kernel per (mode, n_pad, n_pad_cols, C, call kind),
# counted where the wrapper launches it (never on the CPU twin path): the
# kind is "a1" or "a2" (alpha), then " plus", " dot" (the lazy seed) and
# " prev" for the seeds the call takes, e.g. "a2 plus prev". Readers reset
# and read it around a run, or read differences. Inside a CUDA graph the
# wrapper runs once, at capture; train/graphs.py takes that count back and
# adds it at each replay.
LAUNCHES_BY_CALL: dict[tuple[str, int, int, int, str], int] = {}


def launches() -> dict[str, int]:
    """Launches per mode (every mode present)."""
    out = dict.fromkeys(MODES, 0)
    for key, n in LAUNCHES_BY_CALL.items():
        out[key[0]] += n
    return out


def launches_by_shape() -> dict[tuple[str, int, int], int]:
    """Launches per (mode, n_pad, n_pad_cols) of the operator."""
    out: dict[tuple[str, int, int], int] = {}
    for key, n in LAUNCHES_BY_CALL.items():
        out[key[:3]] = out.get(key[:3], 0) + n
    return out


def launches_seed_dot() -> dict[str, int]:
    """The launches per mode that computed the lazy seed in the kernel."""
    out = dict.fromkeys(MODES, 0)
    for key, n in LAUNCHES_BY_CALL.items():
        if " dot" in key[4]:
            out[key[0]] += n
    return out


def reset_launches() -> None:
    LAUNCHES_BY_CALL.clear()


_TILE_COLS = 64  # the kernel's column tile (BN in csrc/bsr_spmm.cu)
COL_PANEL = 128  # callers pad B * F_pad to a multiple of this column panel


def pad_features(b: int, f: int) -> int:
    """Smallest f_pad >= f with b * f_pad a multiple of the column panel."""
    f_pad = f
    while (b * f_pad) % COL_PANEL != 0:
        f_pad += 1
    return f_pad


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded csrc/bsr_spmm.cu library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsr_grouped_spmm.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                     i, i, i, ctypes.c_float, i, p]
    lib.bsr_grouped_spmm.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    from ._build import load_library

    return bind(load_library("bsr_spmm"))


def _split_bf16(t: torch.Tensor):
    """fp32 -> (hi, lo) with hi = bf16(t) and lo = bf16(t - hi), both
    returned as fp32 (round to nearest even, as astype(bfloat16))."""
    hi = t.to(torch.bfloat16).to(torch.float32)
    lo = (t - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def _seed_dot(gm: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """c[r, i*f + o] = sum_e gm[r, i*f + e] wt[e, o], in the operands'
    dtype (a bf16 product accumulates in fp32 and rounds once)."""
    n, c = gm.shape
    f = wt.shape[0]
    return torch.matmul(gm.reshape(n, c // f, f), wt).reshape(n, c)


def _lazy_or_eager(mode: str, t_plus, t_plus_dot):
    """(t_plus, t_plus_dot) as the kernel takes them: the lazy seed stays
    lazy in modes fp32 and bf16 when f divides the column panel; otherwise
    it becomes an eager t_plus in the mode's dtype."""
    if t_plus_dot is None:
        return t_plus, None
    if t_plus is not None:
        raise ValueError("t_plus and t_plus_dot are exclusive")
    gm, wt = t_plus_dot
    f = wt.shape[0]
    if wt.dim() != 2 or wt.shape[1] != f or gm.dim() != 2 or gm.shape[1] % f:
        raise ValueError(f"t_plus_dot takes gm [n_pad, C] and a square wt "
                         f"[f, f] with f | C, got {tuple(gm.shape)} and "
                         f"{tuple(wt.shape)}")
    if mode == "bf16x3" or COL_PANEL % f:
        return _seed_dot(gm, wt).to(MODE_DTYPE[mode]), None
    return None, t_plus_dot


def masked_blocks(bsr: BlockSparseOperator) -> torch.Tensor:
    """bsr.blocks with every 16x16 tile whose tile_mask bit is clear set to
    zero: the operator the kernel multiplies."""
    nb = bsr.num_blocks
    shifts = torch.arange(TILES, device=bsr.tile_mask.device)
    keep = (bsr.tile_mask.long()[..., None] >> shifts) & 1 == 1
    tiles = bsr.blocks.reshape(nb, TILES, TILE, TILES, TILE)
    return torch.where(keep[:, :, None, :, None], tiles,
                       tiles.new_zeros(())).reshape(nb, BLOCK, BLOCK)


def bsr_grouped_spmm_reference(bsr: BlockSparseOperator, x: torch.Tensor,
                               mode: str = "fp32", alpha: float = 1.0,
                               t_plus: torch.Tensor | None = None,
                               t_prev: torch.Tensor | None = None,
                               t_plus_dot: tuple | None = None
                               ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: zero the tiles that tile_mask
    clears, gather the [nR, G, 128, 128] blocks through g_idx (index
    num_blocks selects an appended zero block), one batched fp32 product
    per slot, a sum over slots, then alpha, the seeds and the lazy seed in
    fp32; mode "bf16" widens its bf16 operands to fp32 first (each product
    of two bf16 values is exact in fp32) and rounds the result to bf16
    once."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    t_plus, t_plus_dot = _lazy_or_eager(mode, t_plus, t_plus_dot)
    n_rows, g = bsr.g_idx.shape
    c = x.shape[1]
    zero = bsr.blocks.new_zeros((1, BLOCK, BLOCK))
    lg = torch.cat([masked_blocks(bsr), zero])[bsr.g_idx.long()].float()
    xg = x.reshape(-1, BLOCK, c)[bsr.g_bcol.long()].reshape(
        n_rows, g, BLOCK, c).float()
    if mode == "bf16x3":
        lh, ll = _split_bf16(lg)
        xh, xl = _split_bf16(xg)
        prod = torch.matmul(lh, xh) + (torch.matmul(lh, xl)
                                       + torch.matmul(ll, xh))
    else:
        prod = torch.matmul(lg, xg)
    y = alpha * prod.sum(dim=1).reshape(n_rows * BLOCK, c)
    if t_plus is not None:
        y = y + t_plus.float()
    if t_prev is not None:
        y = y - t_prev.float()
    if t_plus_dot is not None:
        y = y + _seed_dot(t_plus_dot[0].float(), t_plus_dot[1].float())
    return y.to(MODE_DTYPE[mode])


def _check(name: str, t: torch.Tensor, shape, device, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(bsr: BlockSparseOperator, x: torch.Tensor, mode: str,
            alpha: float, t_plus, t_prev, gm, wt) -> torch.Tensor:
    """One launch of the CUDA kernel on checked operands (the seeds as the
    kernel takes them, _lazy_or_eager)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dt = MODE_DTYPE[mode]
    n_rows, g = bsr.g_idx.shape
    c = x.shape[1] if x.dim() == 2 else -1
    if c % _TILE_COLS or c <= 0:
        raise ValueError(f"x must be [n_pad_cols, C] with C a positive "
                         f"multiple of {_TILE_COLS}, got {tuple(x.shape)}")
    dev = x.device
    _check("x", x, (bsr.n_pad_cols, c), dev, dt)
    _check("blocks", bsr.blocks, (bsr.num_blocks, BLOCK, BLOCK), dev, dt)
    _check("g_idx", bsr.g_idx, (bsr.n_pad // BLOCK, g), dev, torch.int32)
    _check("g_bcol", bsr.g_bcol, (n_rows * g,), dev, torch.int32)
    _check("tile_mask", bsr.tile_mask, (bsr.num_blocks, TILES), dev,
           torch.uint8)
    for name, seed in (("t_plus", t_plus), ("t_prev", t_prev), ("gm", gm)):
        if seed is not None:
            _check(name, seed, (bsr.n_pad, c), dev, dt)
    f = 0
    if wt is not None:
        f = wt.shape[0]
        _check("wt", wt, (f, f), dev, dt)
    y = torch.empty((bsr.n_pad, c), dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().bsr_grouped_spmm(
            ptr(bsr.blocks), ptr(bsr.g_idx), ptr(bsr.g_bcol),
            ptr(bsr.tile_mask), ptr(x),
            ptr(t_plus), ptr(t_prev), ptr(gm), ptr(wt), ptr(y),
            bsr.num_blocks, n_rows, g, bsr.n_pad_cols // BLOCK, c, f,
            float(alpha), MODES.index(mode), stream)
    if rc != 0:
        raise RuntimeError(f"bsr_grouped_spmm[{mode}] launch failed: "
                           f"CUDA error {rc}")
    return y


def _operator_of(blocks, g_idx, g_bcol, tile_mask, n_pad: int,
                 n_pad_cols: int) -> BlockSparseOperator:
    """The fields of a BlockSparseOperator that the kernel and the twin
    read, from the registered operator's arguments."""
    return BlockSparseOperator(
        blocks=blocks, block_row=None, block_col=None, g_idx=g_idx,
        g_bcol=g_bcol, n=n_pad, n_pad=n_pad, n_pad_cols=n_pad_cols,
        g_width=g_idx.shape[1], tile_mask=tile_mask)


@torch.library.custom_op("meshvae_torch::bsr_grouped_spmm", mutates_args=(),
                         device_types="cpu")
def bsr_grouped_spmm_op(blocks: torch.Tensor, g_idx: torch.Tensor,
                        g_bcol: torch.Tensor, tile_mask: torch.Tensor,
                        x: torch.Tensor, t_plus: Optional[torch.Tensor],
                        t_prev: Optional[torch.Tensor],
                        gm: Optional[torch.Tensor],
                        wt: Optional[torch.Tensor], n_pad: int,
                        n_pad_cols: int, mode: int,
                        alpha: float) -> torch.Tensor:
    """The registered operator; its CPU implementation is the twin. mode is
    an index into MODES; gm and wt, when given, are the lazy seed
    (t_plus_dot), which the caller has already resolved with
    _lazy_or_eager."""
    bsr = _operator_of(blocks, g_idx, g_bcol, tile_mask, n_pad, n_pad_cols)
    return bsr_grouped_spmm_reference(
        bsr, x, MODES[mode], alpha, t_plus, t_prev,
        None if gm is None else (gm, wt))


@bsr_grouped_spmm_op.register_kernel("cuda")
def _op_cuda(blocks, g_idx, g_bcol, tile_mask, x, t_plus, t_prev, gm, wt,
             n_pad, n_pad_cols, mode, alpha):
    bsr = _operator_of(blocks, g_idx, g_bcol, tile_mask, n_pad, n_pad_cols)
    return _launch(bsr, x, MODES[mode], alpha, t_plus, t_prev, gm, wt)


@bsr_grouped_spmm_op.register_fake
def _op_fake(blocks, g_idx, g_bcol, tile_mask, x, t_plus, t_prev, gm, wt,
             n_pad, n_pad_cols, mode, alpha):
    return x.new_empty((n_pad, x.shape[1]), dtype=MODE_DTYPE[MODES[mode]])


def through_op(bsr: BlockSparseOperator, x: torch.Tensor, mode: str,
               alpha: float = 1.0, t_plus=None, t_prev=None,
               t_plus_dot=None) -> torch.Tensor:
    """bsr_grouped_spmm's arguments as one call of the registered operator
    (what an export records; uncounted)."""
    t_plus, t_plus_dot = _lazy_or_eager(mode, t_plus, t_plus_dot)
    gm, wt = t_plus_dot if t_plus_dot is not None else (None, None)
    return bsr_grouped_spmm_op(
        bsr.blocks, bsr.g_idx, bsr.g_bcol, bsr.tile_mask, x, t_plus, t_prev,
        gm, wt, bsr.n_pad, bsr.n_pad_cols, MODES.index(mode), float(alpha))


def bsr_grouped_spmm(bsr: BlockSparseOperator, x: torch.Tensor,
                     mode: str = "fp32", alpha: float = 1.0,
                     t_plus: torch.Tensor | None = None,
                     t_prev: torch.Tensor | None = None,
                     t_plus_dot: tuple | None = None) -> torch.Tensor:
    """y [n_pad, C] = alpha * (L @ x) + t_plus - t_prev, in the mode's
    dtype (MODE_DTYPE: fp32, or bf16 in mode "bf16"; blocks, x and the
    seeds must have it too).

    x is [n_pad_cols, C]; the seeds, when given, are [n_pad, C].
    t_plus_dot = (gm [n_pad, C], wt [f, f]) replaces t_plus by
    c = gm @ kron(I, wt), f | C (see the module docstring). A CPU tensor
    runs the plain twin; a CUDA tensor launches the kernel (C must be a
    multiple of 64) or raises. While torch.export traces, the call is the
    registered operator instead, which dispatches the same way when the
    exported program runs."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    dt = MODE_DTYPE[mode]
    if bsr.blocks.dtype != dt or x.dtype != dt:
        raise TypeError(f"mode {mode} takes {dt} blocks and x, got "
                        f"{bsr.blocks.dtype} and {x.dtype}")
    if torch.compiler.is_exporting():
        return through_op(bsr, x, mode, alpha, t_plus, t_prev, t_plus_dot)
    if x.device.type == "cpu":
        return bsr_grouped_spmm_reference(bsr, x, mode, alpha, t_plus,
                                          t_prev, t_plus_dot)
    t_plus, t_plus_dot = _lazy_or_eager(mode, t_plus, t_plus_dot)
    gm, wt = t_plus_dot if t_plus_dot is not None else (None, None)
    y = _launch(bsr, x, mode, alpha, t_plus, t_prev, gm, wt)
    kind = f"a{alpha:g}" + "".join(
        f" {name}" for name, seed in (("plus", t_plus), ("dot", gm),
                                      ("prev", t_prev)) if seed is not None)
    key = (mode, bsr.n_pad, bsr.n_pad_cols, x.shape[1], kind)
    LAUNCHES_BY_CALL[key] = LAUNCHES_BY_CALL.get(key, 0) + 1
    return y
