"""The occupied-tile SpMM (``bsr_grouped_spmm``) against the TMA pipeline of
``emitted_spmm`` (TPU kernel #10) and torch.sparse.

    python -m meshvae_tpu_torch.bench.tile_probe [--workloads 5k,20k,80k]
        [--batch-size 32] [--features 16] [--iters 200] [--device cpu]
        [--template-dir DIR] [--cache-dir DIR] [--baseline-csrc DIR]

``bsr_grouped_spmm`` skips the 16 x 16 tiles of each block that its
``tile_mask`` marks empty and runs the rest on the tensor cores (bf16,
bf16x3) or, in fp32, on the CUDA cores in the order of a dense-block
product, through a cp.async ring (the occupied-tile engine,
csrc/tile_engine.cuh); ``emitted_spmm`` runs the same tile products behind
a TMA pipeline. So:

  1. synthetic operators (G = 1..9 with padded slots; a dense block, a
     block with no set bit, empty strips, sparse tiles) at C = 64, 512 and
     2048: each mode against its twin (1e-5 of max |y| in fp32 and bf16x3,
     the bf16 ulp of max |y| in bf16), the lazy seed at f = 8, 16, 32 and
     128 in fp32 and bf16, and fp32 against ``emitted_spmm`` bit for bit;
  2. on a card, the fingerprints of ``bsr_grouped_spmm`` (``fingerprints``:
     a digest of its outputs per mode over fixed inputs) against those
     recorded from the kernel before its engine moved into
     csrc/tile_engine.cuh (FINGERPRINTS): equal means the same bits;
  3. per workload, the level-0 Laplacian of the template's hierarchy
     (factors 4, 4, 4, 4), x [n_pad, B * F] from numpy's default_rng(0):
     its occupancy (blocks, G, density, occupied 64 x 16 chunks and 16 x 16
     tiles), fp32 ``bsr_grouped_spmm`` equal bit for bit to
     ``emitted_spmm``, bf16 within one bf16 ulp (2^-8 max |y|) of its twin;
  4. per workload and dtype (fp32; bf16 at 20k and 80k), per-call times of
     ``bsr_grouped_spmm``, ``emitted_spmm`` and torch.sparse CSR (cuSPARSE,
     a yardstick only), each --iters back-to-back launches behind a sleep
     kernel, median of three, run in turns (A B C C B A) and averaged, with
     two bounds: bytes with the blocks as stored (blocks, indices, x, y)
     and bytes with only the occupied tiles (tiles, tile_mask, indices, x,
     y), each at 3.35 TB/s against 2 operations per nonzero per column at
     the dtype's peak.

--baseline-csrc DIR builds DIR/bsr_spmm.cu (another checkout's
``meshvae_tpu_torch/ops/csrc``) beside this one and, in the same process,
compares the two: their ptxas reports, their fingerprints, and per-call
times at every workload and mode in turns (baseline, this, this,
baseline) with the spread of each pair of turns.

The last line is one JSON report. With --device cpu steps 1 and 3 run the
plain twins (nothing is timed, no kernel launches).
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import statistics

import numpy as np
import torch

from ..device import resolve_device
from ..mesh import load_obj, load_or_build_hierarchy
from ..ops import bsr_spmm
from ..ops import emitted_spmm as em
from ..ops.block_sparse import (BLOCK, TILE, TILES, BlockSparseOperator,
                                tile_mask, to_block_sparse)
from ..ops.bsr_spmm import (MODE_DTYPE, bsr_grouped_spmm,
                            bsr_grouped_spmm_reference)
from ..ops.graph import normalized_neg_adjacency
from ..tools.make_scaled_template import ensure_template

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MODE = {torch.float32: "fp32", torch.bfloat16: "bf16"}
TOL = 1e-5                   # fp32 and bf16x3, of max |y|
ROUNDS = 3
# fingerprints() of bsr_grouped_spmm as built from the sources before its
# engine moved into csrc/tile_engine.cuh (any card of the same
# architecture gives the same digests: fixed inputs, no atomics)
FINGERPRINTS = {"fp32": "7cf70ce0fafd9203", "fp32 lazy": "532b7433f63d4f62",
                "bf16x3": "b9268d1bb1096465", "bf16": "c38701bef98a9f60",
                "bf16 lazy": "bb0948278cd0c223"}
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m meshvae_tpu_torch.bench.tile_probe",
        description="occupied-tile SpMM vs emitted_spmm and torch.sparse")
    ap.add_argument("--workloads", default="5k,20k,80k")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--template-dir", default=os.path.join(REPO, "template"),
                    help="directory of template5k.obj (and the generated "
                         "template20k/80k.obj)")
    ap.add_argument("--cache-dir", default=None,
                    help="hierarchy cache (default ~/.cache/meshvae_tpu_torch)")
    ap.add_argument("--baseline-csrc", default=None,
                    help="another checkout's ops/csrc to build and compare "
                         "bsr_grouped_spmm against")
    return ap.parse_args(argv)


def per_launch_ms(fn, iters: int) -> float:
    """Median over ROUNDS of (CUDA events around `iters` back-to-back
    launches, queued behind a sleep kernel so the device never waits on
    the host) / iters."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def csr_operand(mat, bsr, dev, dtype):
    """The Laplacian padded to [n_pad, n_pad_cols] as torch CSR, in dtype
    when cuSPARSE takes it, else fp32; returns (csr, dtype name)."""
    import scipy.sparse as sp

    mat = sp.csr_matrix(mat)
    indptr = np.concatenate([mat.indptr, np.full(bsr.n_pad - mat.shape[0],
                                                 mat.indptr[-1])])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr.astype(np.int64)),
        torch.from_numpy(mat.indices.astype(np.int64)),
        torch.from_numpy(mat.data.astype(np.float32)),
        size=(bsr.n_pad, bsr.n_pad_cols)).to(dev)
    if dtype == torch.float32:
        return csr, "fp32"
    low = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                  csr.values().to(dtype), size=csr.shape)
    try:
        torch.sparse.mm(low, torch.ones(bsr.n_pad_cols, 128, dtype=dtype,
                                        device=dev))
        torch.cuda.synchronize()
        return low, "bf16"
    except (RuntimeError, NotImplementedError):
        return csr, "fp32"


def occupancy(bsr: BlockSparseOperator) -> dict:
    """Counts of the operator's layout: stored blocks, nonzeros, occupied
    16 x 16 tiles and 64-row x 16-column chunks (a chunk is occupied when
    any of its four tiles is)."""
    mask = bsr.tile_mask.cpu()
    nb = bsr.num_blocks
    halves = mask.reshape(nb, 2, 4).long()
    chunks = (halves[:, :, 0] | halves[:, :, 1] | halves[:, :, 2]
              | halves[:, :, 3])
    return dict(blocks=nb, g=bsr.g_width,
                nnz=int((bsr.blocks != 0).sum()),
                tiles=int(_POPCOUNT[mask.long()].sum()),
                chunks=int(_POPCOUNT[chunks].sum()))


def bounds(bsr: BlockSparseOperator, c: int, dtype, seeds: int = 0,
           occ: dict | None = None) -> dict:
    """Least times of one call with `seeds` [n_pad, c] operands besides x
    and y: stored_ms counts the blocks as stored, bound_ms only the
    occupied tiles and tile_mask (what the kernel must read); both against
    2 operations per nonzero per column at the dtype's peak."""
    occ = occ or occupancy(bsr)
    size = torch.finfo(dtype).bits // 8
    idx = 4 * (bsr.g_idx.numel() + bsr.g_bcol.numel())
    act = size * c * (bsr.n_pad_cols + bsr.n_pad * (1 + seeds))
    stored = size * bsr.blocks.numel() + idx + act
    tiles = size * occ["tiles"] * TILE * TILE + TILES * occ["blocks"] + idx
    ops_ms = 1e3 * 2 * occ["nnz"] * c / PEAK_OPS[dtype]
    bytes_ms = 1e3 * (tiles + act) / HBM_BYTES_PER_S
    return dict(bytes=tiles + act, stored_bytes=stored, ops=2 * occ["nnz"] * c,
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                stored_ms=max(1e3 * stored / HBM_BYTES_PER_S, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def fused_bounds(bsr: BlockSparseOperator, c: int, f_pad: int, f_out: int,
                 mode: str = "fp32", prev: bool = True,
                 occ: dict | None = None) -> dict:
    """Least times of one fused Chebyshev step (TPU kernel #9, fp32
    storage): T_{k-1} read, T_{k-2} read (prev), T_k written, acc
    [n_pad, c / f_pad * f_out] read and written, W_k read, each once, and
    the operator as its occupied tiles with tile_mask and indices
    (bound_ms) or as stored (stored_ms); against the propagation's 2
    operations per nonzero per column and the mix's 2 f_out per T_k
    element (three bf16 products each in bf16x3) at the mode's peak."""
    occ = occ or occupancy(bsr)
    idx = 4 * (bsr.g_idx.numel() + bsr.g_bcol.numel())
    acc = bsr.n_pad * (c // f_pad) * f_out
    act = 4 * (bsr.n_pad_cols * c + bsr.n_pad * c * (2 if prev else 1)
               + 2 * acc + f_pad * f_out)
    tiles = 4 * occ["tiles"] * TILE * TILE + TILES * occ["blocks"] + idx
    stored = 4 * bsr.blocks.numel() + idx + act
    split = 3 if mode == "bf16x3" else 1
    ops = split * 2 * (occ["nnz"] * c + bsr.n_pad * c * f_out)
    peak = PEAK_OPS[torch.bfloat16 if mode == "bf16x3" else torch.float32]
    ops_ms = 1e3 * ops / peak
    bytes_ms = 1e3 * (tiles + act) / HBM_BYTES_PER_S
    return dict(bytes=tiles + act, stored_bytes=stored, ops=ops,
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                stored_ms=max(1e3 * stored / HBM_BYTES_PER_S, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def patterned_operator(g: int, dtype, dev, seed: int,
                       square: bool = False) -> BlockSparseOperator:
    """A random row-grouped operator with G slots per row (a third of them
    padded after the first) over 13 + G row blocks and 11 column blocks
    (as many as the rows when `square`), 17 stored blocks: block 0 dense,
    block 1 all zero (its slots have no set bit), block 2 with every other
    strip empty, the rest ~35% of their tiles occupied at ~10% density."""
    rng = np.random.default_rng(seed)
    nb, n_rows = 17, 13 + g
    ncb = n_rows if square else 11
    vals = 0.1 * rng.standard_normal((nb, TILES, TILE, TILES, TILE))
    keep = rng.random((nb, TILES, 1, TILES, 1)) < 0.35
    keep = keep & (rng.random(vals.shape) < 0.1)
    keep[0] = True
    keep[1] = False
    keep[2, ::2] = False
    blocks = torch.from_numpy((vals * keep).reshape(nb, BLOCK, BLOCK)
                              .astype(np.float32)).to(dtype).to(dev)
    g_idx = rng.integers(0, nb, (n_rows, g)).astype(np.int32)
    g_idx[:, 1:][rng.random((n_rows, g - 1)) < 0.3] = nb
    g_bcol = rng.integers(0, ncb, n_rows * g).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    zero = torch.zeros(nb, dtype=torch.int32, device=dev)
    return BlockSparseOperator(blocks, zero, zero, t(g_idx), t(g_bcol),
                               n_rows * BLOCK, n_rows * BLOCK, ncb * BLOCK, g,
                               tile_mask(blocks))


def ulp_bar(ref: torch.Tensor) -> float:
    """The bf16 ulp of max |ref|, relative to it: a dense random row can
    flip the rounding of an output near max |y| between two fp32 orders."""
    top = ref.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) / top


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in float64 (an error of exactly one
    ulp_bar must not round above it)."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-30)).item()


def synthetic_sweep(dev) -> float:
    """Step 1; returns the worst error as a share of its bar. Raises
    SystemExit on a disagreement."""
    gen = torch.Generator().manual_seed(5)
    worst = 0.0

    def hold(tag, got, want, bar):
        nonlocal worst
        err = rel_err(got, want)
        worst = max(worst, err / bar)
        if not err <= bar:
            raise SystemExit(f"bsr_grouped_spmm disagrees: {tag} {err:.3e} "
                             f"> {bar:.3e}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    for g in range(1, 10):
        for dtype in (torch.float32, torch.bfloat16):
            bsr = patterned_operator(g, dtype, dev, seed=g)
            for c in (64, 512, 2048):
                x = torch.randn(bsr.n_pad_cols, c, generator=gen).to(dtype)
                x = x.to(dev)
                prev = torch.randn(bsr.n_pad, c, generator=gen).to(dtype)
                prev = prev.to(dev)
                modes = (("fp32", "bf16x3") if dtype == torch.float32
                         else ("bf16",))
                for mode in modes:
                    for kw in ({}, {"t_prev": prev}):
                        y = bsr_grouped_spmm(bsr, x, mode, 2.0, **kw)
                        sync()
                        ref = bsr_grouped_spmm_reference(bsr, x, mode, 2.0,
                                                         **kw)
                        bar = ulp_bar(ref) if mode == "bf16" else TOL
                        hold(f"G={g} C={c} {mode} {sorted(kw)}", y, ref, bar)
                if (dtype == torch.float32 and dev.type == "cuda"
                        and c % 128 == 0):  # emitted_spmm's C
                    y = bsr_grouped_spmm(bsr, x, "fp32")
                    z = em.emitted_spmm(bsr, x)
                    sync()
                    if not torch.equal(y, z):
                        raise SystemExit(f"fp32 bsr_grouped_spmm is not bit-"
                                         f"equal to emitted_spmm at G={g} "
                                         f"C={c}")
            c = 512
            x = torch.randn(bsr.n_pad_cols, c, generator=gen).to(dtype)
            x = x.to(dev)
            for f in (8, 16, 32, 128):
                gm = torch.randn(bsr.n_pad, c, generator=gen).to(dtype)
                wt = (0.3 * torch.randn(f, f, generator=gen)).to(dtype)
                dot = (gm.to(dev), wt.to(dev))
                y = bsr_grouped_spmm(bsr, x, MODE[dtype], 1.0, t_plus_dot=dot)
                sync()
                ref = bsr_grouped_spmm_reference(bsr, x, MODE[dtype], 1.0,
                                                 t_plus_dot=dot)
                bar = ulp_bar(ref) if dtype == torch.bfloat16 else TOL
                hold(f"G={g} f={f} {MODE[dtype]} lazy seed", y, ref, bar)
    return worst


def level0(workload: str, args, dev, dtype):
    """(the level-0 Laplacian as a BlockSparseOperator on dev, its scipy
    matrix)."""
    tpath = os.path.join(args.template_dir, f"template{workload}.obj")
    ensure_template(tpath)
    hier = load_or_build_hierarchy(load_obj(tpath), [4, 4, 4, 4],
                                   cache_dir=args.cache_dir)
    mat = normalized_neg_adjacency(hier.adjacency[0])
    return to_block_sparse(mat, dev, dtype=dtype), mat


def in_turns(fns: dict, iters: int, spread: bool = False) -> dict:
    """Per-launch ms of each callable, run in turns A B C C B A; the mean
    of its two turns (with spread, also {key}_spread: |first - second|)."""
    times = {k: [] for k in fns}
    for k in list(fns) + list(reversed(list(fns))):
        times[k].append(per_launch_ms(fns[k], iters))
    out = {k: statistics.mean(v) for k, v in times.items()}
    if spread:
        out.update({f"{k}_spread": abs(v[0] - v[1]) for k, v in times.items()})
    return out


@contextlib.contextmanager
def using_library(lib):
    """bsr_grouped_spmm launches from `lib` (a bound ctypes library) inside
    the block."""
    real = bsr_spmm._lib
    bsr_spmm._lib = lambda: lib
    try:
        yield
    finally:
        bsr_spmm._lib = real


def fingerprints(dev) -> dict:
    """Per mode, the first 16 hex digits of a sha256 over the bytes of
    bsr_grouped_spmm's outputs on fixed inputs (numpy's default_rng): the
    patterned operators G = 1..9 at C = 64 and 512, alpha 2 with and
    without t_prev; and in fp32 and bf16 ("<mode> lazy") the lazy seed at
    f = 16 and 128."""
    out = {}
    for mode, dt in MODE_DTYPE.items():
        plain, lazy = hashlib.sha256(), hashlib.sha256()
        for g in range(1, 10):
            bsr = patterned_operator(g, dt, dev, seed=100 + g)
            rng = np.random.default_rng(g)

            def rand(rows, cols, scale=1.0):
                a = scale * rng.standard_normal((rows, cols))
                return torch.from_numpy(a.astype(np.float32)).to(dt).to(dev)

            def digest(h, y):
                h.update(y.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())

            for c in (64, 512):
                x, prev = rand(bsr.n_pad_cols, c), rand(bsr.n_pad, c)
                digest(plain, bsr_grouped_spmm(bsr, x, mode, 2.0))
                digest(plain, bsr_grouped_spmm(bsr, x, mode, 2.0,
                                               t_prev=prev))
            if mode == "bf16x3":
                continue
            x = rand(bsr.n_pad_cols, 512)
            for f in (16, 128):
                dot = (rand(bsr.n_pad, 512), rand(f, f, 0.3))
                digest(lazy, bsr_grouped_spmm(bsr, x, mode, t_plus_dot=dot))
        out[mode] = plain.hexdigest()[:16]
        if mode != "bf16x3":
            out[f"{mode} lazy"] = lazy.hexdigest()[:16]
    return out


def baseline_ab(args, dev, c: int) -> dict:
    """bsr_grouped_spmm built from args.baseline_csrc against this build:
    ptxas reports, fingerprints, and per-call ms at each workload's level 0
    in every mode, in turns (baseline, this, this, baseline)."""
    from ..ops import _build

    logs = _build.build_libraries(["bsr_spmm"])
    logs_base = _build.build_libraries(["bsr_spmm"], args.baseline_csrc)
    base = bsr_spmm.bind(_build.load_library("bsr_spmm", args.baseline_csrc))
    this = bsr_spmm._lib()
    report = {"ptxas": {"this": _build.ptxas_table(logs.get("bsr_spmm", "")),
                        "baseline": _build.ptxas_table(
                            logs_base.get("bsr_spmm", ""))}}
    for side, rows in report["ptxas"].items():
        for row in rows:
            print(f"ptxas {side}: {row}", flush=True)
    with using_library(base):
        fp_base = fingerprints(dev)
    fp_this = fingerprints(dev)
    report["fingerprints"] = {"baseline": fp_base, "this": fp_this,
                              "equal": fp_base == fp_this}
    print(f"fingerprints baseline {fp_base}", flush=True)
    print(f"fingerprints this     {fp_this}; equal {fp_base == fp_this}",
          flush=True)

    def timed(lib, fn):
        def run():
            with using_library(lib):
                return per_launch_ms(fn, args.iters)
        return run

    report["times"] = {}
    for workload in args.workloads.split(","):
        rng = np.random.default_rng(0)
        for dtype in (torch.float32, torch.bfloat16):
            bsr, _ = level0(workload, args, dev, dtype)
            x = torch.from_numpy(rng.standard_normal(
                (bsr.n_pad_cols, c)).astype(np.float32)).to(dtype).to(dev)
            prev = torch.from_numpy(rng.standard_normal(
                (bsr.n_pad, c)).astype(np.float32)).to(dtype).to(dev)
            modes = ("fp32", "bf16x3") if dtype == torch.float32 else ("bf16",)
            for mode in modes:
                fn = lambda: bsr_grouped_spmm(bsr, x, mode, 2.0, t_prev=prev)
                turns = [timed(base, fn)(), timed(this, fn)(),
                         timed(this, fn)(), timed(base, fn)()]
                row = dict(baseline_ms=(turns[0] + turns[3]) / 2,
                           this_ms=(turns[1] + turns[2]) / 2,
                           baseline_spread=abs(turns[0] - turns[3]),
                           this_spread=abs(turns[1] - turns[2]), turns=turns)
                report["times"][f"{workload} {mode}"] = row
                print(f"{workload} L0 {mode} C={c} (alpha 2, t_prev): "
                      f"baseline {row['baseline_ms']:.4f} ms (spread "
                      f"{row['baseline_spread']:.4f}), this "
                      f"{row['this_ms']:.4f} ms (spread "
                      f"{row['this_spread']:.4f}); turns "
                      + ", ".join(f"{t:.4f}" for t in turns), flush=True)
    return report


def main(argv=None) -> dict:
    """Run the probe; returns the report (also printed as the last line).
    A disagreement exits non-zero before any timing."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    c = args.batch_size * args.features
    worst = synthetic_sweep(dev)
    print(f"synthetic G = 1..9, C = 64/512/2048, three modes and the lazy "
          f"seed at f = 8..128: worst {worst:.3f} of the bar; fp32 bit-equal "
          f"to emitted_spmm", flush=True)
    report = {"c": c, "synthetic_worst_of_bar": worst, "workloads": {}}
    if dev.type == "cuda":
        if args.baseline_csrc:
            report["baseline"] = baseline_ab(args, dev, c)
        fp = fingerprints(dev)
        report["fingerprints"] = fp
        print(f"fingerprints {fp}; recorded {FINGERPRINTS or 'none'}",
              flush=True)
        if FINGERPRINTS and fp != FINGERPRINTS:
            raise SystemExit(f"bsr_grouped_spmm's bits changed: "
                             f"fingerprints {fp}, recorded {FINGERPRINTS}")
    for workload in args.workloads.split(","):
        rng = np.random.default_rng(0)
        entry = {}
        for dtype in (torch.float32, torch.bfloat16):
            bsr, mat = level0(workload, args, dev, dtype)
            occ = occupancy(bsr)
            x = torch.from_numpy(rng.standard_normal(
                (bsr.n_pad_cols, c)).astype(np.float32)).to(dtype).to(dev)
            y = bsr_grouped_spmm(bsr, x, MODE[dtype])
            if dtype == torch.float32:
                z = em.emitted_spmm(bsr, x)
                # the twins on the CPU sum in another order than the kernels
                equal = ((y == z).float().mean().item() if dev.type == "cuda"
                         else float(rel_err(y, z) <= TOL))
                print(f"{workload} L0: {occ['blocks']} blocks, G "
                      f"{occ['g']}, density "
                      f"{occ['nnz'] / (occ['blocks'] * BLOCK * BLOCK):.4f}, "
                      f"occupied 64x16 chunks "
                      f"{occ['chunks'] / (occ['blocks'] * 16):.3f}, 16x16 "
                      f"tiles {occ['tiles'] / (occ['blocks'] * 64):.3f}; "
                      f"fp32 bit-equal to emitted_spmm {equal:.5f}",
                      flush=True)
                if equal != 1.0:
                    raise SystemExit(f"fp32 bsr_grouped_spmm is not bit-"
                                     f"equal to emitted_spmm at {workload}")
                entry.update(occ, bit_equal=equal)
            else:
                ref = bsr_grouped_spmm_reference(bsr, x, "bf16")
                err = rel_err(y, ref)
                print(f"{workload} L0 bf16: {err:.3e} of max|y| from its twin "
                      f"(bar {2.0 ** -8:.3e})", flush=True)
                if not err <= 2.0 ** -8:
                    raise SystemExit(f"bf16 bsr_grouped_spmm disagrees with "
                                     f"its twin at {workload}: {err:.3e}")
                entry["bf16_err"] = err
            if dev.type == "cpu" or (dtype == torch.bfloat16
                                     and workload == "5k"):
                continue
            csr, lib_dtype = csr_operand(mat, bsr, dev, dtype)
            lib_x = x if lib_dtype == "bf16" or dtype == torch.float32 \
                else x.float()
            ms = in_turns({
                "grouped": lambda: bsr_grouped_spmm(bsr, x, MODE[dtype]),
                "emitted": lambda: em.emitted_spmm(bsr, x),
                "library": lambda: torch.sparse.mm(csr, lib_x)}, args.iters)
            b = bounds(bsr, c, dtype, occ=occ)
            print(f"{workload} L0 {MODE[dtype]} C={c}: grouped "
                  f"{ms['grouped']:.4f} ms, emitted {ms['emitted']:.4f} ms, "
                  f"torch.sparse[{lib_dtype}] {ms['library']:.4f} ms; bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}, occupied tiles"
                  f"), {b['stored_ms']:.4f} ms with the blocks as stored",
                  flush=True)
            entry[MODE[dtype]] = dict(grouped_ms=ms["grouped"],
                                      emitted_ms=ms["emitted"],
                                      library_ms=ms["library"],
                                      library_dtype=lib_dtype, **b)
        report["workloads"][workload] = entry
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
