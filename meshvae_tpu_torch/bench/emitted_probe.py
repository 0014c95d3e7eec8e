"""Persistent cp.async-ring SpMM against the row-grouped kernel: the port's
counterpart of benchmarks/emitted_probe.py.

    python -m meshvae_tpu_torch.bench.emitted_probe [--workload 5k|20k|80k]
        [--batch-size 32] [--features 16]
        [--compute-dtype bfloat16|float32] [--iters 300] [--device cpu]
        [--template-dir DIR] [--cache-dir DIR]

It builds the workload's template (a missing template20k/80k.obj is
generated beside template5k.obj), its hierarchy (factors 4, 4, 4, 4) and
the operators in the compute dtype, takes the level-0 Laplacian and x
[n_pad, B * F] from numpy's default_rng(0), and asks whether one
persistent grid walking work items through a cp.async ring
(``ops.emitted_spmm``, TPU kernel #10) beats ``bsr_grouped_spmm``'s one CTA
per output tile on the same operator:

  1. before any timing, the two are held together: 1e-5 of max |y| in
     fp32, one bf16 ulp (2^-8 max |y|) in bf16 (both sum in fp32 and round
     once);
  2. each of the emitted kernel (at the occupancy API's resident CTAs per
     SM, and at 1 and 2 per SM), ``bsr_grouped_spmm`` and torch.sparse CSR
     (cuSPARSE, a yardstick only) runs --iters back-to-back launches on a
     device held busy by a sleep kernel, between two CUDA events, three
     times; the median per launch is reported;
  3. the bound: the bytes a call must move (blocks, g_idx, g_bcol, x once,
     y) at 3.35 TB/s against 2 operations per nonzero per column at the
     dtype's peak (fp32 on the CUDA cores, 67 TFLOP/s; bf16 989 TFLOP/s);
     also the byte bound with x counted as the work items read it (each
     64-row half reads every real slot's 128-row slab).

The last line is one JSON report. With --device cpu the plain twins are
held together and the last line is {"ok": true, "device": "cpu", ...};
nothing is timed and no kernel is launched.

The JAX probe's --group-rows, --group-max-operands and --group-budget set
TPU tuning knobs of its grouped kernel (GROUP_ROWS, _GROUP_MAX_OPERANDS,
GROUP_VMEM_BUDGET), which are not part of the operator contract; the
port's kernels pick their own tiles, so this probe has no such options.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics

import numpy as np
import torch

from ..device import resolve_device
from ..mesh import load_obj, load_or_build_hierarchy
from ..models.operators import build_operators
from ..ops import emitted_spmm as em
from ..ops.block_sparse import BLOCK
from ..ops.bsr_spmm import bsr_grouped_spmm
from ..ops.graph import normalized_neg_adjacency
from ..tools.make_scaled_template import ensure_template

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
BAR = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
MODE = {torch.float32: "fp32", torch.bfloat16: "bf16"}
ROUNDS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m meshvae_tpu_torch.bench.emitted_probe",
        description="emitted (persistent cp.async ring) vs grouped SpMM")
    ap.add_argument("--workload", default="80k", choices=["5k", "20k", "80k"])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--template-dir", default=os.path.join(REPO, "template"),
                    help="directory of template5k.obj (and the generated "
                         "template20k/80k.obj)")
    ap.add_argument("--cache-dir", default=None,
                    help="hierarchy cache (default ~/.cache/meshvae_tpu_torch)")
    return ap.parse_args(argv)


def level0(args, dev, dtype):
    """(the level-0 Laplacian as a BlockSparseOperator on dev, its scipy
    matrix)."""
    tname = f"template{args.workload}.obj"
    tpath = os.path.join(args.template_dir, tname)
    ensure_template(tpath)
    hier = load_or_build_hierarchy(load_obj(tpath), [4, 4, 4, 4],
                                   cache_dir=args.cache_dir)
    ops = build_operators(hier, dev, cheb_method="pallas", bsr_min_n=1024,
                          dtype=dtype)
    return ops.lap[0].bsr, normalized_neg_adjacency(hier.adjacency[0])


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


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


def bounds(bsr, c: int, dtype) -> dict:
    """The least time for the call: bytes (blocks, g_idx, g_bcol, x once, y)
    over the HBM rate against 2 operations per nonzero per column over the
    dtype's peak; and the byte bound with x as the work items read it."""
    size = torch.finfo(dtype).bits // 8
    idx = 4 * (bsr.g_idx.numel() + bsr.g_bcol.numel())
    blocks = size * bsr.blocks.numel()
    x_once = size * bsr.n_pad_cols * c
    y = size * bsr.n_pad * c
    real_slots = int((bsr.g_idx < bsr.num_blocks).sum())
    x_items = size * (BLOCK // 64) * real_slots * BLOCK * c
    nnz = int((bsr.blocks != 0).sum())
    bytes_ms = 1e3 * (blocks + idx + x_once + y) / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * nnz * c / PEAK_OPS[dtype]
    return dict(nnz=nnz, bytes=blocks + idx + x_once + y, ops=2 * nnz * c,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_ms_x_per_item=1e3 * (blocks + idx + x_items + y)
                / HBM_BYTES_PER_S)


def main(argv=None) -> dict:
    """Run the probe; returns the report (also printed as the last line).
    A disagreement between the two kernels exits non-zero before any
    timing."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        args.compute_dtype]
    bsr, mat = level0(args, dev, dtype)
    c = args.batch_size * args.features
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((bsr.n_pad_cols, c)).astype(
        np.float32)).to(dtype).to(dev)
    print(f"level-0: n_pad {bsr.n_pad} rows {bsr.n_pad // BLOCK} "
          f"g {bsr.g_width} c {c}", flush=True)

    # numerical cross-check before any timing
    before = dict(em.LAUNCHES)  # the caller owns the counts; never reset
    y_emit = em.emitted_spmm(bsr, x)
    y_grp = bsr_grouped_spmm(bsr, x, MODE[dtype])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = rel_err(y_emit, y_grp)
    equal = (y_emit == y_grp).float().mean().item()
    print(f"emitted-vs-grouped rel err: {err:.2e} (bar {BAR[dtype]:.1e}), "
          f"bit-equal share {equal:.5f}", flush=True)
    if not err <= BAR[dtype]:
        raise SystemExit(f"emitted_spmm disagrees with bsr_grouped_spmm: "
                         f"{err:.3e} > {BAR[dtype]:.1e}")
    report = {"workload": args.workload, "dtype": args.compute_dtype,
              "c": c, "g": bsr.g_width, "rows": bsr.n_pad // BLOCK,
              "n_pad": bsr.n_pad, "blocks": bsr.num_blocks,
              "max_err_rel": err, "bit_equal": equal}
    if dev.type == "cpu":
        print(json.dumps({"ok": True, "device": "cpu", **report}))
        return report

    info = em.kernel_info(dtype, dev)
    print(f"emitted kernel: {info['registers']} registers, "
          f"{info['dynamic_smem']} B dynamic + {info['static_smem']} B "
          f"static shared memory, {info['local_bytes']} B local, "
          f"{info['ctas_per_sm']} CTAs/SM resident x {info['sms']} SMs",
          flush=True)
    csr, lib_dtype = csr_operand(mat, bsr, dev, dtype)
    lib_x = x if lib_dtype == "bf16" or dtype == torch.float32 else x.float()
    per_sm = sorted({1, 2, info["ctas_per_sm"]} & set(
        range(1, info["ctas_per_sm"] + 1)))
    items = (bsr.n_pad // 64) * (c // 64)  # 64 x 64 output tiles
    emitted = {n: per_launch_ms(lambda: em.emitted_spmm(bsr, x, n),
                                args.iters) for n in per_sm}
    for n, ms in emitted.items():
        print(f"emitted ({n} CTAs/SM, grid {min(n * info['sms'], items)} "
              f"for {items} work items): {ms:.4f} ms", flush=True)
    grouped = per_launch_ms(lambda: bsr_grouped_spmm(bsr, x, MODE[dtype]),
                            args.iters)
    print(f"grouped (one CTA per tile, {items} CTAs): {grouped:.4f} ms",
          flush=True)
    library = per_launch_ms(lambda: torch.sparse.mm(csr, lib_x), args.iters)
    print(f"torch.sparse CSR [{lib_dtype}]: {library:.4f} ms", flush=True)
    bound = bounds(bsr, c, dtype)
    print(f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['bytes'] / 1e6:.1f} MB at 3.35 TB/s, {bound['ops'] / 1e9:.2f}"
          f" GFLOP); with x as the work items read it "
          f"{bound['bound_ms_x_per_item']:.4f} ms", flush=True)
    report.update(
        emitted_ms=emitted[info["ctas_per_sm"]],
        emitted_ms_by_ctas_per_sm={str(n): v for n, v in emitted.items()},
        grouped_ms=grouped, library_ms=library, library_dtype=lib_dtype,
        kernel=info, iters=args.iters, **bound,
        launches={k: v - before[k] for k, v in em.LAUNCHES.items()})
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
