"""The TMA-pipelined persistent SpMM against the row-grouped kernel: the
port's counterpart of benchmarks/emitted_probe.py.

    python -m meshvae_tpu_torch.bench.emitted_probe [--workload 5k|20k|80k]
        [--batch-size 32] [--features 16]
        [--compute-dtype bfloat16|float32] [--iters 300] [--device cpu]
        [--template-dir DIR] [--cache-dir DIR]

It builds the workload's template (a missing template20k/80k.obj is
generated beside template5k.obj), its hierarchy (factors 4, 4, 4, 4) and
the operators in the compute dtype, takes the level-0 Laplacian and x
[n_pad, B * F] from numpy's default_rng(0), and asks whether an explicitly
emitted copy pipeline (``ops.emitted_spmm``, TPU kernel #10: a persistent
grid, TMA copies completing on mbarriers, whole-row-block work items taken
longest first) beats ``bsr_grouped_spmm``'s one CTA per (64-row half,
64-column tile) with its cp.async ring, at the same tile products:

  1. before any timing, the two are held together: on a card in fp32 bit
     for bit, in bf16 both within one bf16 ulp (2^-8 max |y|) of the twin
     (the bit-equal share with bsr_grouped_spmm is printed); on the CPU the
     twins within 1e-5 (fp32) or one bf16 ulp of max |y|;
  2. each of the emitted kernel (at the occupancy API's resident CTAs per
     SM, and at 1 and 2 per SM), ``bsr_grouped_spmm`` and torch.sparse CSR
     (cuSPARSE, a yardstick only) runs --iters back-to-back launches on a
     device held busy by a sleep kernel, between two CUDA events, three
     times (median per launch), in turns A B C D E E D C B A, and the two
     turns are averaged;
  3. the work list's shape: occupied k chunks per row block (max, mean,
     min; ``block_sparse.row_chunks``), which sets the longest item;
  4. two bounds, each bytes at 3.35 TB/s against 2 operations per
     nonzero per column at the dtype's peak (fp32 on the CUDA cores, 67
     TFLOP/s; bf16 989 TFLOP/s): x once, y, indices and the occupied 16 x
     16 tiles with tile_mask (bound_ms), or the blocks as stored
     (stored_ms).

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

import numpy as np
import torch

from ..device import resolve_device
from ..mesh import load_obj, load_or_build_hierarchy
from ..models.operators import build_operators
from ..ops import emitted_spmm as em
from ..ops.block_sparse import BLOCK, row_chunks
from ..ops.bsr_spmm import bsr_grouped_spmm
from ..ops.graph import normalized_neg_adjacency
from ..tools.make_scaled_template import ensure_template
from .tile_probe import (bounds, csr_operand, in_turns, occupancy, rel_err,
                         ulp_bar)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BAR = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
MODE = {torch.float32: "fp32", torch.bfloat16: "bf16"}


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
    chunks = row_chunks(bsr.tile_mask.cpu().numpy(), bsr.g_idx.cpu().numpy(),
                        bsr.g_bcol.cpu().numpy(), bsr.n_pad_cols // BLOCK)
    print(f"work list: {len(chunks)} rows x {c // 64} column tiles, "
          f"occupied k chunks per row max {chunks.max()}, mean "
          f"{chunks.mean():.2f}, min {chunks.min()}", flush=True)

    # numerical cross-check before any timing
    before = dict(em.LAUNCHES)  # the caller owns the counts; never reset
    y_emit = em.emitted_spmm(bsr, x)
    y_grp = bsr_grouped_spmm(bsr, x, MODE[dtype])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    twin = em.emitted_spmm_reference(bsr, x)
    err = rel_err(y_emit, y_grp)
    err_twin = rel_err(y_emit, twin)
    equal = (y_emit == y_grp).float().mean().item()
    bar = ulp_bar(twin) if dtype == torch.bfloat16 else BAR[dtype]
    print(f"emitted vs grouped rel err {err:.2e}, bit-equal share "
          f"{equal:.5f}; vs twin {err_twin:.2e} (bar {bar:.2e})", flush=True)
    if dev.type == "cuda" and dtype == torch.float32 and equal != 1.0:
        raise SystemExit(f"fp32 emitted_spmm is not bit-equal to "
                         f"bsr_grouped_spmm: share {equal}")
    if not (err_twin <= bar and err <= max(bar, BAR[dtype])):
        raise SystemExit(f"emitted_spmm disagrees: {err_twin:.3e} from the "
                         f"twin, {err:.3e} from bsr_grouped_spmm")
    report = {"workload": args.workload, "dtype": args.compute_dtype,
              "c": c, "g": bsr.g_width, "rows": bsr.n_pad // BLOCK,
              "n_pad": bsr.n_pad, "blocks": bsr.num_blocks,
              "max_err_rel": err, "max_err_twin_rel": err_twin,
              "bit_equal": equal, "row_chunks_max": int(chunks.max()),
              "row_chunks_mean": float(chunks.mean())}
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
    items = (bsr.n_pad // BLOCK) * (c // 64)  # (row block, 64 columns)
    fns = {f"emitted {n}": (lambda n=n: em.emitted_spmm(bsr, x, n))
           for n in per_sm}
    fns["grouped"] = lambda: bsr_grouped_spmm(bsr, x, MODE[dtype])
    fns["library"] = lambda: torch.sparse.mm(csr, lib_x)
    ms = in_turns(fns, args.iters, spread=True)
    emitted = {n: ms[f"emitted {n}"] for n in per_sm}
    for n, t in emitted.items():
        print(f"emitted ({n} CTAs/SM, grid {min(n * info['sms'], items)} "
              f"for {items} work items): {t:.4f} ms (spread "
              f"{ms[f'emitted {n}_spread']:.4f})", flush=True)
    print(f"grouped (one CTA per 64-row half and 64 columns, "
          f"{2 * items} CTAs): {ms['grouped']:.4f} ms (spread "
          f"{ms['grouped_spread']:.4f})", flush=True)
    print(f"torch.sparse CSR [{lib_dtype}]: {ms['library']:.4f} ms",
          flush=True)
    occ = occupancy(bsr)
    bound = bounds(bsr, c, dtype, occ=occ)
    print(f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['bytes'] / 1e6:.1f} MB at 3.35 TB/s with the occupied "
          f"tiles, {bound['ops'] / 1e9:.2f} GFLOP); with the blocks as "
          f"stored {bound['stored_ms']:.4f} ms", flush=True)
    report.update(
        emitted_ms=emitted[info["ctas_per_sm"]],
        emitted_ms_by_ctas_per_sm={str(n): v for n, v in emitted.items()},
        grouped_ms=ms["grouped"], library_ms=ms["library"],
        library_dtype=lib_dtype, spread_ms={k[:-7]: v for k, v in ms.items()
                                            if k.endswith("_spread")},
        kernel=info, iters=args.iters, occupancy=occ, **bound,
        launches={k: v - before[k] for k, v in em.LAUNCHES.items()})
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
