#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (meshvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one block of output lines each; any failed check exits non-zero:

 1. device  the card's name and power limit (nvidia-smi).
 2. build   compile the three CUDA kernels from ops/csrc (nvcc, sm_90a, one
            process per source, started together) and print the build
            seconds and ptxas' register/shared-memory report.
 3. kernel  bsr_grouped_spmm in both modes (fp32, bf16x3) against its plain
            PyTorch twin on the card: the real template5k level-0 and
            level-1 Laplacians at C in {128, 256, 512}, alpha in {1, 2}, with
            and without t_prev; at C = 256 also the backward's calls (t_plus
            alone, t_plus and t_prev together); and the pool backward's
            rectangular P^T of up-pools 0-2 at their training widths
            ([1280, 5120] and [384, 1280] at C = 256, [128, 384] at C = 512;
            the first also at C = 512 with every seed case). Fails above
            1e-5 of max |y|. The lazy seed (#4b, t_plus_dot) in mode fp32 at
            the config-1 L0/L1 Laplacians (C = 256, f = 16; L0 also at
            f = 128) and the scaled20k L0/L1 (C = 1024, f = 16), alpha 1
            and 2, with and without t_prev; each call must take the kernel's
            lazy seed (LAUNCHES_SEED_DOT).
 4. serve   BASELINE config 1 at full width (template5k, factors 4,4,4,4,
            K=6, filters 16/16/16/32/32, hidden 512, latent 16, batch 16,
            cheb_method pallas), weights from a fixed seed. The main path:
            a MeshServer at matmul_precision high, then one at highest, each
            answering three request lines through serve_forever (one .obj,
            a directory of 20 meshes = two chunks of 16, one bad path). The
            kernel launch counts are reset just before and read just after;
            each mode must launch 20 times per serving step. Then one step
            on the card and on the CPU with the same weights and inputs:
            pred equal, recon_orig within 1e-4 of the mesh scale, err_mean
            within 1e-4 of the mesh scale.
 5. times   CUDA events, median of 25 runs, L2 warm (as inside the steps).
            Device time alone (a sleep kernel holds the device while the
            host queues the runs): the kernel at every shape and call kind
            of the serving step and of the train step, in the modes each
            runs, its plain twin, and torch.sparse on the same operator in
            CSR form (the library yardstick, never used by the port), each
            beside its bound; then the sums per step. The serving step in
            meshes/sec at B=16 as served (the device waits on the host; 50
            runs); its peak device memory; a torch.profiler window for the
            device busy time per step and the idle share.
 6. train   the training main path at config 1, full width, dropout 0.2,
            lr 1e-3, weight decay 5e-4: a MeshDataset over 40 synthetic
            meshes (3 batches of 16 per epoch, the last padded), three
            train_epochs at high and three at highest from the same seeded
            weights, the counts reset just before and read just after each.
            Per train step: 35 bf16x3 + 3 fp32 launches at high, 38 fp32 at
            highest, and each of the three P^T once. The eval loss of a fixed
            batch must fall; evaluate() gives finite averages and a
            sex-change rate in [0, 1]. One deterministic step (no dropout,
            z = mu) on the card and on the CPU from the same weights: loss
            within 1e-5 relative, every gradient within 1e-4 (highest) or
            1e-3 (high) of its layer's max|g|, and params after the card's
            Adam steps from the CPU's gradients within 1e-2 lr of the CPU's
            (the whole step's param delta is printed, not held). The lazy
            seed: one deterministic step at highest with
            FUSED_SEED_DOT on, on the card and on the CPU (gradients within
            1e-4 of the layer's max|g|), and on the card flag on vs flag off
            (the same bar); exactly 15 lazy-seed launches in the 38. Then
            the host-paced train step (CUDA events, median of 25), its peak
            memory, and its device busy time and idle share.

 7. scaled80k bf16 training, the main path of files/scaled80k.cfg
            (compute_dtype bfloat16, K=10, batch 32, full width) at its real
            80k-vertex scale: template80k.obj generated in a temporary
            directory from template5k, its hierarchy built through the
            native library (seconds, levels), bf16 operators (n_pad, blocks
            and G per operator; these also feed phase 3's bf16 checks), 40
            synthetic 80k meshes, then train/driver.run() with the config's
            own settings and overrides only for paths, folds 2 and epoch 2,
            train and test, the counts reset just before and read just
            after: 139 bf16 launches per train step, 144 per eval step, each
            P^T once per train step, no fp32 or bf16x3. History, checkpoint
            reload, finite test averages and a sex-change rate in [0, 1] are
            checked; the loss of a fixed batch falls over 5 more steps. Then
            the host-paced train step (CUDA events, median of 25),
            meshes/sec, peak memory, device busy and idle share. Three
            train steps with FUSED_SEED_DOT on: 139 launches per step, 45
            of them lazy-seed (enc_1, enc_2, dec_0, dec_2, dec_3 x 9), and
            the host-paced step beside the flag-off one. Then the bf16
            kernel per 80k shape and call kind (the lazy-seed kinds too)
            beside its twin, torch.sparse on the same operator in CSR (bf16
            where cuSPARSE takes it; plus the c_j GEMM for a lazy seed) and
            its byte bound.
 8. bf16    card vs CPU in bf16 at config-1 size (template5k, K=6, B=16,
            compute_dtype bfloat16): one deterministic train step (no
            dropout, z = mu) and one eval step from the same weights; the
            card's loss, every gradient, the eval loss and recon_orig must
            be closer to the CPU's bf16 result than that is to the CPU's
            fp32 result (up to one bf16 ulp of the layer's scale).
 9. scaled20k fp32 training with the lazy seed, the main path of
            files/scaled20k.cfg (fp32 at highest, K=10, batch 64, full
            width): template20k.obj generated in the temporary directory,
            its hierarchy through the native library, fp32 operators (the
            block-sparse L0-L2 and P^T also feed phase 3), 40 synthetic 20k
            meshes through train/driver.run() with FUSED_SEED_DOT on and
            overrides for paths, folds 2 and epoch 2, the counts reset just
            before and read just after: per train step 54 forward + 45
            backward Laplacian calls + one P^T per block-sparse up-pool,
            36 of them lazy-seed; 108 per eval step; history, finite test
            averages, the loss of a fixed batch falling. Then the
            host-paced step flag on and off (CUDA events, median of 25),
            meshes/sec, peak memory beside the saved bases' size, device
            busy and idle share, and the fp32 kernel per 20k shape and call
            kind beside its twin, torch.sparse and its byte bound.
10. fused   TPU kernel #9 (cheb_conv_fused, ops/csrc/cheb_fused.cu) on the
            card against its plain twin at the config-1 L0 and L1 convs
            (B=16, 16->16, K=6) and the scaled20k L0 conv (B=64, 16->16,
            K=10): each step (T_k and acc within 1e-5 of their max), the
            conv forward (1e-5) and its gradients (1e-4 of max|g|), at
            highest (and the bf16x3 split at config-1 L1). The launch count
            is reset before and read after these runs. Then the step per
            call beside its twin, torch.sparse + torch.matmul and its
            bound, and the conv forward and forward+backward beside the
            main-path cheb_conv_bsr at the same shapes.
11. emitted TPU kernel #10 (emitted_spmm, ops/csrc/emitted_spmm.cu: a
            persistent grid walking work items through a cp.async ring) on
            the card against its plain twin and against bsr_grouped_spmm:
            fp32 at the config-1 L0 (C = 256) and the scaled20k L0 (C =
            1024), bf16 at the scaled80k L0 (B = 32, f = 16, C = 512; phase
            7's operators), 1e-5 of max |y| in fp32 and one bf16 ulp; and on
            synthetic operators with G = 1..9 and padded slots at 1, 2 and
            the resident CTAs per SM (bit-equal to bsr_grouped_spmm
            expected; the bf16 twin held to the ulp of max |y| itself,
            since a dense random block row cancels more than a
            Laplacian's). Then its path, the probe
            (bench/emitted_probe.py main) at --workload 80k (bf16) and
            --workload 20k --compute-dtype float32, the launch counts reset
            just before and read just after: emitted, grouped, torch.sparse
            and bound ms, the kernel's registers and shared memory; and the
            twin's time at the probe's shapes.
12. infer   the batch-inference entry point at config 1: 32 synthetic
            meshes, a checkpoint_1.pt of the seeded weights and their
            norm.npz; ``python -m meshvae_tpu_torch.infer``'s main on the
            card (counts reset just before, read just after: 20 launches
            per batch of 16, bf16x3 at high, fp32 at highest) and with
            --device cpu: pred.json equal, inference.json's errors and
            every sex_change/ .obj within 1e-4 of the mesh scale; then the
            warm card pass in meshes/sec with and without --no-meshes
            (through run_inference, the device pass alone, the whole CLI).

Phase 3 also holds the bf16 mode on the card at every 80k Laplacian (its C
values, alpha 1 and 2, no seed, t_prev, t_plus, both) and the four P^T:
max |kernel - twin| <= 2^-8 max |twin| (one bf16 ulp: both round once),
and prints the share of bit-equal outputs.

The line before the last is {"kernels": [...]}: per serving step (the two
bsr_grouped_spmm[mode] entries, summed over the step's 20 calls), per
config-1 train step (the Laplacian calls in each mode, the
column-major-class P^T of up-pools 0-1 and the grouped P^T of up-pool 2),
per 80k bf16 train step (the Laplacian calls, #3b; the P^T of up-pool 0,
which the JAX package runs per block, #5; those of up-pools 1-3, which it
runs column-major, #7), the bf16x3 P^T at phase 3's shapes (#8, and #6 at
the both-seed shape where the JAX package runs per block), per scaled20k
train step (the plain Laplacian calls, the lazy-seed calls #4b in fp32,
the P^T), the lazy-seed calls of an 80k bf16 step with the flag on (#4b in
bf16), the fused step (#9) per scaled20k L0 conv forward, the inference
CLI's calls per batch (the serving step's shapes), and emitted_spmm (#10)
per call at the probe's two shapes, with the launches of the main-path
runs (the probe runs for #10). The last line is {"ok": true, ...}.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = 1e-5       # max |kernel - twin| / max |twin|
TOL_BF16 = 2.0 ** -8    # the same in bf16: one ulp, both round once
MODES = ("fp32", "bf16x3")  # the kernel's modes on fp32 operators
SEED_DOT_KINDS = ("a1 dot", "a2 dot", "a1 dot prev", "a2 dot prev")
TOL_STEP = 1e-4         # card vs CPU step, relative to the mesh scale
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_OPS = {"fp32": 67e12,  # fp32 FMA outside the tensor cores
            "bf16x3": 989e12,  # bf16 operands, dense tensor-core rate
            "bf16": 989e12}
RUNS = 25
BATCH = 16
LAUNCHES_PER_STEP = 20  # 4 block-sparse convs x (K - 1) at K = 6
TRAIN_MESHES = 40       # 3 batches of 16 per epoch, the last one padded
TRAIN_EPOCHS = 3
# per train step: 4 block-sparse convs x 5 forward calls, 3 x 5 backward
# (cheb_enc_0's input is data), and the pool backward P^T of up-pools 0-2
TRAIN_LAP_LAUNCHES = 35
TRAIN_POOL_LAUNCHES = 3
SOURCE = "meshvae_tpu_torch/ops/csrc/bsr_spmm.cu"
SOURCE_FUSED = "meshvae_tpu_torch/ops/csrc/cheb_fused.cu"
SOURCE_EMITTED = "meshvae_tpu_torch/ops/csrc/emitted_spmm.cu"
REPLACES = {"fp32": "meshvae_tpu/ops/pallas_cheb.py:434",
            "bf16x3": "meshvae_tpu/ops/pallas_cheb.py:462",
            "colmajor": "meshvae_tpu/ops/pallas_cheb.py:208",
            "grouped": "meshvae_tpu/ops/pallas_cheb.py:395",
            "perblock": "meshvae_tpu/ops/pallas_cheb.py:180",
            "seed_dot": "meshvae_tpu/ops/pallas_cheb.py:161",
            "perblock_bf16x3": "meshvae_tpu/ops/pallas_cheb.py:329",
            "colmajor_bf16x3": "meshvae_tpu/ops/pallas_cheb.py:234",
            "fused": "meshvae_tpu/ops/pallas_fused.py:51",
            "emitted": "benchmarks/emitted_probe.py:45"}
# config 1 at highest with FUSED_SEED_DOT: the square block-sparse convs
# are cheb_enc_1 (L1), cheb_dec_2 (L1) and cheb_dec_3 (L0), 16 -> 16 at
# f_pad 16; each backward runs K - 1 = 5 lazy-seed calls
CONFIG1_SEED_DOT = 15
# files/scaled80k.cfg: B = 32, K = 10 at every level
SCALED_CFG = os.path.join("files", "scaled80k.cfg")
SCALED_LEVELS = [79968, 19992, 4998, 1250, 313]
SCALED_BATCH = 32
SCALED_MESHES = 40      # per fold: 14 train (1 step), 6 valid, 20 test
SCALED_TRAIN_LAUNCHES = 139  # 8 convs x 9 forward, 7 x 9 backward, 4 P^T
SCALED_EVAL_LAUNCHES = 144   # 72 forward + the counterfactual's 36 + 36
# with FUSED_SEED_DOT: the square mixes cheb_enc_1 (L1), cheb_enc_2 (L2),
# cheb_dec_0 (L3, 32 -> 32), cheb_dec_2 (L1) and cheb_dec_3 (L0) x 9;
# cheb_enc_3 (16 -> 32) and cheb_dec_1 (32 -> 16) stay eager
SCALED_SEED_DOT = 45
FLAG_STEPS = 3
# files/scaled20k.cfg: fp32 at highest, B = 64, K = 10; levels 0-2 are
# block-sparse (bsr_min_n 1024), 3-4 dense
SCALED20_CFG = os.path.join("files", "scaled20k.cfg")
SCALED20_LEVELS = [19992, 4998, 1250, 313, 79]
SCALED20_BATCH = 64
SCALED20_MESHES = 40    # per fold: 14 train (1 step), 6 valid, 20 test
# per train step: cheb_enc_0-2 and cheb_dec_1-3 x 9 forward; the same but
# cheb_enc_0 (input is data) x 9 backward; plus each block-sparse P^T
SCALED20_FWD, SCALED20_BWD = 54, 45
SCALED20_EVAL = 108      # 54 forward + the counterfactual's 27 + 27
# square 16 -> 16 mixes: cheb_enc_1, cheb_enc_2, cheb_dec_2, cheb_dec_3 x 9;
# cheb_dec_1 (32 -> 16) stays eager
SCALED20_SEED_DOT = 36


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def time_ms(torch, fn, runs=RUNS, warmup=3, backlog=True):
    """Median milliseconds between CUDA events around fn(), over `runs`.

    backlog=True first queues a ~50 ms sleep kernel, so the host has queued
    every run before the device reaches the first one: the events then time
    device work alone (for a few launches per run only: the launch queue is
    finite). backlog=False lets the device wait on the host, as it does
    while serving."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    if backlog:
        torch.cuda._sleep(100_000_000)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def phase_device(torch):
    say("== phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    import numpy
    import scipy

    say(f"torch {torch.__version__} cuda {torch.version.cuda}, numpy "
        f"{numpy.__version__}, scipy {scipy.__version__}, "
        f"{torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    say("== phase 2: build")
    from meshvae_tpu_torch.ops import _build

    names = ["bsr_spmm", "cheb_fused", "emitted_spmm"]
    t0 = time.perf_counter()
    logs = _build.build_libraries(names)
    for name in names:
        _build.load_library(name)
    say(f"build_sec {time.perf_counter() - t0:.2f} "
        f"({'compiled ' + ', '.join(logs) if logs else 'already built'})")
    for name in names:
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say(f"  ptxas[{name}]: {line.strip()}")
    from meshvae_tpu_torch import native

    path, secs = native.build()
    native.library()
    say(f"native host library {os.path.basename(path)}: build_sec "
        f"{secs:.2f} ({'compiled' if secs else 'already built'})")


def _seed_args(kind: str, seeds: dict) -> tuple:
    """(alpha, kwargs) of one call kind: "a1" or "a2" (alpha 1 or 2), then
    the seeds it adds, "plus" (t_plus), "dot" (the lazy seed t_plus_dot =
    (gm, wt)) and "prev" (t_prev)."""
    alpha = 2.0 if kind.startswith("a2") else 1.0
    kw = {}
    if "plus" in kind:
        kw["t_plus"] = seeds["t_plus"]
    if "dot" in kind:
        kw["t_plus_dot"] = (seeds["gm"], seeds["wt"])
    if "prev" in kind:
        kw["t_prev"] = seeds["t_prev"]
    return alpha, kw


def _seeds(torch, bsr, c, gen, dev, dtype=None, f=16):
    """Random seeds of one shape: t_plus, t_prev and gm [n_pad, c], and a
    [f, f] wt (scaled 0.3, so the lazy seed is of the seeds' size)."""
    dtype = dtype or torch.float32
    out = {k: torch.randn(bsr.n_pad, c, device=dev, generator=gen).to(dtype)
           for k in ("t_plus", "t_prev", "gm")}
    out["wt"] = (0.3 * torch.randn(f, f, device=dev, generator=gen)).to(dtype)
    return out


def _hold(torch, bsr, x, mode, kind, seeds, bar, tag):
    """One kernel call against its twin; with a lazy seed, the call must
    have taken the kernel's (LAUNCHES_SEED_DOT). Returns (abs, rel) err."""
    from meshvae_tpu_torch.ops import bsr_spmm

    alpha, kw = _seed_args(kind, seeds)
    before = dict(bsr_spmm.LAUNCHES_SEED_DOT)
    y = bsr_spmm.bsr_grouped_spmm(bsr, x, mode, alpha, **kw)
    torch.cuda.synchronize()
    ref = bsr_spmm.bsr_grouped_spmm_reference(bsr, x, mode, alpha, **kw)
    lazy = bsr_spmm.LAUNCHES_SEED_DOT[mode] - before[mode]
    if lazy != ("dot" in kind):
        fail(f"{tag}: {lazy} lazy-seed launches, expected "
             f"{int('dot' in kind)}")
    if y.dtype != ref.dtype:
        fail(f"{tag}: kernel returned {y.dtype}, twin {ref.dtype}")
    err_abs = (y.float() - ref.float()).abs().max().item()
    err = err_abs / ref.float().abs().max().item()
    say(f"  {tag}: max_err/max|y| {err:.3e} (bar {bar:.0e})"
        + (f", bit-equal {(y == ref).float().mean().item():.5f}"
           if y.dtype == torch.bfloat16 else ""))
    if not err <= bar:
        fail(f"kernel disagrees with its twin: {tag} {err:.3e} > {bar:.3e}")
    return err_abs, err


def phase_kernel(torch, ops, ops20, dev):
    """The kernel against its twin at every shape and call kind the serving
    and training paths give it, and the lazy seed at the config-1 and
    scaled20k shapes. Returns the worst absolute error per entry group:
    "fp32" and "bf16x3" over the Laplacian cases, "pool" over the fp32 P^T
    cases, "pool_bf16x3" over the bf16x3 P^T cases, "seed_fp32" over the
    lazy-seed cases."""
    say("== phase 3: kernel vs plain twin on the card")
    from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    gen = torch.Generator(device=dev).manual_seed(0)
    t_bsr = [p.t_bsr for p in ops.up]
    if [t is not None for t in t_bsr] != [True, True, True, False]:
        fail("config 1 should give up-pools 0-2 a block-sparse P^T and "
             "up-pool 3 gathers")
    fwd = ("a1", "a2 prev", "a1 prev", "a2")
    bwd = ("a2 plus", "a2 plus prev", "a1 plus prev")
    cases = [("L0", ops.lap[0].bsr, c, fwd) for c in (128, 512)]
    cases += [("L1", ops.lap[1].bsr, c, fwd) for c in (128, 512)]
    cases += [(name, ops.lap[i].bsr, 256, fwd + bwd)
              for i, name in enumerate(("L0", "L1"))]
    cases += [("P0T", t_bsr[0], 256, ("a1",)),
              ("P0T", t_bsr[0], 512, fwd + ("a2 plus prev",)),
              ("P1T", t_bsr[1], 256, ("a1",)), ("P2T", t_bsr[2], 512, ("a1",))]
    worst = {m: 0.0 for m in MODES}
    worst_abs = {"fp32": 0.0, "bf16x3": 0.0, "pool": 0.0,
                 "pool_bf16x3": 0.0, "seed_fp32": 0.0}
    described = set()
    for name, bsr, c, kinds in cases:
        if name not in described:
            described.add(name)
            say(f"{name}: n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
                f"{bsr.num_blocks} blocks, G {bsr.g_width}, padded slots "
                f"{int((bsr.g_idx == bsr.num_blocks).sum())}")
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen)
        seeds = {k: torch.randn(bsr.n_pad, c, device=dev, generator=gen)
                 for k in ("t_plus", "t_prev")}
        for mode in MODES:
            for kind in kinds:
                alpha, kw = _seed_args(kind, seeds)
                y = bsr_grouped_spmm(bsr, x, mode, alpha, **kw)
                torch.cuda.synchronize()
                ref = bsr_grouped_spmm_reference(bsr, x, mode, alpha, **kw)
                err_abs = (y - ref).abs().max().item()
                err = err_abs / ref.abs().max().item()
                worst[mode] = max(worst[mode], err)
                group = (("pool" if mode == "fp32" else "pool_bf16x3")
                         if name.startswith("P") else mode)
                worst_abs[group] = max(worst_abs[group], err_abs)
                tag = f"{name} C={c} {mode} {kind}"
                say(f"  {tag}: max_err/max|y| {err:.3e}")
                if not err <= TOL_KERNEL:
                    fail(f"kernel disagrees with its twin: {tag} "
                         f"{err:.3e} > {TOL_KERNEL}")
    # the lazy seed (#4b) in mode fp32, where the backward takes it
    dot_cases = [("L0", ops.lap[0].bsr, 256, 16),
                 ("L1", ops.lap[1].bsr, 256, 16),
                 ("L0", ops.lap[0].bsr, 256, 128)]
    dot_cases += [(f"20k L{i}", ops20.lap[i].bsr, 1024, 16) for i in (0, 1)]
    seed_worst = 0.0
    for name, bsr, c, f in dot_cases:
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen)
        seeds = _seeds(torch, bsr, c, gen, dev, f=f)
        for kind in SEED_DOT_KINDS:
            err_abs, err = _hold(torch, bsr, x, "fp32", kind, seeds,
                                 TOL_KERNEL, f"{name} C={c} f={f} fp32 {kind}")
            worst_abs["seed_fp32"] = max(worst_abs["seed_fp32"], err_abs)
            seed_worst = max(seed_worst, err)
    say("checked kernels: " + ", ".join(
        f"bsr_grouped_spmm[{m}] (worst {worst[m]:.2e} of max|y|)"
        for m in MODES) + f", its lazy seed in fp32 (worst {seed_worst:.2e})")
    return worst_abs


def config_1(tmp: str) -> dict:
    from meshvae_tpu_torch.config import default_config

    config = default_config()
    config.update({
        "template": os.path.join(ROOT, "template", "template5k.obj"),
        "downsampling_factors": [4, 4, 4, 4],
        "num_conv_filters": [16, 16, 16, 32, 32],
        "polygon_order": [6, 6, 6, 6, 6],
        "num_hidden": 512,
        "num_style": 16,
        "batch_size": BATCH,
        "cheb_method": "pallas",
        "matmul_precision": "high",
        "hierarchy_cache_dir": os.path.join(tmp, "cache"),
    })
    return config


def _check_lines(lines, single, many):
    """Three requests: one mesh, a directory of 20, a bad path."""
    results = [l for l in lines if "file" in l]
    done = [l["done"] for l in lines if "done" in l]
    errors = [l for l in lines if "error" in l]
    if len(lines) != 24 or done != [1, 20] or len(errors) != 1:
        fail(f"unexpected serve output: {len(lines)} lines, done {done}, "
             f"{len(errors)} error lines")
    names = [r["file"] for r in results]
    if names != [os.path.basename(single)] + sorted(
            os.path.basename(p) for p in many):
        fail(f"serve answered the wrong files: {names[:3]} ...")
    for r in results:
        e = r["reconstruction_error"]
        if r["sex"] not in (0, 1) or not (0 <= e["mean"] <= e["max"]
                                          < float("inf")):
            fail(f"bad result line {r}")


def setup_config_1(torch, dev, tmp):
    """Config-1 operators, the model at both precisions (same weights), the
    synthetic requests, and per-vertex normalisation statistics of the
    requests' aligned meshes (what a training run's norm.npz holds)."""
    import numpy as np

    from meshvae_tpu_torch.data.synthetic import generate_synthetic_dataset
    from meshvae_tpu_torch.infer.serve import build_model_and_ops
    from meshvae_tpu_torch.mesh.io import TriMesh, load_obj
    from meshvae_tpu_torch.mesh.procrustes import procrustes_align
    from meshvae_tpu_torch.models import MeshVAE

    t0 = time.perf_counter()
    model_high, ops, hier, _ = build_model_and_ops(
        config_1(tmp), dev, generator=torch.Generator().manual_seed(1234))
    say(f"config 1: hierarchy {hier.levels}, operators + model in "
        f"{time.perf_counter() - t0:.1f}s; block-sparse levels "
        f"{[i for i, op in enumerate(ops.lap) if op.bsr is not None]}")
    model_highest = MeshVAE(dataclasses.replace(model_high.cfg,
                                                precision="highest"))
    model_highest.load_state_dict(model_high.state_dict())
    models = {"high": model_high, "highest": model_highest.to(dev).eval()}

    tmpl = TriMesh(hier.vertices[0], hier.faces[0])
    many_dir = os.path.join(tmp, "requests")
    generate_synthetic_dataset(tmpl, many_dir, n_samples=20, seed=7)
    single_dir = os.path.join(tmp, "single")
    single = os.path.join(single_dir, generate_synthetic_dataset(
        tmpl, single_dir, n_samples=1, seed=8)[0])
    aligned = np.stack([
        procrustes_align(tmpl.v, load_obj(os.path.join(many_dir, f)).v)[0]
        for f in sorted(os.listdir(many_dir))])
    norm = (aligned.mean(axis=0).astype(np.float32),
            aligned.std(axis=0).astype(np.float32))
    return models, ops, hier, tmpl, single, many_dir, norm


def phase_serve(torch, dev, servers, models, ops, hier, single, many_dir,
                tmp):
    say("== phase 4: serve (config 1, template5k, batch 16)")
    import io

    import numpy as np

    from meshvae_tpu_torch.infer.driver import InferenceEngine
    from meshvae_tpu_torch.models import MeshVAE, build_operators
    from meshvae_tpu_torch.ops import bsr_spmm

    many = [os.path.join(many_dir, f) for f in os.listdir(many_dir)]
    for p, server in servers.items():
        say(f"warmup[{p}] {server.warmup():.2f}s")
    request = f"{single}\n{many_dir}\n{os.path.join(tmp, 'missing.obj')}\n"
    # --- the main path: counts reset just before, read just after -------
    bsr_spmm.reset_launches()
    outs = {}
    for p, server in servers.items():
        fout = io.StringIO()
        server.serve_forever(io.StringIO(request), fout)
        outs[p] = fout.getvalue()
    launches = dict(bsr_spmm.LAUNCHES)
    # --------------------------------------------------------------------
    for p, text in outs.items():
        lines = [json.loads(l) for l in text.splitlines()]
        _check_lines(lines, single, many)
        secs = [l["sec"] for l in lines if "done" in l]
        say(f"serve[{p}]: {len(lines)} lines; request seconds {secs} "
            f"(1 mesh, 20 meshes; incl. OBJ parse, Procrustes, mesh writes)")
        say(f"  first answer {lines[0]}")
        say(f"  error answer {[l for l in lines if 'error' in l][0]}")
    steps = 3  # one chunk + two chunks per server
    say(f"main-path launches {launches} (expected "
        f"{steps * LAUNCHES_PER_STEP} per mode)")
    for mode, count in launches.items():
        want = steps * LAUNCHES_PER_STEP if mode in MODES else 0
        if count != want:
            fail(f"bsr_grouped_spmm[{mode}] launched {count} times on the "
                 f"main path, expected {want}")

    # --- card vs CPU on the same weights and inputs ---------------------
    server = servers["high"]
    host = server.preprocess(sorted(many)[:BATCH])
    batch_cpu = {"x": torch.from_numpy(host["x"].astype(np.float32)),
                 **{k: torch.from_numpy(host[k])
                    for k in ("r", "s", "m", "original")}}
    batch_dev = {k: v.to(dev) for k, v in batch_cpu.items()}
    ops_cpu = build_operators(hier, "cpu", cheb_method="pallas")
    mean, std = torch.from_numpy(server.mean), torch.from_numpy(server.std)
    scale = float(np.abs(host["original"]).max())
    n = hier.levels[0]
    for p, m in models.items():
        m_cpu = MeshVAE(m.cfg)
        m_cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        m_cpu.eval()
        got = InferenceEngine(m, ops).step(batch_dev, mean.to(dev),
                                           std.to(dev))
        want = InferenceEngine(m_cpu, ops_cpu).step(batch_cpu, mean, std)
        if not all(bool(torch.isfinite(v).all()) for v in got.values()
                   if v.is_floating_point()):
            fail(f"non-finite outputs on the card at {p}")
        if tuple(got["recon_orig"].shape) != (BATCH, n, 3):
            fail(f"recon_orig shape {tuple(got['recon_orig'].shape)}")
        pred_eq = bool((got["pred"].cpu() == want["pred"]).all())
        d = {k: (got[k].cpu() - want[k]).abs().max().item()
             for k in ("recon_orig", "oppo_orig", "err_mean", "err_max")}
        say(f"card vs cpu [{p}]: pred equal {pred_eq}, max deltas "
            + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
            + f" (mesh scale {scale:.1f}, bar {TOL_STEP * scale:.3e})")
        if not pred_eq:
            fail(f"pred differs between the card and the CPU at {p}")
        for k in ("recon_orig", "err_mean"):
            if not d[k] <= TOL_STEP * scale:
                fail(f"{k} differs by {d[k]:.3e} > {TOL_STEP * scale:.3e} "
                     f"at {p}")
    return launches, host


def _csr(torch, mat, n_pad, n_pad_cols, dev):
    """mat (scipy, n x m) padded to [n_pad, n_pad_cols] as a torch CSR
    tensor."""
    import scipy.sparse as sp

    mat = sp.csr_matrix(mat)
    n = mat.shape[0]
    indptr = list(mat.indptr) + [mat.indptr[-1]] * (n_pad - n)
    return torch.sparse_csr_tensor(
        torch.tensor(indptr, dtype=torch.int64),
        torch.from_numpy(mat.indices.astype("int64")),
        torch.from_numpy(mat.data.astype("float32")),
        size=(n_pad, n_pad_cols), check_invariants=True).to(dev)


def _library_call(torch, csr, x, kind, alpha, kw):
    """The torch.sparse (cuSPARSE) yardstick of one call kind: one call,
    or two where the kernel folds both seeds (addmm, then sub_); a lazy
    seed adds the cuBLAS GEMM that computes c_j first."""
    if "dot" in kind:
        gm, wt = kw["t_plus_dot"]
        n, c = gm.shape
        f = wt.shape[0]
        seed = torch.matmul(gm.reshape(n, c // f, f), wt).reshape(n, c)
        kw = dict(kw, t_plus=seed)
        kind = kind.replace("dot", "plus")
    if "plus" in kind:
        y = torch.addmm(kw["t_plus"], csr, x, alpha=alpha)
        return y.sub_(kw["t_prev"]) if "prev" in kind else y
    if "prev" in kind:
        return torch.addmm(kw["t_prev"], csr, x, beta=-1.0, alpha=alpha)
    return torch.sparse.mm(csr, x)


def _time_kind(torch, bsr, csr, c, kind, modes, gen, dev, f=16):
    """Kernel, twin and library times of one call kind at one shape, with
    its bound: bytes (blocks, g_idx, g_bcol, x, seeds, y, each once; a lazy
    seed's gm counts as one seed) over the HBM rate against the operations
    the data needs (2 per nonzero per column, 6 in bf16x3, plus 2 f per
    output for a lazy seed) over the peak rate of their type."""
    from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen)
    seeds = _seeds(torch, bsr, c, gen, dev, f=f)
    alpha, kw = _seed_args(kind, seeds)
    lib_ms = time_ms(torch, lambda: _library_call(torch, csr, x, kind, alpha,
                                                  kw))
    want = bsr_grouped_spmm_reference(bsr, x, "fp32", alpha, **kw)
    lib_err = ((_library_call(torch, csr, x, kind, alpha, kw) - want)
               .abs().max() / want.abs().max()).item()
    act = 4 * c * (bsr.n_pad_cols + bsr.n_pad * (1 + len(kw)))
    blk_bytes = 4 * (bsr.blocks.numel() + bsr.g_idx.numel()
                     + bsr.g_bcol.numel())
    nnz = int((bsr.blocks != 0).sum())
    nnz_bytes = 8 * nnz + 4 * (bsr.n_pad + 1)  # CSR value + col, row ptr
    out = {}
    for mode in modes:
        k_ms = time_ms(torch, lambda: bsr_grouped_spmm(bsr, x, mode, alpha,
                                                       **kw))
        p_ms = time_ms(torch, lambda: bsr_grouped_spmm_reference(
            bsr, x, mode, alpha, **kw))
        ops_n = ((6 if mode == "bf16x3" else 2) * nnz * c
                 + (2 * f * bsr.n_pad * c if "dot" in kind else 0))
        bytes_ms = 1e3 * (blk_bytes + act) / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops_n / PEAK_OPS[mode]
        bound_nnz = 1e3 * max((nnz_bytes + act) / HBM_BYTES_PER_S,
                              ops_n / PEAK_OPS[mode])
        out[mode] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                         bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                         ops_ms=ops_ms)
        say(f"  {c=} {mode} {kind}: kernel {1e3 * k_ms:.1f} us, twin "
            f"{1e3 * p_ms:.1f} us, torch.sparse {1e3 * lib_ms:.1f} us (rel "
            f"err {lib_err:.1e}), bound {1e3 * max(bytes_ms, ops_ms):.2f} us "
            f"(bytes; {1e3 * bound_nnz:.2f} us with CSR storage)")
        out[mode]["row"] = dict(
            n_pad=bsr.n_pad, n_pad_cols=bsr.n_pad_cols, C=c,
            blocks=bsr.num_blocks, nnz=nnz, mode=mode, kind=kind,
            kernel_us=1e3 * k_ms, plain_us=1e3 * p_ms,
            library_us=1e3 * lib_ms, library_rel_err=lib_err,
            bound_us=1e3 * max(bytes_ms, ops_ms), bound_nnz_us=1e3 * bound_nnz,
            bytes=blk_bytes + act, ops=ops_n)
    return out


# calls per step at config 1 (K = 6), by (label, operand, C, kind counts).
# Serving: per conv one alpha-1 call and four seeded ones; the decoder runs
# at 2B (the counterfactual rides along), hence C = 512 there.
SERVE_CALLS = [("enc L0", "L0", 128, {"a1": 1, "a2 prev": 4}),
               ("enc L1", "L1", 256, {"a1": 1, "a2 prev": 4}),
               ("dec L1", "L1", 512, {"a1": 1, "a2 prev": 4}),
               ("dec L0", "L0", 512, {"a1": 1, "a2 prev": 4})]
# Training at B: the same forward per conv; the backward of a conv whose
# input needs a gradient (all but cheb_enc_0) runs the reverse recurrence
# as one t_plus call, three with both seeds and the final alpha-1 call.
_BWD = {"a2 plus": 1, "a2 plus prev": 3, "a1 plus prev": 1}
TRAIN_CALLS = {
    "lap": [("enc L0", "L0", 128, {"a1": 1, "a2 prev": 4}),
            ("dec L0", "L0", 256, {"a1": 1, "a2 prev": 4, **_BWD}),
            ("enc+dec L1", "L1", 256,
             {k: 2 * v for k, v in {"a1": 1, "a2 prev": 4, **_BWD}.items()})],
    "pool_colmajor": [("up-pool 0 P^T", "P0T", 256, {"a1": 1}),
                      ("up-pool 1 P^T", "P1T", 256, {"a1": 1})],
    "pool_grouped": [("up-pool 2 P^T", "P2T", 512, {"a1": 1})],
}


def _per_step(torch, calls, operands, modes, gen, dev, rows):
    """Sums over one step's calls: per mode, ms / plain_ms / library_ms /
    bound_ms and the bytes and operations parts of the bound."""
    acc = {m: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bytes_ms", "ops_ms"), 0.0) for m in modes}
    for label, key, c, kinds in calls:
        bsr, csr = operands[key]
        say(f" {label} ({key}, n_pad {bsr.n_pad} x {bsr.n_pad_cols}):")
        for kind, count in kinds.items():
            got = _time_kind(torch, bsr, csr, c, kind, modes, gen, dev)
            for mode in modes:
                for k in acc[mode]:
                    acc[mode][k] += count * got[mode][k]
                rows.append(dict(got[mode]["row"], shape=label, per_step=count))
    return acc


def _bound_by(entry: dict) -> str:
    return "bytes" if entry["bytes_ms"] >= entry["ops_ms"] else "operations"


def _profile(torch, fn, label, step_ms, n=5, batch=BATCH):
    """torch.profiler over n runs of fn: device busy time per run, the idle
    share against step_ms, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / n
    # device-side kernel events only: an aten op's entry repeats its
    # kernels, and a user annotation (Optimizer.step#Adam.step) spans them
    kern = []
    for evt in prof.key_averages():
        if ("CUDA" not in str(getattr(evt, "device_type", ""))
                or getattr(evt, "is_user_annotation", False)):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            kern.append((dev_us / n, evt.key))
    kern.sort(reverse=True)
    busy = sum(t for t, _ in kern)
    if not busy:
        say(f"profile [{label}]: no device time recorded (not measured)")
        return None
    say(f"profile [{label}]: device busy {busy:.0f} us/step "
        f"({batch / busy * 1e6:.1f} meshes/sec of device time); idle share "
        f"{1 - busy / (1e3 * step_ms):.2f} of the unprofiled step "
        f"({1e3 * step_ms:.0f} us; {wall_us:.0f} us/step under the profiler)")
    for t, name in kern[:8]:
        say(f"  {t:8.1f} us/step  {name[:90]}")
    return busy


def phase_times(torch, servers, ops, hier, dev, host):
    """Per-call times at every shape and call kind of the serving step and
    the train step, summed per step; the serving step itself."""
    say("== phase 5: times (median of %d, CUDA events)" % RUNS)
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    gen = torch.Generator(device=dev).manual_seed(1)
    operands = {}
    for i in (0, 1):
        bsr = ops.lap[i].bsr
        operands[f"L{i}"] = (bsr, _csr(torch, normalized_neg_adjacency(
            hier.adjacency[i]), bsr.n_pad, bsr.n_pad_cols, dev))
    for i in (0, 1, 2):
        bsr = ops.up[i].t_bsr
        operands[f"P{i}T"] = (bsr, _csr(torch, hier.upsample[i].T,
                                        bsr.n_pad, bsr.n_pad_cols, dev))
    rows = []
    say("serving step, per call:")
    per_step = {f"serve_{m}": acc for m, acc in _per_step(
        torch, SERVE_CALLS, operands, MODES, gen, dev, rows).items()}
    say("train step, per call:")
    for name, calls in TRAIN_CALLS.items():
        modes = MODES if name == "lap" else ("fp32",)  # P^T runs fp32 only
        for m, acc in _per_step(torch, calls, operands, modes, gen, dev,
                                rows).items():
            per_step[f"train_{name}_{m}" if name == "lap"
                     else f"train_{name}"] = acc
    say("bf16x3 P^T at phase 3's shapes (off the train path, which pins the "
        "pool backward to fp32): the JAX package's column-major #8, and its "
        "per-block #6 where both seeds shrink the resident panel:")
    for name, calls in (
            ("pool_bf16x3_colmajor", [("up-pool 0 P^T", "P0T", 256, {"a1": 1}),
                                      ("up-pool 1 P^T", "P1T", 256,
                                       {"a1": 1})]),
            ("pool_bf16x3_perblock", [("up-pool 0 P^T", "P0T", 512,
                                       {"a2 plus prev": 1})])):
        per_step[name] = _per_step(torch, calls, operands, ("bf16x3",), gen,
                                   dev, rows)["bf16x3"]
    say("shape_rows " + json.dumps(rows))
    for name, acc in per_step.items():
        say(f"per step {name}: kernel {acc['ms']:.3f} ms, twin "
            f"{acc['plain_ms']:.3f} ms, torch.sparse {acc['library_ms']:.3f}"
            f" ms, bound {acc['bound_ms']:.3f} ms ({_bound_by(acc)})")

    # --- the serving step, device side, B = 16 --------------------------
    batch = {"x": torch.from_numpy(host["x"]).to(dev),
             **{k: torch.from_numpy(host[k]).to(dev) for k in ("r", "s", "m")}}
    step_ms = {}
    for p, server in servers.items():
        ms = time_ms(torch, lambda: server.serve_step(batch), runs=2 * RUNS,
                     backlog=False)
        step_ms[p] = ms
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        server.serve_step(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        mode = "bf16x3" if p == "high" else "fp32"
        say(f"serving step [{p}]: {ms:.3f} ms, {BATCH / ms * 1e3:.1f} "
            f"meshes/sec at B={BATCH} as served; kernel share "
            f"{per_step[f'serve_{mode}']['ms'] / ms:.2f};"
            f" peak memory {peak / 2**20:.1f} MiB, of which the step's own "
            f"{(peak - base) / 2**20:.1f} MiB ({(peak - base) / peak:.2f})")
    _profile(torch, lambda: servers["high"].serve_step(batch), "serve high",
             step_ms["high"])
    return per_step


def _layer_scale(named: dict, name: str) -> float:
    """max |g| over a layer's weight and bias: a bias gradient can cancel
    to far below its layer's terms (the 2-class classifier bias), where
    float32 rounding of the terms sets its error."""
    layer = name.rsplit(".", 1)[0]
    return max(v.abs().max().item() for k, v in named.items()
               if k.rsplit(".", 1)[0] == layer)


def phase_train(torch, dev, models, ops, hier, tmpl, tmp):
    """The training main path: config 1 at full width, a MeshDataset over
    synthetic meshes, TRAIN_EPOCHS train_epochs at each precision with the
    launch counts reset just before and read just after; then the loss of
    a fixed batch, evaluate(), card vs CPU on one deterministic step, and
    the train step's time, peak memory and device busy share."""
    say(f"== phase 6: train (config 1, {TRAIN_MESHES} synthetic meshes, "
        f"batch {BATCH}, {TRAIN_EPOCHS} epochs per precision)")
    import numpy as np

    from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                        generate_synthetic_dataset,
                                        list_meshes)
    from meshvae_tpu_torch.models import MeshVAE, build_operators
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train import Trainer

    config = config_1(tmp)
    data_dir = os.path.join(tmp, "train_data")
    generate_synthetic_dataset(tmpl, data_dir, n_samples=TRAIN_MESHES,
                               seed=11)
    dcfg = {"root_dir": data_dir, "checkpoint_dir": os.path.join(tmp, "ckpt")}
    index, labels = list_meshes(dcfg)
    ds = MeshDataset(index, dcfg, labels, tmpl.v)
    loader = BatchIterator(ds, BATCH, shuffle=True, seed=0)
    steps = TRAIN_EPOCHS * len(loader)
    fixed = next(iter(BatchIterator(ds, BATCH)))
    weights = {k: v.cpu() for k, v in models["highest"].state_dict().items()}
    lr = float(config["learning_rate"])

    def trainer_for(p, device, operators):
        model = MeshVAE(models[p].cfg)
        model.load_state_dict(weights)
        return Trainer(model, operators, config, device=device)

    pool_keys = [("fp32", up.t_bsr.n_pad, up.t_bsr.n_pad_cols)
                 for up in ops.up[:3]]
    trainers, launches, by_shape = {}, {}, {}
    for p in models:
        tr = trainer_for(p, dev, ops)
        norm = tr.norm_to_device(ds.mean, ds.std)
        fixed_dev = tr.to_device(fixed)
        before = tr.eval_step(fixed_dev, *norm)["scalars"][0].item()
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        # --- the main path: counts reset just before, read just after ---
        bsr_spmm.reset_launches()
        t0 = time.perf_counter()
        epochs = [tr.train_epoch(loader, gen, ds.mean, ds.std)
                  for _ in range(TRAIN_EPOCHS)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[p] = dict(bsr_spmm.LAUNCHES)
        by_shape[p] = dict(bsr_spmm.LAUNCHES_BY_SHAPE)
        # ----------------------------------------------------------------
        after = tr.eval_step(fixed_dev, *norm)["scalars"][0].item()
        avg, errors = tr.evaluate(BatchIterator(ds, BATCH), ds.mean, ds.std)
        say(f"train[{p}]: {steps} steps in {secs:.2f}s (first steps "
            f"included); epoch losses "
            f"{[round(float(e['loss']), 2) for e in epochs]}; fixed-batch eval "
            f"loss {before:.2f} -> {after:.2f}")
        say(f"  evaluate: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                         avg.items()))
        say(f"  launches {launches[p]}; by (mode, n_pad, n_pad_cols) "
            f"{sorted(by_shape[p].items())}")
        lap, pool = TRAIN_LAP_LAUNCHES * steps, TRAIN_POOL_LAUNCHES * steps
        want = ({"bf16x3": lap, "fp32": pool, "bf16": 0} if p == "high"
                else {"bf16x3": 0, "fp32": lap + pool, "bf16": 0})
        if launches[p] != want:
            fail(f"train[{p}] launched {launches[p]}, expected {want} "
                 f"({steps} steps)")
        for key in pool_keys:
            if by_shape[p].get(key) != steps:
                fail(f"train[{p}]: the pool P^T {key} launched "
                     f"{by_shape[p].get(key)} times, expected {steps}")
        if not after < before:
            fail(f"train[{p}]: the fixed batch's loss did not fall "
                 f"({before} -> {after})")
        finite = [e[k] for e in epochs for k in e] + list(avg.values())
        if not (all(np.isfinite(finite)) and np.isfinite(errors).all()):
            fail(f"train[{p}]: non-finite epoch or eval averages")
        if not 0.0 <= avg["sex_change_success_rate"] <= 1.0:
            fail(f"train[{p}]: sex-change rate {avg['sex_change_success_rate']}")
        if errors.shape != (TRAIN_MESHES, hier.levels[0]):
            fail(f"train[{p}]: per-vertex errors {errors.shape}")
        trainers[p] = tr

    # --- card vs CPU: one deterministic step from the same weights -------
    ops_cpu = build_operators(hier, "cpu", cheb_method="pallas")
    for p, bar in (("highest", 1e-4), ("high", 1e-3)):
        pair = {"card": trainer_for(p, dev, ops),
                "cpu": trainer_for(p, "cpu", ops_cpu)}
        loss = {}
        for side, tr in pair.items():
            packed = tr.train_step(tr.to_device(fixed), None,
                                   *tr.norm_to_device(ds.mean, ds.std))
            loss[side] = packed[0].item()
        rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
        named = {s: dict(tr.model.named_parameters()) for s, tr in
                 pair.items()}
        grads = {s: {k: v.grad.cpu() for k, v in named[s].items()}
                 for s in named}
        g_worst = max((grads["card"][k] - g).abs().max().item()
                      / _layer_scale(grads["cpu"], k)
                      for k, g in grads["cpu"].items())
        # Adam alone, apart from gradient rounding (held just above): the
        # card's optimizer steps from the CPU's gradients. The whole step's
        # params are printed too, but not held: where |g + wd p| is near
        # eps, a first Adam step follows the gradient's last bits.
        adam = trainer_for(p, dev, ops)
        for k, v in adam.model.named_parameters():
            v.grad = grads["cpu"][k].to(dev)
        adam.optimizer.step()
        p_adam = max((v.detach().cpu() - named["cpu"][k].detach()).abs()
                     .max().item()
                     for k, v in adam.model.named_parameters())
        p_step = max((named["card"][k].detach().cpu() - v.detach()).abs()
                     .max().item() for k, v in named["cpu"].items())
        say(f"card vs cpu train step [{p}]: loss rel {rel:.2e} (bar 1e-5); "
            f"worst gradient delta {g_worst:.2e} of its layer's max|g| (bar "
            f"{bar:g}); params after Adam on the same gradients: max delta "
            f"{p_adam / lr:.2e} lr (bar 1e-2 lr); after the whole step "
            f"{p_step / lr:.2e} lr (not held)")
        if not (rel <= 1e-5 and g_worst <= bar and p_adam <= 1e-2 * lr):
            fail(f"card and CPU train steps disagree at {p}")

    # --- the lazy seed (#4b): one deterministic step at highest ---------
    from meshvae_tpu_torch.ops import cheb as port_cheb

    grads, counts = {}, {}
    for side, device, operators, flag in (("card", dev, ops, True),
                                          ("cpu", "cpu", ops_cpu, True),
                                          ("card, flag off", dev, ops, False)):
        tr = trainer_for("highest", device, operators)
        port_cheb.FUSED_SEED_DOT = flag
        try:
            bsr_spmm.reset_launches()
            tr.train_step(tr.to_device(fixed), None,
                          *tr.norm_to_device(ds.mean, ds.std))
            torch.cuda.synchronize()
            counts[side] = (bsr_spmm.LAUNCHES["fp32"],
                            bsr_spmm.LAUNCHES_SEED_DOT["fp32"])
        finally:
            port_cheb.FUSED_SEED_DOT = False
        grads[side] = {k: v.grad.cpu()
                       for k, v in tr.model.named_parameters()}
    worst = {other: max((grads["card"][k] - g).abs().max().item()
                        / _layer_scale(grads[other], k)
                        for k, g in grads[other].items())
             for other in ("cpu", "card, flag off")}
    say(f"lazy seed at config 1, highest: launches (all, lazy) {counts}; "
        f"worst gradient delta vs the CPU {worst['cpu']:.2e}, vs the card "
        f"with the flag off {worst['card, flag off']:.2e} of the layer's "
        f"max|g| (bar 1e-4)")
    want_all = TRAIN_LAP_LAUNCHES + TRAIN_POOL_LAUNCHES
    if counts["card"] != (want_all, CONFIG1_SEED_DOT) or counts[
            "card, flag off"] != (want_all, 0):
        fail(f"config-1 lazy-seed step launched {counts}, expected "
             f"({want_all}, {CONFIG1_SEED_DOT}) with the flag on")
    if not max(worst.values()) <= 1e-4:
        fail(f"config-1 lazy-seed gradients disagree: {worst}")

    # --- the train step: host-paced time, peak memory, device busy ------
    for p, tr in trainers.items():
        batch = tr.to_device(fixed)
        norm = tr.norm_to_device(ds.mean, ds.std)
        gen = torch.Generator(device=dev).manual_seed(1)
        step = lambda: tr.train_step(batch, gen, *norm)
        ms = time_ms(torch, step, backlog=False)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        say(f"train step [{p}]: {ms:.3f} ms, {BATCH / ms * 1e3:.1f} "
            f"meshes/sec at B={BATCH}, host-paced; peak memory "
            f"{peak / 2**20:.1f} MiB, of which the step's own "
            f"{(peak - base) / 2**20:.1f} MiB")
        _profile(torch, step, f"train {p}", ms)
    return launches, by_shape


def setup_scaled(torch, dev, tmp, k, levels, dtype):
    """template{k}k.obj generated in tmp from template5k, its hierarchy
    built through the native library into tmp's cache (which run() reads
    back), operators in `dtype` on the card. At 80k every P^T must be
    block-sparse."""
    import shutil

    from meshvae_tpu_torch import native
    from meshvae_tpu_torch.mesh import load_obj, load_or_build_hierarchy
    from meshvae_tpu_torch.models import build_operators
    from meshvae_tpu_torch.tools.make_scaled_template import ensure_template

    label = f"scaled{k}k"
    tdir = os.path.join(tmp, "template")
    os.makedirs(tdir, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "template", "template5k.obj"), tdir)
    path = os.path.join(tdir, f"template{k}k.obj")
    t0 = time.perf_counter()
    ensure_template(path)
    tmpl = load_obj(path)
    import hashlib

    digest = hashlib.sha256(tmpl.v.tobytes() + tmpl.f.tobytes()).hexdigest()
    say(f"{label}: template{k}k.obj {tmpl.num_vertices} vertices, "
        f"{tmpl.num_faces} faces in {time.perf_counter() - t0:.2f}s "
        f"(sha256 of v and f: {digest[:16]})")
    calls = dict(native.CALLS)
    t0 = time.perf_counter()
    cache = os.path.join(tmp, f"cache{k}")
    hier = load_or_build_hierarchy(tmpl, [4, 4, 4, 4], cache_dir=cache)
    secs = time.perf_counter() - t0
    went = {key: native.CALLS[key] - calls[key]
            for key in ("qslim", "transfer")}
    say(f"{label}: hierarchy {hier.levels} in {secs:.2f}s through the "
        f"native library ({went})")
    if went != {"qslim": 4, "transfer": 4}:
        fail(f"the {k}k hierarchy did not go through the native library: "
             f"{went}")
    if hier.levels != levels:
        fail(f"{k}k hierarchy levels {hier.levels}, expected {levels}")
    t0 = time.perf_counter()
    ops = build_operators(hier, dev, cheb_method="pallas", dtype=dtype)
    torch.cuda.synchronize()
    say(f"{label}: {dtype} operators in {time.perf_counter() - t0:.2f}s")
    for name, bsr in [(f"L{i}", op.bsr) for i, op in enumerate(ops.lap)
                      if op.bsr is not None] + [
            (f"P{i}T", up.t_bsr) for i, up in enumerate(ops.up)]:
        if bsr is None:
            if k == 80:
                fail(f"{name} has no block-sparse form at 80k")
            say(f"  {name}: gathers (no block-sparse form)")
            continue
        say(f"  {name}: n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
            f"{bsr.num_blocks} blocks, G {bsr.g_width}, "
            f"{bsr.blocks.dtype}")
    return {"path": path, "tmpl": tmpl, "hier": hier, "ops": ops,
            "hier_sec": secs, "cache": cache}


# the 80k train step's block-sparse calls at B = 32, K = 10: per conv one
# alpha-1 call and eight seeded ones forward; the backward of every conv
# but cheb_enc_0 runs one t_plus call, seven with both seeds and the final
# alpha-1 call; each up-pool's backward runs its P^T once
_FWD80 = {"a1": 1, "a2 prev": 8}
_BWD80 = {"a2 plus": 1, "a2 plus prev": 7, "a1 plus prev": 1}
_BOTH80 = {**_FWD80, **_BWD80}
SCALED_CALLS = {
    "lap": [("enc_0 L0", "L0", 128, _FWD80),
            ("dec_3 L0", "L0", 512, _BOTH80),
            ("enc_1+dec_2 L1", "L1", 512,
             {k: 2 * v for k, v in _BOTH80.items()}),
            ("enc_2 L2", "L2", 512, _BOTH80),
            ("dec_1 L2", "L2", 1024, _BOTH80),
            ("enc_3 L3", "L3", 512, _BOTH80),
            ("dec_0 L3", "L3", 1024, _BOTH80)],
    "pool_perblock": [("up-pool 0 P^T", "P0T", 512, {"a1": 1})],
    "pool_colmajor": [("up-pool 1 P^T", "P1T", 512, {"a1": 1}),
                      ("up-pool 2 P^T", "P2T", 1024, {"a1": 1}),
                      ("up-pool 3 P^T", "P3T", 1024, {"a1": 1})],
}
# the same step with FUSED_SEED_DOT: the square convs' backward calls
# become lazy-seed calls (label, operand, C, kinds, f)
_DOT = {"a2 dot": 1, "a2 dot prev": 7, "a1 dot prev": 1}
SCALED_DOT_CALLS = [("enc_1+dec_2 L1", "L1", 512,
                     {k: 2 * v for k, v in _DOT.items()}, 16),
                    ("enc_2 L2", "L2", 512, _DOT, 16),
                    ("dec_0 L3", "L3", 1024, _DOT, 32),
                    ("dec_3 L0", "L0", 512, _DOT, 16)]


def _operands80(ops):
    out = {f"L{i}": op.bsr for i, op in enumerate(ops.lap)
           if op.bsr is not None}
    out.update({f"P{i}T": up.t_bsr for i, up in enumerate(ops.up)
                if up.t_bsr is not None})
    return out


def phase_kernel_bf16(torch, ops80, dev):
    """The bf16 mode against its twin at every 80k Laplacian shape of the
    train step (alpha 1 and 2, no seed, t_prev, t_plus, both), the four
    P^T (as called, plus one both-seed case on the widest) and the lazy
    seed at the square convs' shapes (and L2 at C = 1024, f = 32). Returns
    the worst absolute error, "lap", "pool" and "seed"."""
    from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    operands = _operands80(ops80)
    every = ("a1", "a2", "a1 prev", "a2 prev", "a1 plus", "a2 plus",
             "a1 plus prev", "a2 plus prev")
    cases = sorted({(key, c) for calls in SCALED_CALLS.values()
                    for _, key, c, _ in calls})
    worst = {"lap": 0.0, "pool": 0.0}
    rel_worst, equal = 0.0, []
    for key, c in cases:
        bsr = operands[key]
        kinds = every if key.startswith("L") else (
            ("a1", "a2 plus prev") if key == "P0T" else ("a1",))
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen).to(bf)
        seeds = {k: torch.randn(bsr.n_pad, c, device=dev,
                                generator=gen).to(bf)
                 for k in ("t_plus", "t_prev")}
        for kind in kinds:
            alpha, kw = _seed_args(kind, seeds)
            y = bsr_grouped_spmm(bsr, x, "bf16", alpha, **kw)
            torch.cuda.synchronize()
            ref = bsr_grouped_spmm_reference(bsr, x, "bf16", alpha, **kw)
            if y.dtype != bf or ref.dtype != bf:
                fail(f"bf16 mode returned {y.dtype} / {ref.dtype}")
            err_abs = (y.float() - ref.float()).abs().max().item()
            err = err_abs / ref.float().abs().max().item()
            eq = (y == ref).float().mean().item()
            equal.append(eq)
            group = "lap" if key.startswith("L") else "pool"
            worst[group] = max(worst[group], err_abs)
            rel_worst = max(rel_worst, err)
            say(f"  80k {key} C={c} bf16 {kind}: max_err/max|y| {err:.3e} "
                f"(bar {TOL_BF16:.3e}), bit-equal {eq:.5f}")
            if not err <= TOL_BF16:
                fail(f"bf16 kernel disagrees with its twin: {key} C={c} "
                     f"{kind} {err:.3e} > {TOL_BF16:.3e}")
    worst["seed"] = 0.0
    for key, c, f in (("L0", 512, 16), ("L1", 512, 16), ("L2", 512, 16),
                      ("L2", 1024, 32), ("L3", 1024, 32)):
        bsr = operands[key]
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen).to(bf)
        seeds = _seeds(torch, bsr, c, gen, dev, bf, f)
        for kind in SEED_DOT_KINDS:
            err_abs, err = _hold(torch, bsr, x, "bf16", kind, seeds, TOL_BF16,
                                 f"80k {key} C={c} f={f} bf16 {kind}")
            worst["seed"] = max(worst["seed"], err_abs)
            rel_worst = max(rel_worst, err)
    say(f"checked kernels: bsr_grouped_spmm[bf16] and its lazy seed (worst "
        f"{rel_worst:.2e} of max|y|, bit-equal share of the plain calls "
        f"{min(equal):.5f}..{max(equal):.5f})")
    return worst


def _time_kind_bf16(torch, bsr, csr, c, kind, gen, dev, f=16):
    """Kernel, twin and torch.sparse times of one bf16 call kind at one 80k
    shape, with its bound: bytes (bf16 blocks, int32 g_idx / g_bcol, bf16
    x, seeds or gm and y, each once) over the HBM rate against 2
    operations per nonzero per column (plus 2 f per output for a lazy
    seed) at the bf16 tensor-core rate."""
    from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    bf = torch.bfloat16
    x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen).to(bf)
    seeds = _seeds(torch, bsr, c, gen, dev, bf, f)
    alpha, kw = _seed_args(kind, seeds)
    lib_csr, lib_kw, lib_x = csr["bf16"], kw, x
    if lib_csr is None:  # cuSPARSE refused bf16: the fp32 yardstick
        lib_csr, lib_x = csr["fp32"], x.float()
        lib_kw = {k: (tuple(t.float() for t in v) if isinstance(v, tuple)
                      else v.float()) for k, v in kw.items()}
    lib_ms = time_ms(torch, lambda: _library_call(torch, lib_csr, lib_x,
                                                  kind, alpha, lib_kw))
    k_ms = time_ms(torch, lambda: bsr_grouped_spmm(bsr, x, "bf16", alpha,
                                                   **kw))
    p_ms = time_ms(torch, lambda: bsr_grouped_spmm_reference(
        bsr, x, "bf16", alpha, **kw))
    act = 2 * c * (bsr.n_pad_cols + bsr.n_pad * (1 + len(kw)))
    blk_bytes = 2 * bsr.blocks.numel() + 4 * (bsr.g_idx.numel()
                                              + bsr.g_bcol.numel())
    nnz = int((bsr.blocks != 0).sum())
    ops_n = 2 * nnz * c + (2 * f * bsr.n_pad * c if "dot" in kind else 0)
    bytes_ms = 1e3 * (blk_bytes + act) / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops_n / PEAK_OPS["bf16"]
    say(f"  {c=} bf16 {kind}: kernel {1e3 * k_ms:.1f} us, twin "
        f"{1e3 * p_ms:.1f} us, torch.sparse[{csr['lib_dtype']}] "
        f"{1e3 * lib_ms:.1f} us, bound {1e3 * max(bytes_ms, ops_ms):.2f} us")
    row = dict(n_pad=bsr.n_pad, n_pad_cols=bsr.n_pad_cols, C=c,
               blocks=bsr.num_blocks, G=bsr.g_width, nnz=nnz, mode="bf16",
               kind=kind, kernel_us=1e3 * k_ms, plain_us=1e3 * p_ms,
               library_us=1e3 * lib_ms, library_dtype=csr["lib_dtype"],
               bound_us=1e3 * max(bytes_ms, ops_ms),
               bytes=blk_bytes + act, ops=ops_n)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms, row=row)


def _csr80(torch, s80, dev, bf16=True):
    """Every block-sparse operand of a scaled hierarchy as CSR, fp32 and
    (bf16 True, where cuSPARSE takes it) bf16, for the torch.sparse
    yardstick."""
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    hier, out = s80["hier"], {}
    for key, bsr in _operands80(s80["ops"]).items():
        i = int(key[1])
        mat = (normalized_neg_adjacency(hier.adjacency[i]) if key[0] == "L"
               else hier.upsample[i].T)
        f32 = _csr(torch, mat, bsr.n_pad, bsr.n_pad_cols, dev)
        out[key] = {"fp32": f32, "bf16": torch.sparse_csr_tensor(
            f32.crow_indices(), f32.col_indices(),
            f32.values().to(torch.bfloat16), size=f32.shape,
            check_invariants=True)}
    if not bf16:
        return {k: e["fp32"] for k, e in out.items()}
    try:
        probe = min(out.values(), key=lambda e: e["fp32"].shape[1])["bf16"]
        torch.sparse.mm(probe, torch.ones(probe.shape[1], 128,
                                          dtype=torch.bfloat16, device=dev))
        torch.cuda.synchronize()
        lib_dtype = "bf16"
    except (RuntimeError, NotImplementedError) as exc:
        say(f"torch.sparse refuses bf16 CSR ({str(exc).splitlines()[0]}); "
            f"the yardstick runs fp32")
        lib_dtype = "fp32"
    for entry in out.values():
        entry["lib_dtype"] = lib_dtype
        if lib_dtype != "bf16":
            entry["bf16"] = None
    return out


def phase_scaled80k(torch, dev, s80, tmp):
    """The scaled80k bf16 main path through train/driver.run(), then its
    checks and times."""
    say(f"== phase 7: scaled80k bf16 training ({SCALED_CFG}, "
        f"{SCALED_MESHES} synthetic 80k meshes, folds 2, epoch 2)")
    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.data import generate_synthetic_dataset
    from meshvae_tpu_torch.ops import bsr_spmm

    t0 = time.perf_counter()
    data_dir = os.path.join(tmp, "data80k")
    generate_synthetic_dataset(s80["tmpl"], data_dir,
                               n_samples=SCALED_MESHES, seed=21)
    say(f"{SCALED_MESHES} synthetic 80k meshes in "
        f"{time.perf_counter() - t0:.1f}s")
    config = read_config(os.path.join(ROOT, SCALED_CFG))
    ckpt = os.path.join(tmp, "ckpt80k")
    config.update({   # paths, folds and epochs only
        "template": s80["path"], "root_dir": data_dir,
        "checkpoint_dir": ckpt, "log_file": os.path.join(ckpt, "log.txt"),
        "hierarchy_cache_dir": os.path.join(tmp, "cache80"),
        "folds": 2, "epoch": 2})
    if (config["compute_dtype"], config["batch_size"],
            config["polygon_order"]) != ("bfloat16", SCALED_BATCH, [10] * 5):
        fail(f"{SCALED_CFG} no longer is bf16, B=32, K=10")

    results, secs, steps, launches, _, by_shape = _run_driver(torch, config,
                                                              dev)
    want = {"fp32": 0, "bf16x3": 0,
            "bf16": SCALED_TRAIN_LAUNCHES * steps["train"]
            + SCALED_EVAL_LAUNCHES * steps["eval"]}
    if steps["train"] < 1 or launches != want:
        fail(f"scaled80k launched {launches}, expected {want} "
             f"({steps['train']} train, {steps['eval']} eval steps)")
    pool_keys = [("bf16", up.t_bsr.n_pad, up.t_bsr.n_pad_cols)
                 for up in s80["ops"].up]
    for key in pool_keys:
        if by_shape.get(key) != steps["train"]:
            fail(f"scaled80k P^T {key} launched {by_shape.get(key)} times, "
                 f"expected once per train step ({steps['train']})")
    _check_run(config, ckpt, results, s80["hier"])

    # --- a fixed batch: the loss falls; then the step's time ------------
    tr, batch, norm, gen = _fixed_batch_falls(torch, dev, s80, config,
                                              data_dir, tmp, SCALED_BATCH)
    step = lambda: tr.train_step(batch, gen, *norm)
    ms = _step_report(torch, step, "scaled80k bf16", SCALED_BATCH)

    # --- FLAG_STEPS train steps with the lazy seed ----------------------
    from meshvae_tpu_torch.ops import cheb as port_cheb

    port_cheb.FUSED_SEED_DOT = True
    try:
        torch.cuda.synchronize()
        bsr_spmm.reset_launches()
        for _ in range(FLAG_STEPS):
            step()
        torch.cuda.synchronize()
        on = (dict(bsr_spmm.LAUNCHES), dict(bsr_spmm.LAUNCHES_SEED_DOT))
        ms_on = time_ms(torch, step, backlog=False)
    finally:
        port_cheb.FUSED_SEED_DOT = False
    say(f"train step [scaled80k bf16, FUSED_SEED_DOT]: {ms_on:.3f} ms "
        f"host-paced ({ms:.3f} ms with the flag off, same call); "
        f"launches over {FLAG_STEPS} steps {on[0]}, lazy seed {on[1]}")
    want = ({"fp32": 0, "bf16x3": 0, "bf16": SCALED_TRAIN_LAUNCHES
             * FLAG_STEPS}, {"fp32": 0, "bf16x3": 0,
                             "bf16": SCALED_SEED_DOT * FLAG_STEPS})
    if on != want:
        fail(f"scaled80k with the lazy seed launched {on}, expected {want}")

    # --- the bf16 kernel per 80k shape and call kind --------------------
    say("80k bf16 train step, per call (median of %d, CUDA events):" % RUNS)
    csr = _csr80(torch, s80, dev)
    operands = _operands80(s80["ops"])
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, per_step = [], {}
    for name, calls in {**SCALED_CALLS,
                        "lap_seed_dot": SCALED_DOT_CALLS}.items():
        acc = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bytes_ms", "ops_ms"), 0.0)
        for label, key, c, kinds, *f in calls:
            bsr = operands[key]
            say(f" {label} ({key}, n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
                f"G {bsr.g_width}):")
            for kind, count in kinds.items():
                got = _time_kind_bf16(torch, bsr, csr[key], c, kind, gen,
                                      dev, *f)
                for k in acc:
                    acc[k] += count * got[k]
                rows.append(dict(got["row"], shape=label, per_step=count))
        per_step[name] = acc
        say(f"per 80k train step {name}: kernel {acc['ms']:.3f} ms, twin "
            f"{acc['plain_ms']:.3f} ms, torch.sparse {acc['library_ms']:.3f}"
            f" ms, bound {acc['bound_ms']:.3f} ms ({_bound_by(acc)})")
    say("shape_rows_80k " + json.dumps(rows))
    lap = (launches["bf16"] - sum(by_shape.get(k, 0) for k in pool_keys))
    counts = {"lap": lap, "pool_perblock": by_shape.get(pool_keys[0], 0),
              "pool_colmajor": sum(by_shape.get(k, 0)
                                   for k in pool_keys[1:]),
              "seed_dot": on[1]["bf16"]}
    return per_step, counts


def _run_driver(torch, config, dev):
    """train/driver.run(config) with train and test, the launch counts
    reset just before and read just after, and the train and eval steps
    counted. Returns (results, seconds, steps, launches, lazy-seed
    launches, launches by shape)."""
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train import Trainer
    from meshvae_tpu_torch.train import driver

    steps = {"train": 0, "eval": 0}
    real = {k: getattr(Trainer, f"{k}_step") for k in steps}

    def counted(kind):
        def step(self, *args, **kwargs):
            steps[kind] += 1
            return real[kind](self, *args, **kwargs)
        return step

    Trainer.train_step, Trainer.eval_step = counted("train"), counted("eval")
    try:
        torch.cuda.synchronize()
        # --- the main path: counts reset just before, read just after ----
        bsr_spmm.reset_launches()
        t0 = time.perf_counter()
        results = driver.run(config, do_train=True, do_test=True, vis=False,
                             device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(bsr_spmm.LAUNCHES)
        seed_dot = dict(bsr_spmm.LAUNCHES_SEED_DOT)
        by_shape = dict(bsr_spmm.LAUNCHES_BY_SHAPE)
        # -----------------------------------------------------------------
    finally:
        Trainer.train_step, Trainer.eval_step = (real["train"],
                                                 real["eval"])
    say(f"run(): {secs:.1f}s for {steps['train']} train and "
        f"{steps['eval']} eval steps (host work included: dataset loads, "
        f"operators, checkpoints); launches {launches}, lazy seed "
        f"{seed_dot}")
    return results, secs, steps, launches, seed_dot, by_shape


def _check_run(config, ckpt, results, hier):
    """History schema and epochs per fold, checkpoints that reload, finite
    test averages and sex-change rates in [0, 1]."""
    import numpy as np

    from meshvae_tpu_torch.models import MeshVAE, VAEConfig
    from meshvae_tpu_torch.train.checkpoint import (checkpoint_path,
                                                    load_checkpoint)

    model = MeshVAE(VAEConfig.from_config(config,
                                          coarse_verts=hier.levels[-1]))
    for fold in (1, 2):
        with open(os.path.join(ckpt, f"history{fold}.json")) as fp:
            hist = json.load(fp)
        keys = {"epoch", "begin", "duration", "finalized", "training",
                "validation"}
        if [h["epoch"] for h in hist] != [1, 2] or any(
                set(h) != keys or "sex_change_success_rate"
                not in h["validation"] for h in hist):
            fail(f"history{fold}.json has the wrong schema or epochs")
        state = load_checkpoint(checkpoint_path(ckpt, fold))
        model.load_state_dict(state["model"])
    for r in results:
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"non-finite test averages {r}")
        if not 0.0 <= r["sex_change_success_rate"] <= 1.0:
            fail(f"sex-change rate {r['sex_change_success_rate']}")
    say(f"test: " + "; ".join(
        f"fold {r['fold']} loss {r['loss']:.1f} mean error "
        f"{r['mean_error']:.4f} acc {r['accuracy']:.3f} sex change "
        f"{r['sex_change_success_rate']:.3f}" for r in results))


def _fixed_batch_falls(torch, dev, scaled, config, data_dir, tmp, batch_size):
    """A Trainer on fresh seeded weights; its eval loss of the first batch
    must fall over 5 train steps. Returns (trainer, batch, norm, gen)."""
    from meshvae_tpu_torch.data import BatchIterator, MeshDataset, list_meshes
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig
    from meshvae_tpu_torch.train import Trainer

    index, labels = list_meshes({"root_dir": data_dir})
    dcfg = {"root_dir": data_dir,
            "checkpoint_dir": os.path.join(tmp, f"norm_{batch_size}")}
    ds = MeshDataset(index[:batch_size], dcfg, labels, scaled["tmpl"].v)
    cfg = VAEConfig.from_config(config, coarse_verts=scaled["hier"].levels[-1])
    tr = Trainer(MeshVAE(cfg, generator=torch.Generator().manual_seed(5)),
                 scaled["ops"], config, device=dev)
    batch = tr.to_device(next(iter(BatchIterator(ds, batch_size))))
    norm = tr.norm_to_device(ds.mean, ds.std)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = tr.eval_step(batch, *norm)["scalars"][0].item()
    for _ in range(5):
        tr.train_step(batch, gen, *norm)
    after = tr.eval_step(batch, *norm)["scalars"][0].item()
    say(f"fixed-batch eval loss {before:.2f} -> {after:.2f} over 5 steps")
    if not after < before:
        fail(f"the fixed batch's loss did not fall ({before} -> {after})")
    return tr, batch, norm, gen


def _step_report(torch, step, label, batch_size):
    """Host-paced step time (CUDA events, median of RUNS), peak memory and
    the profiler's busy time and idle share; returns the step's ms."""
    ms = time_ms(torch, step, backlog=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    say(f"train step [{label}]: {ms:.3f} ms, "
        f"{batch_size / ms * 1e3:.1f} meshes/sec at B={batch_size}, "
        f"host-paced; peak memory {peak / 2**30:.2f} GiB, of which the "
        f"step's own {(peak - base) / 2**30:.2f} GiB")
    _profile(torch, step, f"train {label}", ms, batch=batch_size)
    return ms


def phase_bf16_card_vs_cpu(torch, dev, hier, tmpl, tmp):
    """Config-1 size (template5k, K=6, B=16) in bf16: one deterministic
    train step and one eval step on the card and on the CPU from the same
    weights, with the CPU in fp32 as the yardstick: the card's delta to
    the CPU's bf16 must not exceed the CPU's bf16-vs-fp32 delta by more
    than one bf16 ulp of the scale."""
    say("== phase 8: card vs CPU in bf16 (config 1 size, template5k, K=6, "
        f"B={BATCH})")
    import dataclasses as dc

    from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                        list_meshes)
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig, build_operators
    from meshvae_tpu_torch.train import Trainer

    config = dict(config_1(tmp), compute_dtype="bfloat16")
    data_dir = os.path.join(tmp, "train_data")   # phase 6's meshes
    dcfg = {"root_dir": data_dir, "checkpoint_dir": os.path.join(tmp, "c8")}
    index, labels = list_meshes(dcfg)
    ds = MeshDataset(index, dcfg, labels, tmpl.v)
    fixed = next(iter(BatchIterator(ds, BATCH)))
    cfg16 = VAEConfig.from_config(config, coarse_verts=hier.levels[-1])
    cfg32 = dc.replace(cfg16, compute_dtype="float32", precision="highest")
    weights = MeshVAE(cfg16, generator=torch.Generator().manual_seed(
        77)).state_dict()
    runs = {}
    for side, device, cfg in (("card", dev, cfg16), ("cpu16", "cpu", cfg16),
                              ("cpu32", "cpu", cfg32)):
        ops = build_operators(hier, device, cheb_method="pallas",
                              dtype=cfg.dtype)
        model = MeshVAE(cfg)
        model.load_state_dict(weights)
        tr = Trainer(model, ops, config, device=device)
        batch = tr.to_device(fixed)
        norm = tr.norm_to_device(ds.mean, ds.std)
        ev = tr.eval_step(batch, *norm)
        packed = tr.train_step(batch, None, *norm)
        runs[side] = {
            "loss": packed[0].item(), "eval_loss": ev["scalars"][0].item(),
            "recon_orig": ev["recon_orig"].float().cpu(),
            "grads": {k: v.grad.cpu() for k, v in
                      tr.model.named_parameters()}}
    ulp = 2.0 ** -8
    worst = []

    def held(name, card, cpu16, cpu32, scale):
        d_card = float(abs(card - cpu16).max())
        d_bf16 = float(abs(cpu16 - cpu32).max())
        worst.append((d_card - d_bf16) / scale)
        say(f"  {name}: |card - cpu_bf16| {d_card:.3e}, |cpu_bf16 - "
            f"cpu_fp32| {d_bf16:.3e} (scale {scale:.3e})")
        if not d_card <= d_bf16 + ulp * scale:
            fail(f"card vs CPU in bf16: {name} {d_card:.3e} > "
                 f"{d_bf16:.3e} + one ulp of {scale:.3e}")

    c, a, b = runs["card"], runs["cpu16"], runs["cpu32"]
    for key in ("loss", "eval_loss"):
        held(key, torch.tensor(c[key]), torch.tensor(a[key]),
             torch.tensor(b[key]), abs(b[key]))
    held("eval recon_orig", c["recon_orig"], a["recon_orig"],
         b["recon_orig"], float(b["recon_orig"].abs().max()))
    for k in b["grads"]:
        held(f"grad {k}", c["grads"][k], a["grads"][k], b["grads"][k],
             _layer_scale(b["grads"], k))
    say(f"card vs CPU in bf16: held on {len(worst)} quantities; worst "
        f"(|card - cpu_bf16| - |cpu_bf16 - cpu_fp32|) / scale "
        f"{max(worst):.3e}")



# the scaled20k train step's block-sparse calls at B = 64, K = 10 with
# FUSED_SEED_DOT (label, operand, C, kinds, f): forward per conv one
# alpha-1 call and eight seeded ones; the backward of the square convs
# (enc_1, enc_2, dec_2, dec_3: 16 -> 16, f_pad 16) runs lazy-seed calls,
# cheb_dec_1's (32 -> 16, f_pad 32) eager ones; each block-sparse up-pool's
# backward runs its P^T once
_FWD20 = {"a1": 1, "a2 prev": 8}
SCALED20_CALLS = {
    "lap": [("enc_0 L0", "L0", 256, _FWD20, 16),
            ("dec_3 L0", "L0", 1024, _FWD20, 16),
            ("enc_1+dec_2 L1", "L1", 1024,
             {k: 2 * v for k, v in _FWD20.items()}, 16),
            ("enc_2 L2", "L2", 1024, _FWD20, 16),
            ("dec_1 L2", "L2", 2048, {**_FWD20, **_BWD80}, 16)],
    "lap_seed_dot": [("dec_3 L0", "L0", 1024, _DOT, 16),
                     ("enc_1+dec_2 L1", "L1", 1024,
                      {k: 2 * v for k, v in _DOT.items()}, 16),
                     ("enc_2 L2", "L2", 1024, _DOT, 16)],
}
# up-pool i's P^T runs at B times the features entering it: 16, 16, 32, 32
SCALED20_POOL_C = (1024, 1024, 2048, 2048)


def phase_scaled20k(torch, dev, s20, tmp):
    """The scaled20k fp32 main path with the lazy seed through
    train/driver.run(), then its checks and times."""
    say(f"== phase 9: scaled20k fp32 training with the lazy seed "
        f"({SCALED20_CFG}, {SCALED20_MESHES} synthetic 20k meshes, folds 2, "
        f"epoch 2)")
    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.data import generate_synthetic_dataset
    from meshvae_tpu_torch.ops import cheb as port_cheb
    from meshvae_tpu_torch.ops.bsr_spmm import pad_features

    t0 = time.perf_counter()
    data_dir = os.path.join(tmp, "data20k")
    generate_synthetic_dataset(s20["tmpl"], data_dir,
                               n_samples=SCALED20_MESHES, seed=23)
    say(f"{SCALED20_MESHES} synthetic 20k meshes in "
        f"{time.perf_counter() - t0:.1f}s")
    config = read_config(os.path.join(ROOT, SCALED20_CFG))
    ckpt = os.path.join(tmp, "ckpt20k")
    config.update({   # paths, folds and epochs only
        "template": s20["path"], "root_dir": data_dir,
        "checkpoint_dir": ckpt, "log_file": os.path.join(ckpt, "log.txt"),
        "hierarchy_cache_dir": s20["cache"], "folds": 2, "epoch": 2})
    if (config.get("compute_dtype", "float32"), config["matmul_precision"],
            config["batch_size"], config["polygon_order"]) != (
                "float32", "highest", SCALED20_BATCH, [10] * 5):
        fail(f"{SCALED20_CFG} no longer is fp32 at highest, B=64, K=10")
    ops = s20["ops"]
    pools = [i for i, up in enumerate(ops.up) if up.t_bsr is not None]
    pool_keys = [("fp32", ops.up[i].t_bsr.n_pad, ops.up[i].t_bsr.n_pad_cols)
                 for i in pools]
    per_train = SCALED20_FWD + SCALED20_BWD + len(pools)

    port_cheb.FUSED_SEED_DOT = True
    try:
        results, secs, steps, launches, seed_dot, by_shape = _run_driver(
            torch, config, dev)
    finally:
        port_cheb.FUSED_SEED_DOT = False
    want = ({"fp32": per_train * steps["train"]
             + SCALED20_EVAL * steps["eval"], "bf16x3": 0, "bf16": 0},
            {"fp32": SCALED20_SEED_DOT * steps["train"], "bf16x3": 0,
             "bf16": 0})
    say(f"expected per train step {per_train} = {SCALED20_FWD} forward + "
        f"{SCALED20_BWD} backward + {len(pools)} P^T (up-pools {pools}), "
        f"{SCALED20_SEED_DOT} of them lazy-seed; {SCALED20_EVAL} per eval")
    if steps["train"] < 1 or (launches, seed_dot) != want:
        fail(f"scaled20k launched {launches}, lazy seed {seed_dot}, expected "
             f"{want} ({steps['train']} train, {steps['eval']} eval steps)")
    for key in pool_keys:
        if by_shape.get(key) != steps["train"]:
            fail(f"scaled20k P^T {key} launched {by_shape.get(key)} times, "
                 f"expected once per train step ({steps['train']})")
    _check_run(config, ckpt, results, s20["hier"])

    # --- a fixed batch: the loss falls (flag on); the step's time --------
    port_cheb.FUSED_SEED_DOT = True
    try:
        tr, batch, norm, gen = _fixed_batch_falls(
            torch, dev, s20, config, data_dir, tmp, SCALED20_BATCH)
        step = lambda: tr.train_step(batch, gen, *norm)
        ms = _step_report(torch, step, "scaled20k fp32, FUSED_SEED_DOT",
                          SCALED20_BATCH)
    finally:
        port_cheb.FUSED_SEED_DOT = False
    ms_off = time_ms(torch, step, backlog=False)
    bases = sum(4 * lap.bsr.n_pad * SCALED20_BATCH * 10 * pad_features(
                    SCALED20_BATCH, f_in)
                for lap, f_in in ((ops.lap[0], 3), (ops.lap[0], 16),
                                  (ops.lap[1], 16), (ops.lap[1], 16),
                                  (ops.lap[2], 16), (ops.lap[2], 32)))
    say(f"train step [scaled20k fp32, flag off]: {ms_off:.3f} ms host-paced "
        f"(same call); the six block-sparse convs' saved bases "
        f"(n_pad x B x K x f_pad fp32) hold {bases / 2**30:.2f} GiB")

    # --- the fp32 kernel per 20k shape and call kind --------------------
    say("20k fp32 train step, per call (median of %d, CUDA events):" % RUNS)
    csr = _csr80(torch, s20, dev, bf16=False)
    operands = _operands80(ops)
    calls = dict(SCALED20_CALLS, pool=[
        (f"up-pool {i} P^T", f"P{i}T", SCALED20_POOL_C[i], {"a1": 1}, 16)
        for i in pools])
    gen = torch.Generator(device=dev).manual_seed(4)
    rows, per_step = [], {}
    for name, group in calls.items():
        acc = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bytes_ms", "ops_ms"), 0.0)
        for label, key, c, kinds, f in group:
            bsr = operands[key]
            say(f" {label} ({key}, n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
                f"G {bsr.g_width}):")
            for kind, count in kinds.items():
                got = _time_kind(torch, bsr, csr[key], c, kind, ("fp32",),
                                 gen, dev, f)["fp32"]
                for k in acc:
                    acc[k] += count * got[k]
                rows.append(dict(got["row"], shape=label, per_step=count))
        per_step[name] = acc
        say(f"per 20k train step {name}: kernel {acc['ms']:.3f} ms, twin "
            f"{acc['plain_ms']:.3f} ms, torch.sparse {acc['library_ms']:.3f}"
            f" ms, bound {acc['bound_ms']:.3f} ms ({_bound_by(acc)})")
    say("shape_rows_20k " + json.dumps(rows))
    pool_n = sum(by_shape.get(k, 0) for k in pool_keys)
    counts = {"lap": launches["fp32"] - pool_n - seed_dot["fp32"],
              "seed_dot": seed_dot["fp32"], "pool": pool_n}
    return per_step, counts


def _twins():
    """Context: the fused step and every SpMM of the conv backward run
    their plain twins, on whatever device the tensors are."""
    import contextlib

    from meshvae_tpu_torch.ops import bsr_spmm, cheb, cheb_fused

    @contextlib.contextmanager
    def ctx():
        real = cheb_fused.cheb_fused_step, cheb.bsr_grouped_spmm
        cheb_fused.cheb_fused_step = cheb_fused.cheb_fused_step_reference
        cheb.bsr_grouped_spmm = bsr_spmm.bsr_grouped_spmm_reference
        try:
            yield
        finally:
            cheb_fused.cheb_fused_step, cheb.bsr_grouped_spmm = real

    return ctx()


def phase_fused(torch, dev, ops, hier, ops20, hier20):
    """TPU kernel #9 on the card: the fused step and cheb_conv_fused
    against their twins, then times beside the main-path conv."""
    say("== phase 10: fused propagate + mix (cheb_conv_fused, #9)")
    from meshvae_tpu_torch.ops import cheb_fused
    from meshvae_tpu_torch.ops.cheb import cheb_conv_bsr
    from meshvae_tpu_torch.ops.cheb_fused import (cheb_conv_fused,
                                                  cheb_fused_step,
                                                  cheb_fused_step_reference)
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    shapes = [("config-1 L0", ops.lap[0], BATCH, 6),
              ("config-1 L1", ops.lap[1], BATCH, 6),
              ("scaled20k L0", ops20.lap[0], SCALED20_BATCH, 10)]
    adjacency = {"config-1 L0": hier.adjacency[0],
                 "config-1 L1": hier.adjacency[1],
                 "scaled20k L0": hier20.adjacency[0]}
    gen = torch.Generator(device=dev).manual_seed(9)
    worst_abs = 0.0
    # --- the convs: counts reset just before, read just after ------------
    cheb_fused.reset_launches()
    runs = []
    for name, op, b, k in shapes:
        for precision in (("highest", "high") if name == "config-1 L1"
                          else ("highest",)):
            x = torch.randn(b, op.n, 16, device=dev, generator=gen)
            w = 0.1 * torch.randn(k, 16, 16, device=dev, generator=gen)
            bias = 0.1 * torch.randn(16, device=dev, generator=gen)
            g = torch.randn(b, op.n, 16, device=dev, generator=gen)
            outs = {}
            for side in ("kernel", "twin"):
                leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
                if side == "twin":
                    with _twins():
                        y = cheb_conv_fused(*leaves[:1], op, *leaves[1:],
                                            precision=precision)
                        (y * g).sum().backward()
                else:
                    y = cheb_conv_fused(*leaves[:1], op, *leaves[1:],
                                        precision=precision)
                    (y * g).sum().backward()
                torch.cuda.synchronize()
                outs[side] = (y.detach(), *(t.grad for t in leaves))
            got, want = outs["kernel"], outs["twin"]
            err = (got[0] - want[0]).abs().max().item()
            rel = err / want[0].abs().max().item()
            layer = max(want[2].abs().max().item(),
                        want[3].abs().max().item())
            g_rel = [(got[1] - want[1]).abs().max().item()
                     / want[1].abs().max().item()] + [
                (a - c).abs().max().item() / layer
                for a, c in zip(got[2:], want[2:])]
            # at high the in-kernel mix splits T_k, which kernel and twin
            # hold to the last fp32 bit only: a one-bit change can move a
            # bf16 split, and the dropped lo*lo term by 2^-17 |T W|
            bar = 1e-5 if precision == "highest" else 1e-4
            say(f"  {name} B={b} K={k} {precision}: forward {rel:.3e} of "
                f"max|y| (bar {bar:.0e}); dx, dW, dbias {g_rel[0]:.2e}, "
                f"{g_rel[1]:.2e}, {g_rel[2]:.2e} of max|g| (bar 1e-4)")
            if not (rel <= bar and max(g_rel) <= 1e-4):
                fail(f"cheb_conv_fused disagrees with its twin at {name} "
                     f"{precision}")
            runs.append((name, op, b, k))
    launches = dict(cheb_fused.LAUNCHES)
    # ----------------------------------------------------------------------
    want_n = {"fp32": sum(k - 1 for _, _, _, k in shapes), "bf16x3": 6 - 1}
    say(f"cheb_fused_step launches {launches} (expected {want_n}: K - 1 per "
        f"kernel-side conv forward)")
    if launches != want_n:
        fail(f"cheb_fused_step launched {launches}, expected {want_n}")

    # --- each step against its twin; per-call times and bounds -----------
    per_call = {}
    for name, op, b, k in shapes:
        bsr, f = op.bsr, 16
        c = b * f
        t1, t2 = (torch.randn(bsr.n_pad, c, device=dev, generator=gen)
                  for _ in range(2))
        w = 0.1 * torch.randn(f, f, device=dev, generator=gen)
        acc = torch.randn(bsr.n_pad, c, device=dev, generator=gen)
        got_t, got_acc = cheb_fused_step(bsr, t1, t2, w, acc.clone(), 2.0)
        torch.cuda.synchronize()
        want_t, want_acc = cheb_fused_step_reference(bsr, t1, t2, w, acc, 2.0)
        errs = [(a - r).abs().max().item() for a, r in
                ((got_t, want_t), (got_acc, want_acc))]
        rel = max(e / r.abs().max().item()
                  for e, r in zip(errs, (want_t, want_acc)))
        worst_abs = max(worst_abs, *errs)
        if not rel <= TOL_KERNEL:
            fail(f"cheb_fused_step disagrees with its twin at {name}: {rel}")
        scratch = acc.clone()
        k_ms = time_ms(torch, lambda: cheb_fused_step(bsr, t1, t2, w, scratch,
                                                      2.0))
        p_ms = time_ms(torch, lambda: cheb_fused_step_reference(
            bsr, t1, t2, w, acc, 2.0))
        csr = _csr(torch, normalized_neg_adjacency(adjacency[name]),
                   bsr.n_pad, bsr.n_pad, dev)

        def library():
            t = torch.addmm(t2, csr, t1, beta=-1.0, alpha=2.0)
            return t, acc + torch.matmul(t.reshape(bsr.n_pad, b, f), w
                                         ).reshape(bsr.n_pad, c)

        l_ms = time_ms(torch, library)
        nnz = int((bsr.blocks != 0).sum())
        byts = (4 * (bsr.blocks.numel() + bsr.g_idx.numel()
                     + bsr.g_bcol.numel()) + 4 * c * bsr.n_pad * 3
                + 2 * 4 * bsr.n_pad * c + 4 * f * f)
        ops_n = 2 * nnz * c + 2 * bsr.n_pad * c * f
        bytes_ms = 1e3 * byts / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops_n / PEAK_OPS["fp32"]
        per_call[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                              bound_ms=max(bytes_ms, ops_ms),
                              bytes_ms=bytes_ms, ops_ms=ops_ms, k=k)
        say(f"  step {name} C={c}: max_err/max {rel:.3e}; kernel "
            f"{1e3 * k_ms:.1f} us, twin {1e3 * p_ms:.1f} us, torch.sparse + "
            f"torch.matmul {1e3 * l_ms:.1f} us, bound "
            f"{1e3 * max(bytes_ms, ops_ms):.2f} us")

    # --- the conv beside the main path's, forward and forward+backward ---
    for name, op, b, k in shapes:
        x = torch.randn(b, op.n, 16, device=dev, generator=gen)
        w = (0.1 * torch.randn(k, 16, 16, device=dev, generator=gen)
             ).requires_grad_(True)
        bias = torch.zeros(16, device=dev, requires_grad=True)
        xg = x.clone().requires_grad_(True)
        row = {}
        for label, conv in (("fused", cheb_conv_fused),
                            ("cheb_conv_bsr", lambda a, o, *r, **kw:
                             cheb_conv_bsr(a, o.bsr, *r, **kw))):
            with torch.no_grad():
                row[f"{label} fwd"] = time_ms(
                    torch, lambda: conv(x, op, w, bias, precision="highest"))
            row[f"{label} fwd+bwd"] = time_ms(
                torch, lambda: conv(xg, op, w, bias,
                                    precision="highest").sum().backward(),
                backlog=False)
        say(f"  conv {name} B={b} K={k} (ms): " + ", ".join(
            f"{key} {v:.3f}" for key, v in row.items()))
    name = "scaled20k L0"
    entry = {key: v * (per_call[name]["k"] - 1) if key.endswith("ms") else v
             for key, v in per_call[name].items()}
    return entry, launches, worst_abs


def _synthetic_bsr(torch, dev, g, dtype, seed):
    """A random row-grouped operator with G slots per row (a third of them
    padded after the first), 13 + G row blocks over 11 column blocks of 17
    dense random blocks: the ring's chunk count and item stride vary with
    G."""
    from meshvae_tpu_torch.ops.block_sparse import BLOCK, BlockSparseOperator

    gen = torch.Generator().manual_seed(seed)
    nb, n_rows, ncb = 17, 13 + g, 11
    blocks = (0.1 * torch.randn(nb, BLOCK, BLOCK, generator=gen)).to(dtype)
    g_idx = torch.randint(0, nb, (n_rows, g), generator=gen,
                          dtype=torch.int32)
    g_idx[:, 1:][torch.rand(n_rows, g - 1, generator=gen) < 0.3] = nb
    g_bcol = torch.randint(0, ncb, (n_rows * g,), generator=gen,
                           dtype=torch.int32)
    zero = torch.zeros(nb, dtype=torch.int32, device=dev)
    return BlockSparseOperator(blocks.to(dev), zero, zero, g_idx.to(dev),
                               g_bcol.to(dev), n_rows * BLOCK,
                               n_rows * BLOCK, ncb * BLOCK, g)


def phase_emitted(torch, dev, ops, s20, s80):
    """TPU kernel #10 on the card: emitted_spmm against its twin and
    bsr_grouped_spmm at the level-0 shapes and over G = 1..9 with padded
    slots, then the probe (bench/emitted_probe.py) at the 80k bf16 and 20k
    fp32 level 0, its launches counted, and the twin's time. Returns the
    kernels-line entries' numbers per probe run and the launches."""
    say("== phase 11: emitted-pipeline SpMM (emitted_spmm, #10)")
    from meshvae_tpu_torch.bench import emitted_probe
    from meshvae_tpu_torch.ops import emitted_spmm as em
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm

    gen = torch.Generator(device=dev).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    bar = {f32: TOL_KERNEL, bf: TOL_BF16}
    mode_of = {f32: "fp32", bf: "bf16"}
    worst = {f32: 0.0, bf: 0.0}
    shapes = [("config-1 L0", ops.lap[0].bsr, 256, f32),
              ("scaled20k L0", s20["ops"].lap[0].bsr, 1024, f32),
              ("scaled80k L0", s80["ops"].lap[0].bsr, 512, bf)]
    for name, bsr, c, dt in shapes:
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen).to(dt)
        y = em.emitted_spmm(bsr, x)
        torch.cuda.synchronize()
        twin = em.emitted_spmm_reference(bsr, x)
        grouped = bsr_grouped_spmm(bsr, x, mode_of[dt])
        errs = [((y.float() - r.float()).abs().max().item(),
                 r.float().abs().max().item()) for r in (twin, grouped)]
        rel = [e / m for e, m in errs]
        worst[dt] = max(worst[dt], errs[0][0], errs[1][0])
        say(f"  {name} C={c} {str(dt)[6:]} G={bsr.g_width}: vs twin "
            f"{rel[0]:.3e}, vs bsr_grouped_spmm {rel[1]:.3e} of max|y| (bar "
            f"{bar[dt]:.1e}); bit-equal to bsr_grouped_spmm "
            f"{(y == grouped).float().mean().item():.5f}")
        if not max(rel) <= bar[dt]:
            fail(f"emitted_spmm disagrees at {name}: {rel}")
    # the ring across G = 1..9 (the 80k level 0 has G = 8), padded slots and
    # 1, 2 or the resident CTAs per SM, against bsr_grouped_spmm (the same
    # inner product: bit-equal expected) and the twin. Dense random blocks
    # sum 128 G terms per output, so the twin's cuBLAS order can move a
    # bf16 rounding of an output near max|y|: one ulp there is up to 2^-7
    # of max|y|, and the bf16 twin bar is that ulp, exactly
    sweep = 0.0
    for g in range(1, 10):
        for dt in (f32, bf):
            bsr = _synthetic_bsr(torch, dev, g, dt, seed=g)
            x = torch.randn(bsr.n_pad_cols, 512, device=dev,
                            generator=gen).to(dt)
            grouped = bsr_grouped_spmm(bsr, x, mode_of[dt])
            twin = em.emitted_spmm_reference(bsr, x).float()
            top = twin.abs().max().item()
            bars = [(grouped, bar[dt]),
                    (twin, bar[dt] if dt == f32
                     else 2.0 ** (math.floor(math.log2(top)) - 7) / top)]
            for ctas in (0, 1, 2):
                y = em.emitted_spmm(bsr, x, ctas)
                torch.cuda.synchronize()
                for ref, lim in bars:
                    err = ((y.float() - ref.float()).abs().max()
                           / ref.float().abs().max()).item()
                    sweep = max(sweep, err / lim)
                    if not err <= lim:
                        fail(f"emitted_spmm at G={g} {dt} ctas {ctas}: "
                             f"{err:.3e} > {lim:.3e}")
    say(f"  G = 1..9 with padded slots, 0/1/2 CTAs per SM cap, vs twin and "
        f"bsr_grouped_spmm: worst {sweep:.3f} of the bar")

    # --- the probe: counts reset just before, read just after ------------
    tdir = os.path.dirname(s80["path"])
    runs = {"bf16": ["--workload", "80k", "--cache-dir", s80["cache"]],
            "fp32": ["--workload", "20k", "--compute-dtype", "float32",
                     "--cache-dir", s20["cache"]]}
    em.reset_launches()
    reports = {}
    for key, argv in runs.items():
        say(f"probe: python -m meshvae_tpu_torch.bench.emitted_probe "
            + " ".join(argv[:-2] + ["--template-dir", "<tmp>"]))
        try:
            reports[key] = emitted_probe.main(argv + ["--template-dir", tdir])
        except SystemExit as exc:
            fail(f"the emitted probe failed: {exc}")
    launches = dict(em.LAUNCHES)
    # -----------------------------------------------------------------------
    out = {}
    for key, rep in reports.items():
        dt = bf if key == "bf16" else f32
        bsr = (s80 if key == "bf16" else s20)["ops"].lap[0].bsr
        x = torch.randn(bsr.n_pad_cols, rep["c"], device=dev,
                        generator=gen).to(dt)
        plain = time_ms(torch, lambda: em.emitted_spmm_reference(bsr, x))
        info = rep["kernel"]
        say(f"probe {rep['workload']} {key} C={rep['c']} G={rep['g']}: "
            f"emitted {rep['emitted_ms']:.4f} ms (CTAs/SM "
            f"{rep['emitted_ms_by_ctas_per_sm']}), grouped "
            f"{rep['grouped_ms']:.4f} ms, torch.sparse[{rep['library_dtype']}]"
            f" {rep['library_ms']:.4f} ms, twin {plain:.4f} ms, bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}; x per item "
            f"{rep['bound_ms_x_per_item']:.4f}); emitted/grouped "
            f"{rep['emitted_ms'] / rep['grouped_ms']:.3f}; kernel "
            f"{info['registers']} registers, {info['dynamic_smem']} B shared,"
            f" {info['local_bytes']} B local, {info['ctas_per_sm']} CTAs/SM")
        out[key] = dict(ms=rep["emitted_ms"], plain_ms=plain,
                        library_ms=rep["library_ms"],
                        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
                        grouped_ms=rep["grouped_ms"])
    say(f"emitted_spmm launches in the probe runs {launches}")
    if not (launches["bf16"] > 0 and launches["fp32"] > 0):
        fail(f"the probe did not launch emitted_spmm in both dtypes: "
             f"{launches}")
    return out, launches, worst


INFER_MESHES = 32   # two batches of 16


def phase_infer(torch, dev, models, hier, tmpl, tmp):
    """The batch-inference entry point at config 1:
    ``python -m meshvae_tpu_torch.infer``'s main on a checkpoint_1.pt of the
    seeded weights and the data's norm.npz, on the card (launch counts reset
    just before, read just after) and with --device cpu, at high and
    highest: pred.json equal, errors and every .obj within 1e-4 of the mesh
    scale; then the card pass's meshes/sec with and without --no-meshes.
    Returns the card's launches per precision."""
    say(f"== phase 12: batch inference (python -m meshvae_tpu_torch.infer, "
        f"config 1, {INFER_MESHES} synthetic meshes, batch {BATCH})")
    import contextlib
    import io

    import numpy as np

    from meshvae_tpu_torch.data import (MeshDataset, generate_synthetic_dataset,
                                        list_meshes)
    from meshvae_tpu_torch.infer import driver as infer_driver
    from meshvae_tpu_torch.infer.__main__ import main as infer_main
    from meshvae_tpu_torch.mesh import load_obj
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train.checkpoint import save_checkpoint
    from meshvae_tpu_torch.train.loop import make_optimizer

    root = os.path.join(tmp, "infer")
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(tmpl, data_dir, n_samples=INFER_MESHES,
                               seed=12)
    ckpt = os.path.join(root, "ckpt")
    weights = models["high"].state_dict()
    save_checkpoint(os.path.join(ckpt, "checkpoint_1.pt"), weights,
                    make_optimizer(models["high"].parameters(), 1e-3,
                                   5e-4).state_dict(), 1, 0.0, 0.0)
    dcfg = {"root_dir": data_dir, "checkpoint_dir": ckpt}
    index, labels = list_meshes(dcfg)
    ds = MeshDataset(index, dcfg, labels, tmpl.v)  # writes norm.npz
    scale = float(np.abs(ds.original).max())
    config = config_1(tmp)
    cfg_path = os.path.join(root, "infer.cfg")
    with open(cfg_path, "w") as fp:
        fp.write("[All]\ncheckpoint_dir = ckpt/\n")
        for k in ("template", "hierarchy_cache_dir", "downsampling_factors",
                  "num_conv_filters", "polygon_order", "num_hidden",
                  "num_style", "batch_size", "cheb_method"):
            v = config[k]
            fp.write(f"{k} = "
                     f"{', '.join(map(str, v)) if isinstance(v, list) else v}"
                     "\n")
    batches = -(-INFER_MESHES // BATCH)
    timed = {}
    real = {"run": infer_driver.run_inference,
            "device": infer_driver.InferenceEngine.run_dataset}

    def timer(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timed[key] = time.perf_counter() - t0
            return res
        return run

    def cli(out, device, precision, *flags):
        """main(argv) of the CLI; returns its seconds, run_inference's and
        InferenceEngine.run_dataset's (the device pass and its one pull)."""
        argv = ["-c", cfg_path, "-d", data_dir, "-o", out, "-n", "1",
                "-p", "matmul_precision", precision, "--device", device,
                *flags]
        infer_driver.run_inference = timer("run", real["run"])
        infer_driver.InferenceEngine.run_dataset = timer("device",
                                                         real["device"])
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                rc = infer_main(argv)
                secs = time.perf_counter() - t0
        finally:
            infer_driver.run_inference = real["run"]
            infer_driver.InferenceEngine.run_dataset = real["device"]
        if rc != 0:
            fail(f"python -m meshvae_tpu_torch.infer {' '.join(argv)}: rc "
                 f"{rc}")
        return secs, timed["run"], timed["device"]

    def outputs(out):
        with open(os.path.join(out, "pred.json")) as fp:
            pred = json.load(fp)
        with open(os.path.join(out, "inference.json")) as fp:
            inf = json.load(fp)
        mdir = os.path.join(out, "sex_change")
        objs = {f: load_obj(os.path.join(mdir, f)).v
                for f in sorted(os.listdir(mdir))}
        return pred, inf, objs

    launches = {}
    for p, mode in (("high", "bf16x3"), ("highest", "fp32")):
        card_out = os.path.join(root, f"card_{p}")
        torch.cuda.synchronize()
        # --- the main path: counts reset just before, read just after ----
        bsr_spmm.reset_launches()
        secs, pass_secs, _ = cli(card_out, "cuda", p)
        launches[p] = dict(bsr_spmm.LAUNCHES)
        # -----------------------------------------------------------------
        cpu_secs, _, _ = cli(os.path.join(root, f"cpu_{p}"), "cpu", p)
        (pred, inf, objs), (pred_c, inf_c, objs_c) = (
            outputs(card_out), outputs(os.path.join(root, f"cpu_{p}")))
        if len(pred) != INFER_MESHES or pred != pred_c:
            fail(f"infer[{p}]: pred.json differs between card and CPU")
        err = max(abs(inf[n]["reconstruction_error"][k]
                      - inf_c[n]["reconstruction_error"][k])
                  for n in inf for k in ("mean", "max"))
        if list(objs) != list(objs_c) or len(objs) != 3 * INFER_MESHES:
            fail(f"infer[{p}]: the sex_change/ triples differ: "
                 f"{len(objs)} vs {len(objs_c)} files")
        mesh_err = max(float(np.abs(objs[f] - objs_c[f]).max())
                       for f in objs)
        per_batch = launches[p][mode] / batches
        say(f"infer[{p}]: card {secs:.2f}s CLI ({pass_secs:.2f}s "
            f"run_inference), CPU {cpu_secs:.2f}s; pred equal, "
            f"{sum(int(v) for v in pred.values())} of {len(pred)} predicted "
            f"1; errors within {err:.3e}, .obj within {mesh_err:.3e} (bar "
            f"{TOL_STEP * scale:.3e}); launches {launches[p]}, "
            f"{per_batch:g} per batch")
        if not (err <= TOL_STEP * scale and mesh_err <= TOL_STEP * scale):
            fail(f"infer[{p}]: card vs CPU beyond {TOL_STEP} of the scale")
        want = {m: (LAUNCHES_PER_STEP * batches if m == mode else 0)
                for m in bsr_spmm.MODES}
        if launches[p] != want:
            fail(f"infer[{p}] launched {launches[p]}, expected {want}")
    # the card pass, warm, with and without the mesh triples
    for flags in ((), ("--no-meshes",)):
        secs, pass_secs, dev_secs = cli(os.path.join(root, "timed"), "cuda",
                                        "high", *flags)
        say(f"infer[high{' ' if flags else ''}{' '.join(flags)}]: "
            f"{INFER_MESHES / pass_secs:.1f} meshes/sec through "
            f"run_inference ({pass_secs:.3f}s: dataset load, device pass, "
            f"JSON and .obj writes); {INFER_MESHES / dev_secs:.1f} through "
            f"the device pass alone ({dev_secs:.4f}s: {batches} steps, upload "
            f"and the one pull); {INFER_MESHES / secs:.1f} through the whole "
            f"CLI ({secs:.2f}s with model, operators and checkpoint)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, ROOT)
    try:
        import meshvae_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"meshvae_tpu_torch is not importable beside this script: {exc}")
    from meshvae_tpu_torch.device import resolve_device
    from meshvae_tpu_torch.infer.serve import MeshServer

    from meshvae_tpu_torch.ops import cheb as port_cheb

    port_cheb.FUSED_SEED_DOT = False  # each phase that wants it says so
    dev = resolve_device("cuda:0")
    card = phase_device(torch)
    t0 = time.perf_counter()
    phase_build()
    seconds = {"build": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        models, ops, hier, tmpl, single, many_dir, (mean, std) = \
            setup_config_1(torch, dev, tmp)
        s80 = setup_scaled(torch, dev, tmp, 80, SCALED_LEVELS,
                           torch.bfloat16)
        s20 = setup_scaled(torch, dev, tmp, 20, SCALED20_LEVELS,
                           torch.float32)
        seconds["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        worst_abs = phase_kernel(torch, ops, s20["ops"], dev)
        worst80 = phase_kernel_bf16(torch, s80["ops"], dev)
        seconds["kernel"] = time.perf_counter() - t0
        servers = {p: MeshServer(m, ops, mean, std, template=tmpl.v,
                                 faces=tmpl.f, batch_size=BATCH,
                                 output_path=os.path.join(tmp, f"out_{p}"),
                                 save_meshes=True, device=dev)
                   for p, m in models.items()}
        t0 = time.perf_counter()
        try:
            launches, host = phase_serve(torch, dev, servers, models, ops,
                                         hier, single, many_dir, tmp)
            seconds["serve"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            per_step = phase_times(torch, servers, ops, hier, dev, host)
            seconds["times"] = time.perf_counter() - t0
        finally:
            for server in servers.values():
                server.close()
        t0 = time.perf_counter()
        train_launches, by_shape = phase_train(torch, dev, models, ops, hier,
                                               tmpl, tmp)
        seconds["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_step80, launches80 = phase_scaled80k(torch, dev, s80, tmp)
        seconds["scaled80k"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_bf16_card_vs_cpu(torch, dev, hier, tmpl, tmp)
        seconds["bf16_card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_step20, launches20 = phase_scaled20k(torch, dev, s20, tmp)
        seconds["scaled20k"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused, fused_launches, fused_err = phase_fused(
            torch, dev, ops, hier, s20["ops"], s20["hier"])
        seconds["fused"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        emitted, emitted_launches, emitted_err = phase_emitted(
            torch, dev, ops, s20, s80)
        seconds["emitted"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        infer_launches = phase_infer(torch, dev, models, hier, tmpl, tmp)
        seconds["infer"] = time.perf_counter() - t0
    say("phase seconds " + json.dumps({k: round(v, 1)
                                       for k, v in seconds.items()}))

    def entry(name, replaces, launched, err, acc, source=SOURCE):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launched, max_abs_err=err, ms=acc["ms"],
                    plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
                    bound_by=_bound_by(acc), library_ms=acc["library_ms"])

    pool_keys = [("fp32", up.t_bsr.n_pad, up.t_bsr.n_pad_cols)
                 for up in ops.up[:3]]
    pool_launches = [sum(by_shape[p].get(k, 0) for p in by_shape)
                     for k in pool_keys]
    lap_fp32 = train_launches["highest"]["fp32"] - sum(
        by_shape["highest"].get(k, 0) for k in pool_keys)
    kernels = [entry(f"bsr_grouped_spmm[{m}]", REPLACES[m], launches[m],
                     worst_abs[m], per_step[f"serve_{m}"])
               for m in ("fp32", "bf16x3")]
    kernels += [
        entry("bsr_grouped_spmm[bf16x3] train step: Laplacian",
              REPLACES["bf16x3"], train_launches["high"]["bf16x3"],
              worst_abs["bf16x3"], per_step["train_lap_bf16x3"]),
        entry("bsr_grouped_spmm[fp32] train step: Laplacian",
              REPLACES["fp32"], lap_fp32, worst_abs["fp32"],
              per_step["train_lap_fp32"]),
        entry("bsr_grouped_spmm[fp32] train step: pool P^T, column-major",
              REPLACES["colmajor"], pool_launches[0] + pool_launches[1],
              worst_abs["pool"], per_step["train_pool_colmajor"]),
        entry("bsr_grouped_spmm[fp32] train step: pool P^T, grouped",
              REPLACES["grouped"], pool_launches[2], worst_abs["pool"],
              per_step["train_pool_grouped"]),
        entry("bsr_grouped_spmm[bf16] scaled80k train step: Laplacian",
              REPLACES["fp32"], launches80["lap"], worst80["lap"],
              per_step80["lap"]),
        entry("bsr_grouped_spmm[bf16] scaled80k train step: up-pool 0 P^T, "
              "per-block", REPLACES["perblock"], launches80["pool_perblock"],
              worst80["pool"], per_step80["pool_perblock"]),
        entry("bsr_grouped_spmm[bf16] scaled80k train step: up-pools 1-3 "
              "P^T, column-major", REPLACES["colmajor"],
              launches80["pool_colmajor"], worst80["pool"],
              per_step80["pool_colmajor"]),
        # the bf16x3 mode's launches on the main path (serving); the P^T
        # case itself runs on no main path (the pool backward is fp32)
        entry("bsr_grouped_spmm[bf16x3] pool P^T, column-major form "
              "(phase 3 shapes, off the main path)",
              REPLACES["colmajor_bf16x3"], launches["bf16x3"],
              worst_abs["pool_bf16x3"], per_step["pool_bf16x3_colmajor"]),
        entry("bsr_grouped_spmm[bf16x3] pool P^T, per-block form (phase 3 "
              "both-seed shape, off the main path)",
              REPLACES["perblock_bf16x3"], launches["bf16x3"],
              worst_abs["pool_bf16x3"], per_step["pool_bf16x3_perblock"]),
        entry("bsr_grouped_spmm[fp32] scaled20k train step: Laplacian",
              REPLACES["fp32"], launches20["lap"], worst_abs["fp32"],
              per_step20["lap"]),
        entry("bsr_grouped_spmm[fp32] scaled20k train step: lazy seed",
              REPLACES["seed_dot"], launches20["seed_dot"],
              worst_abs["seed_fp32"], per_step20["lap_seed_dot"]),
        entry("bsr_grouped_spmm[fp32] scaled20k train step: pool P^T",
              REPLACES["colmajor"], launches20["pool"], worst_abs["pool"],
              per_step20["pool"]),
        entry("bsr_grouped_spmm[bf16] scaled80k train step (FUSED_SEED_DOT):"
              " lazy seed", REPLACES["seed_dot"], launches80["seed_dot"],
              worst80["seed"], per_step80["lap_seed_dot"]),
        entry("cheb_fused_step[fp32] per scaled20k L0 conv forward",
              REPLACES["fused"], fused_launches["fp32"], fused_err, fused,
              source=SOURCE_FUSED),
        # the batch-inference CLI (phase 12): the serving step's calls
        entry("bsr_grouped_spmm[bf16x3] inference CLI at high, per batch",
              REPLACES["bf16x3"], infer_launches["high"]["bf16x3"],
              worst_abs["bf16x3"], per_step["serve_bf16x3"]),
        entry("bsr_grouped_spmm[fp32] inference CLI at highest, per batch",
              REPLACES["fp32"], infer_launches["highest"]["fp32"],
              worst_abs["fp32"], per_step["serve_fp32"]),
    ]
    # TPU kernel #10: the probe runs of phase 11 (its path)
    for key, label in (("bf16", "scaled80k L0 bf16 C=512"),
                       ("fp32", "scaled20k L0 fp32 C=512")):
        e = emitted[key]
        kernels.append(dict(
            name=f"emitted_spmm[{key}] probe, {label}", route="cuda",
            source=SOURCE_EMITTED, replaces=REPLACES["emitted"],
            launches=emitted_launches[key],
            max_abs_err=emitted_err[torch.bfloat16 if key == "bf16"
                                    else torch.float32],
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"]))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
