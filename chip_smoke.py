#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (meshvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one block of output lines each; any failed check exits non-zero:

 1. device  the card's name and power limit (nvidia-smi).
 2. build   compile the CUDA kernel from ops/csrc (nvcc, sm_90a) and print
            the build seconds and ptxas' register/shared-memory report.
 3. kernel  bsr_grouped_spmm in both modes (fp32, bf16x3) against its plain
            PyTorch twin on the card: the real template5k level-0 and
            level-1 Laplacians at C in {128, 256, 512}, alpha in {1, 2}, with
            and without t_prev; at C = 256 also the backward's calls (t_plus
            alone, t_plus and t_prev together); and the pool backward's
            rectangular P^T of up-pools 0-2 at their training widths
            ([1280, 5120] and [384, 1280] at C = 256, [128, 384] at C = 512;
            the first also at C = 512 with every seed case). Fails above
            1e-5 of max |y|.
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
            (the whole step's param delta is printed, not held). Then the host-paced train step (CUDA events, median of
            25), its peak memory, and its device busy time and idle share.

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
            meshes/sec, peak memory, device busy and idle share, and the
            bf16 kernel per 80k shape and call kind beside its twin,
            torch.sparse on the same operator in CSR (bf16 where cuSPARSE
            takes it) and its byte bound.
 8. bf16    card vs CPU in bf16 at config-1 size (template5k, K=6, B=16,
            compute_dtype bfloat16): one deterministic train step (no
            dropout, z = mu) and one eval step from the same weights; the
            card's loss, every gradient, the eval loss and recon_orig must
            be closer to the CPU's bf16 result than that is to the CPU's
            fp32 result (up to one bf16 ulp of the layer's scale).

Phase 3 also holds the bf16 mode on the card at every 80k Laplacian (its C
values, alpha 1 and 2, no seed, t_prev, t_plus, both) and the four P^T:
max |kernel - twin| <= 2^-8 max |twin| (one bf16 ulp: both round once),
and prints the share of bit-equal outputs.

The line before the last is {"kernels": [...]}: per serving step (the two
bsr_grouped_spmm[mode] entries, summed over the step's 20 calls), per
config-1 train step (the Laplacian calls in each mode, the
column-major-class P^T of up-pools 0-1 and the grouped P^T of up-pool 2)
and per 80k bf16 train step (the Laplacian calls, #3b; the P^T of up-pool
0, which the JAX package runs per block, #5; those of up-pools 1-3, which
it runs column-major, #7), with the launches of the main-path runs. The
last line is {"ok": true, "device": {...}}.
"""
import dataclasses
import json
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
REPLACES = {"fp32": "meshvae_tpu/ops/pallas_cheb.py:434",
            "bf16x3": "meshvae_tpu/ops/pallas_cheb.py:462",
            "colmajor": "meshvae_tpu/ops/pallas_cheb.py:208",
            "grouped": "meshvae_tpu/ops/pallas_cheb.py:395",
            "perblock": "meshvae_tpu/ops/pallas_cheb.py:180"}
# files/scaled80k.cfg: B = 32, K = 10 at every level
SCALED_CFG = os.path.join("files", "scaled80k.cfg")
SCALED_LEVELS = [79968, 19992, 4998, 1250, 313]
SCALED_BATCH = 32
SCALED_MESHES = 40      # per fold: 14 train (1 step), 6 valid, 20 test
SCALED_TRAIN_LAUNCHES = 139  # 8 convs x 9 forward, 7 x 9 backward, 4 P^T
SCALED_EVAL_LAUNCHES = 144   # 72 forward + the counterfactual's 36 + 36


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

    t0 = time.perf_counter()
    logs = _build.build_libraries(["bsr_spmm"])
    _build.load_library("bsr_spmm")
    say(f"build_sec {time.perf_counter() - t0:.2f} "
        f"({'compiled' if logs else 'already built'})")
    for line in logs.get("bsr_spmm", "").splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    from meshvae_tpu_torch import native

    path, secs = native.build()
    native.library()
    say(f"native host library {os.path.basename(path)}: build_sec "
        f"{secs:.2f} ({'compiled' if secs else 'already built'})")


def _seed_args(kind: str, seeds: dict) -> tuple:
    """(alpha, kwargs) of one call kind: "a1" or "a2" (alpha 1 or 2), then
    the seeds it adds, "plus" (t_plus) and "prev" (t_prev)."""
    alpha = 2.0 if kind.startswith("a2") else 1.0
    kw = {}
    if "plus" in kind:
        kw["t_plus"] = seeds["t_plus"]
    if "prev" in kind:
        kw["t_prev"] = seeds["t_prev"]
    return alpha, kw


def phase_kernel(torch, ops, dev):
    """The kernel against its twin at every shape and call kind the serving
    and training paths give it. Returns the worst absolute error per
    entry group: "fp32" and "bf16x3" over the Laplacian cases, "pool" over
    the fp32 P^T cases."""
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
    cases += [("P0T", t_bsr[0], 256, ("a1",)), ("P0T", t_bsr[0], 512, fwd),
              ("P1T", t_bsr[1], 256, ("a1",)), ("P2T", t_bsr[2], 512, ("a1",))]
    worst = {m: 0.0 for m in MODES}
    worst_abs = {"fp32": 0.0, "bf16x3": 0.0, "pool": 0.0}
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
                group = ("pool" if name.startswith("P") and mode == "fp32"
                         else mode)
                worst_abs[group] = max(worst_abs[group], err_abs)
                tag = f"{name} C={c} {mode} {kind}"
                say(f"  {tag}: max_err/max|y| {err:.3e}")
                if not err <= TOL_KERNEL:
                    fail(f"kernel disagrees with its twin: {tag} "
                         f"{err:.3e} > {TOL_KERNEL}")
    say("checked kernels: " + ", ".join(
        f"bsr_grouped_spmm[{m}] (worst {worst[m]:.2e} of max|y|)"
        for m in MODES))
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
    or two where the kernel folds both seeds (addmm, then sub_)."""
    if "plus" in kind:
        y = torch.addmm(kw["t_plus"], csr, x, alpha=alpha)
        return y.sub_(kw["t_prev"]) if "prev" in kind else y
    if "prev" in kind:
        return torch.addmm(kw["t_prev"], csr, x, beta=-1.0, alpha=alpha)
    return torch.sparse.mm(csr, x)


def _time_kind(torch, bsr, csr, c, kind, modes, gen, dev):
    """Kernel, twin and library times of one call kind at one shape, with
    its bound: bytes (blocks, g_idx, g_bcol, x, seeds, y, each once) over
    the HBM rate against the operations the data needs (2 per nonzero per
    column, 6 in bf16x3) over the peak rate of their type."""
    from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen)
    seeds = {k: torch.randn(bsr.n_pad, c, device=dev, generator=gen)
             for k in ("t_plus", "t_prev")}
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
        ops_n = (6 if mode == "bf16x3" else 2) * nnz * c
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


def setup_scaled80k(torch, dev, tmp):
    """template80k.obj generated in tmp from template5k, its hierarchy
    built through the native library into tmp's cache (which run() reads
    back), bf16 operators on the card."""
    import shutil

    from meshvae_tpu_torch import native
    from meshvae_tpu_torch.mesh import load_obj, load_or_build_hierarchy
    from meshvae_tpu_torch.models import build_operators
    from meshvae_tpu_torch.tools.make_scaled_template import ensure_template

    tdir = os.path.join(tmp, "template")
    os.makedirs(tdir)
    shutil.copy(os.path.join(ROOT, "template", "template5k.obj"), tdir)
    path = os.path.join(tdir, "template80k.obj")
    t0 = time.perf_counter()
    ensure_template(path)
    tmpl = load_obj(path)
    import hashlib

    digest = hashlib.sha256(tmpl.v.tobytes() + tmpl.f.tobytes()).hexdigest()
    say(f"scaled80k: template80k.obj {tmpl.num_vertices} vertices, "
        f"{tmpl.num_faces} faces in {time.perf_counter() - t0:.2f}s "
        f"(sha256 of v and f: {digest[:16]})")
    calls = dict(native.CALLS)
    t0 = time.perf_counter()
    hier = load_or_build_hierarchy(tmpl, [4, 4, 4, 4],
                                   cache_dir=os.path.join(tmp, "cache80"))
    secs = time.perf_counter() - t0
    went = {k: native.CALLS[k] - calls[k] for k in ("qslim", "transfer")}
    say(f"scaled80k: hierarchy {hier.levels} in {secs:.2f}s through the "
        f"native library ({went})")
    if went != {"qslim": 4, "transfer": 4}:
        fail(f"the 80k hierarchy did not go through the native library: "
             f"{went}")
    if hier.levels != SCALED_LEVELS:
        fail(f"80k hierarchy levels {hier.levels}, expected {SCALED_LEVELS}")
    t0 = time.perf_counter()
    ops = build_operators(hier, dev, cheb_method="pallas",
                          dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say(f"scaled80k: bf16 operators in {time.perf_counter() - t0:.2f}s")
    for name, bsr in [(f"L{i}", op.bsr) for i, op in enumerate(ops.lap)
                      if op.bsr is not None] + [
            (f"P{i}T", up.t_bsr) for i, up in enumerate(ops.up)]:
        if bsr is None:
            fail(f"{name} has no block-sparse form at 80k")
        say(f"  {name}: n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
            f"{bsr.num_blocks} blocks, G {bsr.g_width}, "
            f"{bsr.blocks.dtype}")
    return {"path": path, "tmpl": tmpl, "hier": hier, "ops": ops,
            "hier_sec": secs}


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


def _operands80(ops):
    out = {f"L{i}": op.bsr for i, op in enumerate(ops.lap)
           if op.bsr is not None}
    out.update({f"P{i}T": up.t_bsr for i, up in enumerate(ops.up)})
    return out


def phase_kernel_bf16(torch, ops80, dev):
    """The bf16 mode against its twin at every 80k Laplacian shape of the
    train step (alpha 1 and 2, no seed, t_prev, t_plus, both) and the four
    P^T (as called, plus one both-seed case on the widest). Returns the
    worst absolute error, "lap" and "pool"."""
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
    say(f"checked kernels: bsr_grouped_spmm[bf16] (worst {rel_worst:.2e} "
        f"of max|y|, bit-equal share {min(equal):.5f}..{max(equal):.5f})")
    return worst


def _time_kind_bf16(torch, bsr, csr, c, kind, gen, dev):
    """Kernel, twin and torch.sparse times of one bf16 call kind at one 80k
    shape, with its bound: bytes (bf16 blocks, int32 g_idx / g_bcol, bf16
    x, seeds and y, each once) over the HBM rate against 2 operations per
    nonzero per column at the bf16 tensor-core rate."""
    from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    bf = torch.bfloat16
    x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen).to(bf)
    seeds = {k: torch.randn(bsr.n_pad, c, device=dev, generator=gen).to(bf)
             for k in ("t_plus", "t_prev")}
    alpha, kw = _seed_args(kind, seeds)
    lib_csr, lib_kw, lib_x = csr["bf16"], kw, x
    if lib_csr is None:  # cuSPARSE refused bf16: the fp32 yardstick
        lib_csr, lib_x = csr["fp32"], x.float()
        lib_kw = {k: v.float() for k, v in kw.items()}
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
    ops_n = 2 * nnz * c
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


def _csr80(torch, s80, dev):
    """Every 80k operand as CSR, fp32 and (where cuSPARSE takes it) bf16,
    for the torch.sparse yardstick."""
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
    import numpy as np

    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                        generate_synthetic_dataset,
                                        list_meshes)
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train import Trainer
    from meshvae_tpu_torch.train import driver
    from meshvae_tpu_torch.train.checkpoint import (checkpoint_path,
                                                    load_checkpoint)

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
        by_shape = dict(bsr_spmm.LAUNCHES_BY_SHAPE)
        # -----------------------------------------------------------------
    finally:
        Trainer.train_step, Trainer.eval_step = (real["train"],
                                                 real["eval"])
    say(f"run(): {secs:.1f}s for {steps['train']} train and "
        f"{steps['eval']} eval steps (host work included: dataset loads, "
        f"operators, checkpoints); launches {launches}")
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
    model = MeshVAE(VAEConfig.from_config(
        config, coarse_verts=s80["hier"].levels[-1]))
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

    # --- a fixed batch: the loss falls; then the step's time ------------
    index, labels = list_meshes({"root_dir": data_dir})
    dcfg = {"root_dir": data_dir, "checkpoint_dir": os.path.join(tmp, "n80")}
    ds = MeshDataset(index[:SCALED_BATCH], dcfg, labels, s80["tmpl"].v)
    tr = Trainer(MeshVAE(model.cfg, generator=torch.Generator().manual_seed(5)),
                 s80["ops"], config, device=dev)
    batch = tr.to_device(next(iter(BatchIterator(ds, SCALED_BATCH))))
    norm = tr.norm_to_device(ds.mean, ds.std)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = tr.eval_step(batch, *norm)["scalars"][0].item()
    for _ in range(5):
        tr.train_step(batch, gen, *norm)
    after = tr.eval_step(batch, *norm)["scalars"][0].item()
    say(f"fixed-batch eval loss {before:.2f} -> {after:.2f} over 5 steps")
    if not after < before:
        fail(f"scaled80k: the fixed batch's loss did not fall "
             f"({before} -> {after})")
    step = lambda: tr.train_step(batch, gen, *norm)
    ms = time_ms(torch, step, backlog=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    say(f"train step [scaled80k bf16]: {ms:.3f} ms, "
        f"{SCALED_BATCH / ms * 1e3:.1f} meshes/sec at B={SCALED_BATCH}, "
        f"host-paced; peak memory {peak / 2**30:.2f} GiB, of which the "
        f"step's own {(peak - base) / 2**30:.2f} GiB")
    _profile(torch, step, "train scaled80k bf16", ms, batch=SCALED_BATCH)

    # --- the bf16 kernel per 80k shape and call kind --------------------
    say("80k bf16 train step, per call (median of %d, CUDA events):" % RUNS)
    csr = _csr80(torch, s80, dev)
    operands = _operands80(s80["ops"])
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, per_step = [], {}
    for name, calls in SCALED_CALLS.items():
        acc = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bytes_ms", "ops_ms"), 0.0)
        for label, key, c, kinds in calls:
            bsr = operands[key]
            say(f" {label} ({key}, n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
                f"G {bsr.g_width}):")
            for kind, count in kinds.items():
                got = _time_kind_bf16(torch, bsr, csr[key], c, kind, gen,
                                      dev)
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
                                   for k in pool_keys[1:])}
    return per_step, counts


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

    dev = resolve_device("cuda:0")
    card = phase_device(torch)
    phase_build()
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        models, ops, hier, tmpl, single, many_dir, (mean, std) = \
            setup_config_1(torch, dev, tmp)
        s80 = setup_scaled80k(torch, dev, tmp)
        seconds["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        worst_abs = phase_kernel(torch, ops, dev)
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
    say("phase seconds " + json.dumps({k: round(v, 1)
                                       for k, v in seconds.items()}))

    def entry(name, replaces, launched, err, acc):
        return dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
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
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
