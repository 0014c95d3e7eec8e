#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (meshvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one block of output lines each; any failed check exits non-zero:

 1. device  the card's name and power limit (nvidia-smi).
 2. build   compile the CUDA kernel from ops/csrc (nvcc, sm_90a) and print
            the build seconds and ptxas' register/shared-memory report.
 3. kernel  bsr_grouped_spmm in both modes (fp32, bf16x3) against its plain
            PyTorch twin on the card: the real template5k level-0 and
            level-1 Laplacians, C in {128, 256, 512}, alpha in {1, 2}, with
            and without t_prev, plus one rectangular operator (the level-0
            up-pool transpose, x of 5120 rows for 1280 output rows). Fails
            above 1e-5 of max |y|.
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
 5. times   CUDA events, median of 25 runs, L2 warm (as inside the serving
            step). Device time alone (a sleep kernel holds the device while
            the host queues the runs): the kernel at the four path shapes in
            both modes, unseeded (alpha 1) and seeded (alpha 2, t_prev), its
            plain twin, and torch.sparse on the same L in CSR form (the
            library yardstick, never used by the port). The serving step in
            meshes/sec at B=16 as served (the device waits on the host; 50
            runs); its peak device memory; a torch.profiler window for the
            device busy time per step and the idle share.

The line before the last is {"kernels": [...]}, with per-serving-step
numbers (ms, plain_ms, bound_ms, library_ms summed over the step's 20
calls: at each of the 4 shapes one alpha-1 call and four seeded calls). The
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
TOL_STEP = 1e-4         # card vs CPU step, relative to the mesh scale
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_OPS = {"fp32": 67e12,  # fp32 FMA outside the tensor cores
            "bf16x3": 989e12}  # bf16 operands, dense tensor-core rate
RUNS = 25
BATCH = 16
LAUNCHES_PER_STEP = 20  # 4 block-sparse convs x (K - 1) at K = 6
SOURCE = "meshvae_tpu_torch/ops/csrc/bsr_spmm.cu"
REPLACES = {"fp32": "meshvae_tpu/ops/pallas_cheb.py:434",
            "bf16x3": "meshvae_tpu/ops/pallas_cheb.py:462"}


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
    say(f"torch {torch.__version__} cuda {torch.version.cuda}, "
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


def phase_kernel(torch, ops, hier, dev):
    say("== phase 3: kernel vs plain twin on the card")
    import scipy.sparse as sp

    from meshvae_tpu_torch.ops.block_sparse import to_block_sparse
    from meshvae_tpu_torch.ops.bsr_spmm import (MODES, bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    gen = torch.Generator(device=dev).manual_seed(0)
    rect = to_block_sparse(sp.csr_matrix(hier.upsample[0].T), dev,
                           allow_rect=True)
    operands = [("L0", ops.lap[0].bsr, (128, 256, 512)),
                ("L1", ops.lap[1].bsr, (128, 256, 512)),
                ("P0T", rect, (512,))]
    worst = {m: 0.0 for m in MODES}
    worst_abs = {m: 0.0 for m in MODES}
    for name, bsr, widths in operands:
        say(f"{name}: n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
            f"{bsr.num_blocks} blocks, G {bsr.g_width}, padded slots "
            f"{int((bsr.g_idx == bsr.num_blocks).sum())}")
        for c in widths:
            x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen)
            tp = torch.randn(bsr.n_pad, c, device=dev, generator=gen)
            for mode in MODES:
                for alpha in (1.0, 2.0):
                    for prev in (None, tp):
                        y = bsr_grouped_spmm(bsr, x, mode, alpha, t_prev=prev)
                        torch.cuda.synchronize()
                        ref = bsr_grouped_spmm_reference(bsr, x, mode, alpha,
                                                         t_prev=prev)
                        err_abs = (y - ref).abs().max().item()
                        err = err_abs / ref.abs().max().item()
                        worst[mode] = max(worst[mode], err)
                        worst_abs[mode] = max(worst_abs[mode], err_abs)
                        tag = (f"{name} C={c} {mode} alpha={alpha:g} "
                               f"t_prev={prev is not None}")
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
    for mode in bsr_spmm.LAUNCHES:
        bsr_spmm.LAUNCHES[mode] = 0
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
        if count != steps * LAUNCHES_PER_STEP:
            fail(f"bsr_grouped_spmm[{mode}] launched {count} times on the "
                 f"main path, expected {steps * LAUNCHES_PER_STEP}")

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


def _csr(torch, lap, n_pad, dev):
    """L (scipy CSR, n x n) padded to [n_pad, n_pad] as a torch CSR tensor."""
    n = lap.shape[0]
    indptr = list(lap.indptr) + [lap.indptr[-1]] * (n_pad - n)
    return torch.sparse_csr_tensor(
        torch.tensor(indptr, dtype=torch.int64),
        torch.from_numpy(lap.indices.astype("int64")),
        torch.from_numpy(lap.data.astype("float32")),
        size=(n_pad, n_pad), check_invariants=True).to(dev)


def phase_times(torch, servers, ops, hier, dev, host):
    say("== phase 5: times (median of %d, CUDA events)" % RUNS)
    from meshvae_tpu_torch.ops.bsr_spmm import (MODES, bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [("enc L0", 0, 128), ("enc L1", 1, 256), ("dec L1", 1, 512),
              ("dec L0", 0, 512)]
    per_step = {m: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
                for m in MODES}
    rows = []
    for label, lvl, c in shapes:
        bsr = ops.lap[lvl].bsr
        lap_csr = _csr(torch, normalized_neg_adjacency(
            hier.adjacency[lvl]), bsr.n_pad, dev)
        nnz = int((bsr.blocks != 0).sum())
        x = torch.randn(bsr.n_pad, c, device=dev, generator=gen)
        tp = torch.randn(bsr.n_pad, c, device=dev, generator=gen)
        lib = {False: lambda: torch.sparse.mm(lap_csr, x),
               True: lambda: torch.addmm(tp, lap_csr, x, beta=-1.0,
                                         alpha=2.0)}
        for seeded in (False, True):
            alpha, prev = (2.0, tp) if seeded else (1.0, None)
            lib_ms = time_ms(torch, lib[seeded])
            want = bsr_grouped_spmm_reference(bsr, x, "fp32", alpha,
                                              t_prev=prev)
            lib_err = ((lib[seeded]() - want).abs().max()
                       / want.abs().max()).item()
            act = 4 * c * bsr.n_pad * (3 if seeded else 2)  # x, seed, y
            blk_bytes = 4 * (bsr.blocks.numel() + bsr.g_idx.numel()
                             + bsr.g_bcol.numel())
            nnz_bytes = 8 * nnz + 4 * (bsr.n_pad + 1)  # CSR value+col, rows
            for mode in MODES:
                k_ms = time_ms(torch, lambda: bsr_grouped_spmm(
                    bsr, x, mode, alpha, t_prev=prev))
                p_ms = time_ms(torch, lambda: bsr_grouped_spmm_reference(
                    bsr, x, mode, alpha, t_prev=prev))
                ops_n = (6 if mode == "bf16x3" else 2) * nnz * c
                bytes_ms = 1e3 * (blk_bytes + act) / HBM_BYTES_PER_S
                ops_ms = 1e3 * ops_n / PEAK_OPS[mode]
                bound = max(bytes_ms, ops_ms)
                bound_nnz = 1e3 * max((nnz_bytes + act) / HBM_BYTES_PER_S,
                                      ops_n / PEAK_OPS[mode])
                weight = 4 if seeded else 1  # calls of this kind per conv
                acc = per_step[mode]
                acc["ms"] += weight * k_ms
                acc["plain_ms"] += weight * p_ms
                acc["bound_ms"] += weight * bound
                acc["library_ms"] += weight * lib_ms
                acc["bytes_ms"] += weight * bytes_ms
                acc["ops_ms"] += weight * ops_ms
                rows.append(dict(shape=label, n_pad=bsr.n_pad, C=c,
                                 blocks=bsr.num_blocks, nnz=nnz, mode=mode,
                                 seeded=seeded, kernel_us=1e3 * k_ms,
                                 plain_us=1e3 * p_ms,
                                 library_us=1e3 * lib_ms,
                                 library_rel_err=lib_err,
                                 bound_us=1e3 * bound,
                                 bound_nnz_us=1e3 * bound_nnz,
                                 bytes=blk_bytes + act, ops=ops_n))
                say(f"  {label} C={c} {mode} "
                    f"{'alpha=2 t_prev' if seeded else 'alpha=1'}: kernel "
                    f"{1e3 * k_ms:.1f} us, twin {1e3 * p_ms:.1f} us, "
                    f"torch.sparse {1e3 * lib_ms:.1f} us (rel err "
                    f"{lib_err:.1e}), bound {1e3 * bound:.2f} us (bytes; "
                    f"{1e3 * bound_nnz:.2f} us with CSR storage)")
    say("shape_rows " + json.dumps(rows))

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
        say(f"serving step [{p}]: {ms:.3f} ms, {BATCH / ms * 1e3:.1f} "
            f"meshes/sec at B={BATCH} as served; kernel share "
            f"{per_step['bf16x3' if p == 'high' else 'fp32']['ms'] / ms:.2f};"
            f" peak memory {peak / 2**20:.1f} MiB, of which the step's own "
            f"{(peak - base) / 2**20:.1f} MiB ({(peak - base) / peak:.2f})")

    # --- device busy share of the serving step (torch.profiler) ---------
    from torch.profiler import ProfilerActivity, profile

    server = servers["high"]
    for _ in range(3):
        server.serve_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            server.serve_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / 5
    kern = []  # device-side events only: an aten op's entry repeats its kernels
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            kern.append((dev_us / 5, evt.key))
    kern.sort(reverse=True)
    busy = sum(t for t, _ in kern)
    if busy:
        say(f"profile [high]: device busy {busy:.0f} us/step "
            f"({BATCH / busy * 1e6:.1f} meshes/sec of device time); idle share "
            f"{1 - busy / (1e3 * step_ms['high']):.2f} of the unprofiled "
            f"step ({1e3 * step_ms['high']:.0f} us; {wall_us:.0f} us/step "
            f"under the profiler)")
        for t, name in kern[:8]:
            say(f"  {t:8.1f} us/step  {name[:90]}")
    else:
        say("profile [high]: no device time recorded (not measured)")
    return per_step


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
    with tempfile.TemporaryDirectory() as tmp:
        models, ops, hier, tmpl, single, many_dir, (mean, std) = \
            setup_config_1(torch, dev, tmp)
        worst_abs = phase_kernel(torch, ops, hier, dev)
        servers = {p: MeshServer(m, ops, mean, std, template=tmpl.v,
                                 faces=tmpl.f, batch_size=BATCH,
                                 output_path=os.path.join(tmp, f"out_{p}"),
                                 save_meshes=True, device=dev)
                   for p, m in models.items()}
        try:
            launches, host = phase_serve(torch, dev, servers, models, ops,
                                         hier, single, many_dir, tmp)
            per_step = phase_times(torch, servers, ops, hier, dev, host)
        finally:
            for server in servers.values():
                server.close()
    kernels = [dict(name=f"bsr_grouped_spmm[{mode}]", route="cuda",
                    source=SOURCE, replaces=REPLACES[mode],
                    launches=launches[mode], max_abs_err=worst_abs[mode],
                    ms=per_step[mode]["ms"],
                    plain_ms=per_step[mode]["plain_ms"],
                    bound_ms=per_step[mode]["bound_ms"],
                    bound_by=("bytes" if per_step[mode]["bytes_ms"]
                              >= per_step[mode]["ops_ms"] else "operations"),
                    library_ms=per_step[mode]["library_ms"])
               for mode in ("fp32", "bf16x3")]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
