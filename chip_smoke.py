#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (meshvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one block of output lines each; any failed check exits non-zero:

 1. device  the card's name and power limit (nvidia-smi).
 2. build   compile the six CUDA kernel sources from ops/csrc (nvcc,
            sm_90a, one process per source, started together; all but
            pool_transpose.cu, phase_mark.cu and cheb_mix.cu include the
            occupied-tile engine csrc/tile_engine.cuh) and
            print the build seconds and ptxas' registers, shared memory and
            spills for every instantiation.
 3. kernel  bsr_grouped_spmm in both modes (fp32, bf16x3) against its plain
            PyTorch twin on the card: the real template5k level-0 and
            level-1 Laplacians at C in {128, 256, 512}, alpha in {1, 2}, with
            and without t_prev; at C = 256 also the backward's calls (t_plus
            alone, t_plus and t_prev together); and its rectangular case
            on the block-sparse P^T of up-pools 0-2 at their training widths
            ([1280, 5120] and [384, 1280] at C = 256, [128, 384] at C = 512;
            the first also at C = 512 with every seed case; no model path
            runs it since pool_transpose took the pool backward). Fails
            above 1e-5 of max |y|. The lazy seed (#4b, t_plus_dot) in mode
            fp32 at the config-1 L0/L1 Laplacians (C = 256, f = 16; L0 also
            at f = 128) and the scaled20k L0/L1 (C = 1024, f = 16), alpha 1
            and 2, with and without t_prev; each call must take the kernel's
            lazy seed (launches_seed_dot()). Mode bf16 on the 80k operators
            (phase_kernel_bf16) at every Laplacian shape of the vae80k and
            joint80k train steps (C 128 to 2048) and every call kind: within
            2^-8 of max |y| of the twin, or, element by element, equal to
            the exact (float64) sum rounded once to bf16.
3b. pool_transpose  the pool backward's P^T kernel (ops/csrc/
            pool_transpose.cu, a CSR row gather; TPU kernels #7, #5 and #4's
            P^T call) at every P^T shape of the model paths: config 1's
            up-pools 0-2 at B=16 (C = 256, 256, 512) and at the joint
            model's 2B, scaled20k fp32 at B=64 and scaled80k bf16 at B=32:
            fp32 bit-equal to bsr_grouped_spmm on t_bsr (else the first
            differing element), within 1e-5 (fp32) or one bf16 ulp (bf16)
            of max |y| of its twin; its time per call (CUDA events, median
            of 25) beside the twin, the earlier bsr_grouped_spmm call,
            torch.sparse (cuSPARSE CSR) and the byte bound (g, y and the
            CSR once each), after the events' own floor (a zero_ of 16
            floats). Every later P^T time comes from the same
            check-and-time (_pt_case) at that phase's shapes.
3c. cheb_mix  the basis mix and its weight gradient over the K orders
            as they lie (ops/csrc/cheb_mix.cu; no TPU kernel: the JAX
            package concatenates and leaves both to XLA) at every shape
            the cells' block-sparse convs give them: scaled80k bf16 levels
            0-3 (B = 32, K = 10), the joint80k train step's (its GCN's
            first conv 6 -> 16 packed at F_pad 8 at B = 32 on level 0,
            the decodes at 2B = 64 on levels 0-3) and config-1 / vae5k
            fp32 levels 0-1 (B = 16, K = 6). Each within one bf16 ulp (bf16) or 1e-5 (fp32)
            of max |y| of its twin on the card, two dW launches bit-equal;
            per call and per train step (CUDA events, median of 25): the
            kernels, their twin, the torch.cat + cuBLAS pair they replace
            (library), the cuBLAS products alone and the byte bound at
            3.35 TB/s. Phase 7 holds the launches per train and eval step
            (8 mix and 8 dW per 80k train step, 16 mix per eval step).
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
            Per train step: 35 bsr_grouped_spmm launches (bf16x3 at high,
            fp32 at highest) and 3 fp32 pool_transpose launches, each P^T
            once. The eval loss of a fixed
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
            own settings and overrides only for paths, folds 2 and epoch 2
            (and scan_epoch False: the per-step loop, whose readings phase
            15 compares with the scanned epoch's),
            train and test, the counts reset just before and read just
            after: 135 bf16 bsr_grouped_spmm and 4 bf16 pool_transpose
            launches per train step (each P^T once), 144 per eval step, no
            fp32 or bf16x3. History, checkpoint
            reload, finite test averages and a sex-change rate in [0, 1] are
            checked; the loss of a fixed batch falls over 5 more steps. Then
            the host-paced train step (CUDA events, median of 25),
            meshes/sec, peak memory, device busy and idle share. Three
            train steps with FUSED_SEED_DOT on: 135 + 4 launches per step, 45
            of them lazy-seed (enc_1, enc_2, dec_0, dec_2, dec_3 x 9), and
            the host-paced step beside the flag-off one. Then the bf16
            kernel per 80k shape and call kind (the lazy-seed kinds too)
            beside its twin, torch.sparse on the same operator in CSR (bf16
            where cuSPARSE takes it; plus the c_j GEMM for a lazy seed) and
            its byte bound.
7b. joint80k  the joint80k cell's model (meshbench/configs/joint80k.json's
            program: the joint VAE + GCN, K=10, batch 32, bf16, full width)
            on phase 7's 80k template, built by train/driver.py's
            build_model_and_ops and make_trainer as the k-fold driver
            builds it. One train step and one eval step on phase 7's
            meshes, the counts zeroed just before each: bsr_grouped_spmm
            per (operand, C, call kind) equal to JOINT80_CALLS (207 bf16
            launches: the 2B decode at C 1024 and 2048, the GCN's first
            conv at C 256 with its dx recurrence) and JOINT80_EVAL_CALLS
            (180), cheb_mix's mix and dW per (F_pad, F_out) equal to
            JOINT80_MIX_TRAIN (12 + 12) and JOINT80_MIX_EVAL (20 mixes),
            pool_transpose once per up-pool at 2B in the train step and
            never in the eval step; no fp32 or bf16x3 launch. Then the
            bf16 kernel per call kind at the train step's shapes beside
            its twin, torch.sparse and its bounds, summed per step, as
            phase 7's. (Phases 3, 3b and 3c hold the kernels against their
            twins at these shapes.)
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
            overrides for paths, folds 2, epoch 2, profile_dir and
            scan_epoch False (the per-step loop, as phase 7), the
            counts reset just before and read just after: per train step
            54 forward + 45 backward Laplacian calls + one pool_transpose per
            block-sparse up-pool, 36 of them lazy-seed; 108 per eval step;
            history, finite test averages, the loss of a fixed batch
            falling; one torch.profiler trace per fold, of epoch 2 only,
            and its top kernels by device time. Then the
            host-paced step flag on and off (CUDA events, median of 25),
            meshes/sec, peak memory beside the saved bases' size, device
            busy and idle share, and the fp32 kernel per 20k shape and call
            kind beside its twin, torch.sparse and its byte bound.
10. fused   TPU kernel #9 (cheb_conv_fused, ops/csrc/cheb_fused.cu: the
            occupied-tile engine's propagation and an in-CTA mix) on the
            card against its plain twin at the config-1 L0 and L1 convs
            (B=16, 16->16, K=6) and the scaled20k L0 conv (B=64, 16->16,
            K=10): the conv forward (1e-5) and its gradients (1e-4 of
            max|g|), at highest (and the bf16x3 split at config-1 L1). The
            launch count is reset before and read after these runs. Then
            the step on square synthetic operators (G = 1..9, padded
            slots, dense, empty and half-empty blocks; five (B, f_pad,
            f_out) shapes; both modes): T_k bit-equal to bsr_grouped_spmm
            with the same seed, T_k and acc within 1e-5 of their max (acc
            1e-4 at bf16x3); each real step the same, then its time per
            call in turns with torch.sparse + torch.matmul, its twin and
            both bounds (tile_probe.fused_bounds), and the conv forward and
            forward+backward beside the main-path cheb_conv_bsr at the
            same shapes, in turns (fused, bsr, bsr, fused).
11. emitted TPU kernel #10 (emitted_spmm, ops/csrc/emitted_spmm.cu: a
            persistent grid taking whole-row-block work items longest
            first, a producer warp feeding eight consumer warps through TMA
            copies and mbarriers, the engine's tile products) on the card
            against its plain twin and against bsr_grouped_spmm: fp32 at
            the config-1 L0 (C = 256) and the scaled20k L0 (C = 1024), bf16
            at the scaled80k L0 (B = 32, f = 16, C = 512; phase 7's
            operators); and on the tile probe's patterned operators (G =
            1..9 with padded slots, a dense block, a block with no set bit,
            every other strip empty, sparse tiles) at C = 128/512/2048 and
            1, 2 and the resident CTAs per SM: in fp32 bit-equal to
            bsr_grouped_spmm (the same tiles in the same order) and within
            1e-5 of the twin, in bf16 within one bf16 ulp of max |y| of
            both. Then its path, the probe (bench/emitted_probe.py main) at
            --workload 5k --compute-dtype float32 --batch-size 16 (C =
            256), --workload 20k --compute-dtype float32 and --workload 80k
            (bf16), the launch counts reset just before and read just
            after: emitted at resident, 1 and 2 CTAs per SM, grouped and
            torch.sparse in turns (A B C D E E D C B A), both bounds, the
            kernel's registers and shared memory; and the twin's time at
            the probe's shapes.
12. infer   the batch-inference entry point at config 1: 32 synthetic
            meshes, a checkpoint_1.pt of the seeded weights and their
            norm.npz; ``python -m meshvae_tpu_torch.infer``'s main on the
            card (counts reset just before, read just after: 20 launches
            per batch of 16, bf16x3 at high, fp32 at highest) and with
            --device cpu: pred.json equal, inference.json's errors and
            every sex_change/ .obj within 1e-4 of the mesh scale; then the
            warm card pass in meshes/sec with and without --no-meshes
            (through run_inference, the device pass alone, the whole CLI).

13. tiles   the occupied-tile design of bsr_grouped_spmm
            (bench/tile_probe.py): synthetic operators with G = 1..9 and
            padded slots, a dense block, a block with no set bit, empty
            strips and sparse tiles, at C = 64/512/2048 in all three modes
            against the twin and in fp32 bit for bit against emitted_spmm,
            the lazy seed at f = 8/16/32/128; bsr_grouped_spmm's
            fingerprints (digests of its outputs per mode over fixed
            inputs) equal to those recorded before its engine moved into
            csrc/tile_engine.cuh; the 5k, 20k and 80k level 0: occupancy,
            fp32 bit-equal to emitted_spmm, bf16 within one ulp of the
            twin; per-call times of bsr_grouped_spmm, emitted_spmm (#10,
            the same tile products behind TMA) and torch.sparse at C =
            512, in turns, beside both bounds.

14. distribution (parallel/, ops/bsr_shard.py; _mapped_product,
            meshvae_tpu/ops/pallas_shard.py:150, is bsr_grouped_spmm on a
            rank's row shard fed by an all-gather over sp):
            a. in one process, every shard of the config-1 L0/L1 (fp32,
               bf16x3), scaled20k L0/L1 (fp32) and scaled80k L0 (bf16)
               Laplacians at sp 2 and 4 (the shapes printed): the kernel
               on each shard with no seed, t_prev, t_plus, both and the
               lazy seed (not in bf16x3) against its twin (1e-5 of max|y|,
               one bf16 ulp in bf16), and the stacked shards bit-equal to
               the unsharded call in fp32 and bf16 (within 1e-5 in
               bf16x3; measured bit-equal too);
            b. dp=2: a gloo world of two ranks sharing cuda:0 (rank 0 in
               this process, rank 1 spawned) at config 1, full width, high
               and highest: two deterministic steps (no dropout, z = mu),
               each against one process from the same state: loss within
               1e-5 relative, every gradient within 1e-4 (highest) / 1e-3
               (high) of its layer's max|g| (phase 6's bars), the world's
               params equal to Adam on its gradients (1e-2 lr), every
               rank's params bit-equal, launches per rank equal to one
               process's;
            c. sp=2: the same at scaled80k bf16, full width (K=10, B=32),
               in the row layout (x and every activation at a
               block-sparse level are the rank's rows of it), two steps
               and one eval step at phase 8's bar (closer to one process
               in bf16 than that is to fp32, plus one bf16 ulp of the
               scale), launches per rank = one process's Laplacian calls
               at the shard shapes plus its P^T calls at the pool shards'
               (the input level's rows of P^T, the output level's gathered
               rows of g); each rank's memory per train step (the peak of
               its process and the step's own) beside one process's step
               from the same state; then a MeshServer in that world
               (dp=1, sp=2) at config 1 high answering 20 meshes: pred
               equal, errors within 1e-4 of the mesh scale;
            d. times: each world's step (host clock), its all-gathers and
               all-reduces per step with their bytes, replayed one by one
               for their time, rank 0's device busy time and idle share
               (labelled a shared-card gloo world, never a scaling
               result); _mapped_product per call at rank 0's sp=2 80k
               shard shapes against its twin, torch.sparse on the shard's
               CSR rows and both bounds, summed per train step; and
               pool_transpose on rank 0's shard of each 80k up-pool's P^T
               against its twin, torch.sparse and the byte bound;
            e. crecon (config 2: a seeded config-1 VAE frozen, GCN K=6,
               hidden 128) and the joint model (config 3, files/joint.cfg)
               at B=16 and high in a dp=2 and an sp=2 world (two gloo
               ranks on cuda:0): two deterministic train steps and an eval
               step of the padded third batch, each train step held
               against one process on the card at b's bars, the eval loss
               within 1e-5 relative, every rank's params bit-equal,
               launches per rank equal to one process's (under sp, in the
               row layout as every model: its Laplacian calls at the row
               shards, its P^T at the pool shards) and to CRECON_CALLS /
               JOINT_CALLS (35 / 30 per train / eval step; 55 + 3 P^T /
               50), each rank's step memory beside one process's (the
               classifier_memory lines), each world's step times and
               collectives as in d;
            f. the kernel against its twin (1e-5 of max|y|) at every
               (shape, C, call kind) rank 0 launched in e;
            g. the classifiers' calls per train step timed at rank 0's
               shapes (dp=2: B=8 per rank on the whole operators; sp=2:
               B=16 on the row shards, the joint model's up-pool 0-1 P^T
               on rank 0's pool shards [640 x 5120] and [313 x 1280],
               each held against its twin) beside the twin, torch.sparse
               and the bounds;
            h. sp=2 with cheb_method ell: the VAE at scaled80k bf16, full
               width, every level of at least BSR_MIN_N vertices as the
               rank's rows of its neighbour list: two train steps and an
               eval step at c's bars, replicas bit-equal, launches per
               rank (pool_transpose alone, at the pool shards) equal to
               one process's, each rank's step memory beside one
               process's (the ell_sp_memory line), step times and
               collectives as in d.

15. scan    the scanned epoch (train/loop.py, train/graphs.py): at config
            1 high and highest (B=16), scaled20k fp32 with FUSED_SEED_DOT
            (B=64) and scaled80k bf16 (B=32), all at full width, two
            trainers from the same seeded weights, one replaying CUDA
            graphs of the steps and one running the same steps eagerly,
            over the same staged epoch of 4 steps (drawn from phases 6, 7
            and 9's synthetic meshes, the last quarter of the last step
            padding), permutations and generator seed: one replayed step
            (an epoch of two: the warm-up, then the first replay), then
            three epochs at lr, lr / 2 and 0 (the last one on one batch at
            every step), the counts reset just before and read just after:
            the loss per step, every gradient, the params and Adam's state
            bit-equal (else held to the train bars: loss 1e-5 relative,
            gradients and moments 1e-4 / 1e-3 / one bf16 ulp of the layer's
            max, params 1e-2 lr per step, and printed), the same launches
            per step as the eager steps and as phases 6, 7 and 9 count
            them, and one phase mark per slot and step (train/phases.py
            LAUNCHES, a replay's counted from its capture; the evals' too);
            at lr 0 the params stay as they were and the replays
            draw a new loss each; the light, errors and collect evals equal
            to the eager ones, and within 1e-5 (loss) and 1e-4 of the mesh
            scale of evaluate(); no host sync in an eager scanned epoch
            (torch's sync debug mode). Then the per-step time of an epoch
            (CUDA events over the epoch / 4) in turns eager, graphed,
            graphed, eager, beside the per-step loop (train_epoch); device
            busy time, idle share, kernels and host calls that queue device
            work per step (torch.profiler); peak allocated and reserved
            memory (the graph pools included); each graph's capture
            seconds. Last, run() with files/default.cfg (scan_epoch left at
            its default) at config-1 width on the block-sparse path, train,
            test and -v on phase 6's 40 meshes, 2 folds x 2 epochs, with
            profile_dir: 35 + 3 pool_transpose launches per train step and
            40 per eval step,
            never the per-step loop, the history, checkpoints and .obj
            triples, epoch 2's trace holding bsr_grouped_spmm, and the log
            line naming the graphs.
15b. marks  the phase mark kernel (ops/csrc/phase_mark.cu, train/phases.py
            Marks) in a captured, replayed step (train/graphs.py StepGraph)
            at the benchmark cells' stamps: [16, 5] and [4, 3] (vae80k train
            and light eval), [32, 5] and [8, 3] (vae5k), filled with a
            sentinel. After each replay the written cells are those the CPU
            path (host clock, same Marks) has written after as many steps:
            the replay's own row, every slot, and the earlier rows as they
            were; the stamps never decrease; LAUNCHES counts one per slot and
            replay. Then the device time of a mark and of the plain write of
            the same cell (index_fill_ at the device step index), each
            replayed as a graph of 100 (CUDA events).

16. classifiers  the two classifier pipelines at config-1 width on the
            block-sparse path at high (BASELINE configs 2 and 3):
            a. crecon: train/crecon_driver.run() (python -m
               meshvae_tpu_torch.crecon's body) with files/crecon.cfg on
               phase 6's 40 meshes, phase 15's default.cfg fold-1
               checkpoint as the frozen VAE, 5 folds x 2 epochs, train and
               test, the counts reset just before and read just after: 35
               launches per train step (30 forward: the VAE's encode at B
               and decode at 2B, the GCN's two block-sparse convs; cheb_1's
               dx) and 30 per eval step; the log line naming the CUDA
               graphs; five test results; every fold's checkpoint reloads;
            b. the joint model: train/driver.run() with files/joint.cfg, 2
               folds x 2 epochs, train, test and -v: 55 Laplacian launches
               per train step (30 forward, 25 backward: all convs but
               enc_0) + 3 P^T at 2B width, 50 per eval step (with the
               counterfactual); sup_accuracy and adv_accuracy in every
               history epoch and test result, the P^T launches counted
               per operator (launches_by_shape()): each once per train step;
            c. bsr_grouped_spmm against its twin at every (mode, operator,
               C, call kind) that a, b and d launched (LAUNCHES_BY_CALL) and
               phase 3 did not (GCN cheb_0's dx at C = 128, the 2B
               decoder's backward at C = 512; in fp32 too), 1e-5 of max|y|
               (pool_transpose is held at the P^T's C = 512 and 1024 in
               d's timings); and one deterministic crecon and
               joint train step
               (no dropout, z = mu) on the card and on the CPU from the
               same weights at high and highest: loss within 1e-5
               relative, every gradient within 1e-3 / 1e-4 of its layer's
               max|g|;
            d. per-step times of the crecon and joint train steps at high
               and highest over a staged epoch of 4 (CUDA events, eager,
               graphed, graphed, eager), meshes/sec, device busy and idle
               share, the calls per replayed step equal to CRECON_CALLS /
               JOINT_CALLS, and those calls' kernel, twin, torch.sparse and
               bound sums per step.

17. bf16 paths  at config-1 width on the block-sparse path (template5k,
            K=6, filters 16/16/16/32/32, hidden 512, latent 16), the counts
            reset just before each main-path run and read just after:
            a. a MeshServer at compute_dtype bfloat16, B=16, answering phase
               4's three request lines through serve_forever: 20 mode-bf16
               launches per serving step and none in another mode, the
               calls per step as SERVE_CALLS; one step on the card and on
               the CPU (bf16, and fp32 at highest as the yardstick) from
               the same weights at phase 8's bar, pred equal where the
               CPU's bf16 logits are settled (more than two bf16 ulps
               apart; at most a quarter of the rows excused); the serving
               step's time (50 host-paced steps, CUDA events), peak memory,
               busy time and idle share;
            b. BASELINE config 4: python -m meshvae_tpu_torch.infer's main
               with -p compute_dtype bfloat16 -p batch_size 128 over 256
               synthetic meshes (two batches): 20 bf16 launches per batch
               (CONFIG4_CALLS); the first batch with --device cpu in bf16
               and in fp32 at highest, held as in a; meshes/sec with the
               .obj triples (the main-path run) and with --no-meshes; then
               a scaled80k bf16 inference run (B=32, --no-meshes) on phase
               7's fold-1 checkpoint: 72 bf16 launches per batch;
            c. phase 16's a, b and d at compute_dtype bfloat16 (the same
               code): 35 and 55 + 3 bf16 launches per train step, 30 and
               50 per eval step; one deterministic crecon step on seeded
               weights and one joint step, card vs CPU at phase 8's bar;
               the crecon step behind phase 15's trained VAE, whose x -
               recon cancels, at the bar for cancelling features (the card
               and the witness, the same step on the card with the twin in
               the kernel's place, each within twice the CPU's bf16 error
               of its fp32 plus one ulp; a second card run within one
               ulp); graphed and eager step times at B=16 and B=128;
            d. phase 16b's joint checkpoint through the inference CLI at
               high (20 bf16x3 launches per batch) and a MeshServer, card
               vs --device cpu at phase 12's bars (pred equal, errors and
               .obj within 1e-4 of the mesh scale);
            e. bsr_grouped_spmm against its twin at every (mode, operator,
               C, call kind) that a-d launched and phases 3 and 16 did not
               (one bf16 ulp of max|y| in bf16, 1e-5 otherwise); the bf16
               kernel, twin, torch.sparse (bf16 CSR) and bound sums per
               bf16 serving step, config-4 batch and bf16 crecon and joint
               train step.

18. reference migration  imported reference weights on the reference
            hierarchy, and the two remaining operator methods:
            a. template5k's hierarchy with hierarchy_mode reference (the
               bit-exact QSlim and the reference up-transfer) built on the
               host into the cache that holds the fast one (seconds,
               levels; D must differ from the fast one's and the cache
               must hold both), its config-1 operators (n_pad, blocks, G
               of L0, L1 and P0T-P2T, fp32 blocks for modes fp32 and
               bf16x3);
            c. a reference-layout checkpoint {'state_dict': ...} at config-1
               width from a seeded torch.Generator (reference names, [out,
               in] Linear weights, the dead dec_lin_1 and a buffer) and a
               cheb_GCN one, each through python -m
               meshvae_tpu_torch.train.torch_import on the card (the
               config leaves hierarchy_mode out, so the CLI forces
               reference; every value lands at its port name); the
               inference CLI with hierarchy_mode reference over 32
               synthetic meshes on the card (20 bf16x3 launches per batch)
               and with --device cpu (phase 12's bars); a MeshServer at
               high and at highest (20 launches per serving step), card vs
               CPU on one step (phase 4's bars); one crecon eval step, the
               imported GCN behind the imported VAE, card vs CPU (loss
               1e-5 relative, logits 1e-4 of their max);
            d. one deterministic train step (no dropout, z = mu) from the
               imported weights at high, card vs CPU at phase 6's bars: 35
               bf16x3 Laplacian launches and each reference P^T once;
            e. one deterministic train step at highest on phase 6's seeded
               weights, card vs CPU at phase 6's bars, for cheb_method ell
               (no Laplacian launch, the three P^T), pallas with
               pool_method dense (35 Laplacian launches, no P^T) and ell
               with the dense pool (no launch); each of them and the
               default pallas + gather timed per step of a scanned epoch
               (median of 25 epochs), eager and graphed in turns (A B B A),
               and the eager step's own peak memory;
            f. the ELL step at scaled20k fp32 (B=64) and scaled80k bf16
               (B=32) where validate.ell_step_bytes says it fits: its peak
               memory beside the formula and beside the block-sparse
               step's, both steps' host-paced times, the ELL step's top
               kernels (torch.profiler); validate_config
               refusing scaled80k fp32 at B=2048 without running it;
            b. (last) bsr_grouped_spmm against its twin on the reference
               operators at every (mode, operator, C, call kind) that c-e
               launched (1e-5 of max|y|), and the kernel, twin,
               torch.sparse and bound sums per step on them; the phase's
               seconds.

19. export  the serving export (infer/export.py) at config 1 (template5k,
            B=16, phase 4's weights and requests): a. python -m
            meshvae_tpu_torch.infer's main with --export-serve and --export
            at high, --export-platforms cuda,cpu, on a checkpoint_1.pt of
            the weights and phase 4's norm (seconds, MB, the headers); b. a
            fresh process of --serve --artifact answering phase 4's three
            request lines, beside a --serve process on the warm hierarchy
            cache (seconds to the ready line), both against a warm
            MeshServer (sex equal, errors within 1e-4 of the mesh scale);
            c. one artifact step: exactly 20 launches in mode bf16x3
            through the registered operator's CUDA implementation; the
            artifact's cpu lowering (the twin) against its cuda one at
            phase 4's bars; a highest artifact (mode fp32, 20 launches)
            against the live engine at phase 4's bars; d. a compute_dtype
            bfloat16 artifact of phase 17a's weights: 20 launches in mode
            bf16, it and the warm bf16 MeshServer each held at phase 17a's
            bar; then one step of each
            artifact in a torch.profiler window, each in a fresh process
            of its own (in this one, after the earlier phases' windows, a
            window saw 10 of the 20, and so did the third window of one
            fresh process): 20 bsr_grouped_spmm_kernel launches of the mode's
            instantiation, none counted by the eager wrapper, and their
            device time; e. the --export contract against
            InferenceEngine.step on the same batch at 1e-6; f. host-paced
            steps (CUDA events, median of 50, in turns A B C C B A, twice):
            MeshServer.serve_step, the artifact step, and serve_step with
            every kernel call dispatched through the registered operator;
            peak memory; the host's cost of one kernel call, direct and
            through the operator (device backlogged), times the step's 20;
            the kernel's device time per artifact step.
20. experimental  models/experimental.py and the post-hoc entry points, on
            the dense path (no kernel of the port may launch: every launch
            counter is read before and after the phase and must not move).
            Weights in flax's layout drawn by numpy from a fixed seed,
            carried across by params_from_flax, one copy on the card and
            one on the CPU. Template5k's level-0 (4,998) and level-1
            (1,250) operators with cheb_method dense. At B=16:
            EqualLinear 512->512 and GraphNorm on [16, 512],
            AdaptiveInstanceNorm on [16, 4998, 16] with a style of 16,
            SpatialConv 16->16 on level 0, GraphAttention 16->16 on level 1
            at B=16 and on level 0 at B=4 (16 x 4998^2 fp32 logits are
            1.6 GB per tensor on the CPU side), DiffPool 4998->1250 with
            adj = |sign(L0)|, sort_pool with k=1250 and PointCNN over
            [16, 4998, 3] in train mode, then eval mode on the updated
            statistics. Card against CPU: forward within 1e-5 of max|y|,
            the gradient of the output's sum within 1e-4 of each layer's
            max|g|, PointCNN's batch_stats within 1e-6 of their max,
            sort_pool bit for bit; each module's card ms (CUDA events,
            median of 10, forward + backward), CPU ms (one call) and peak
            device memory. The two sums the port writes its own way
            against fp64 (printed): DiffPool's link loss on the CPU
            (torch.linalg.norm beside the root of the summed squares)
            and PointCNN's conv on the card (F.conv1d beside the one
            einsum product). pc2mesh on the template's vertices (host
            seconds, faces). python -m meshvae_tpu_torch.report -p -e -j
            on phase 12's inference.json (its counts against that file),
            and plot_losses's data part on phase 15's history files (the
            metric names and epochs; drawn when matplotlib imports, else
            "plot: matplotlib absent, not drawn").

Phase 3 also holds the bf16 mode on the card at every 80k Laplacian (its C
values, alpha 1 and 2, no seed, t_prev, t_plus, both) and the four P^T:
max |kernel - twin| <= 2^-8 max |twin| (one bf16 ulp: both round once),
and prints the share of bit-equal outputs.

Every bsr_grouped_spmm table gives two bounds: bytes with only the
occupied 16x16 tiles (the kernel's bound_ms) and bytes with the blocks as
stored (the bound of the earlier design, bound_stored_ms). Every P^T
launch is pool_transpose's, counted by its own LAUNCHES (per mode) and
LAUNCHES_BY_SHAPE; the launch tables hold them as "pool fp32" / "pool
bf16" (launch_modes, launch_shapes, launch_calls), beside
bsr_grouped_spmm's modes.

The line before the last is {"kernels": [...]}: per serving step (the two
bsr_grouped_spmm[mode] entries, summed over the step's 20 calls), per
config-1 train step (the Laplacian calls in each mode; pool_transpose on
the P^T of up-pools 0-1, which the JAX package runs column-major, #7, and
of up-pool 2, grouped, #4), per 80k bf16 train step (the Laplacian calls,
#3b; pool_transpose on the P^T of up-pool 0, which the JAX package runs per
block, #5, and of up-pools 1-3, #7), bsr_grouped_spmm's bf16x3 P^T at phase
3's shapes (#8, and #6 at the both-seed shape where the JAX package runs
per block; no model path launches them), per scaled20k
train step (the plain Laplacian calls, the lazy-seed calls #4b in fp32,
the P^T), the lazy-seed calls of an 80k bf16 step with the flag on (#4b in
bf16), the fused step (#9) per scaled20k L0 conv forward, the inference
CLI's calls per batch (the serving step's shapes), and emitted_spmm (#10)
per call at the probe's three shapes, and _mapped_product (phase 14d,
per sp=2 80k train step on rank 0's shards, with its shard shapes), with
the launches of the main-path runs (each probe run's for #10; the sp=2
world's per rank for _mapped_product), and phase 14g's crecon and joint
train steps in the dp=2 and sp=2 worlds (rank 0's Laplacian calls, on its
row shards under sp, and the joint model's P^T, on its pool shards under
sp; launches of rank 0 over 14e's steps), and the train-step calls of phase
15's graphed epochs (config-1 Laplacian in both modes and its P^T, the 20k
lazy seed, the 80k Laplacian: launches counted per replay, times as
measured above),
and phase 16's crecon and joint train steps (the Laplacian calls in both
modes, the joint model's P^T of up-pools 0-1 and 2 at 2B width: launches
of the run()s at high, of a counted replayed epoch at highest), and
phase 17's bf16 serving step, config-4 batch and bf16 crecon and joint
train steps (Laplacian calls, the joint model's bf16 P^T; launches of the
main-path runs), and phase 18's calls on the reference operators (the
inference CLI per batch, the MeshServers' serving steps, the fine-tuning
step's Laplacian and P^T calls, the dense-pool step's Laplacian calls and
the ELL step's P^T; launches of 18c-e), and phase 19's artifact steps at
high, highest and bf16 (launches and kernel time from the profiler window
of one step; the twin, library and bound of the same calls from phases 5
and 17), and phase_mark (train/phases.py) per mark: launches of phase 15's
graphed config-1 high epochs (its train and eval marks), max_abs_err the
cells phase 15b's replays wrote apart from the CPU path's, ms and plain_ms
phase 15b's. Each pool_transpose entry also carries earlier_ms, the time of
the bsr_grouped_spmm calls it replaced at the same shapes. The last line
is {"ok": true, ...}.
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
# per-step sums of the kernel tables: times, the two bounds (occupied
# tiles; blocks as stored) and the bytes and operations parts of the first
ACC_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms",
            "stored_ms")
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
SOURCE_MIX = "meshvae_tpu_torch/ops/csrc/cheb_mix.cu"
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
SCALED_TRAIN_LAUNCHES = 135  # 8 convs x 9 forward, 7 x 9 backward
SCALED_POOL_LAUNCHES = 4     # and each up-pool's P^T (pool_transpose)
SCALED_EVAL_LAUNCHES = 144   # 72 forward + the counterfactual's 36 + 36
# with FUSED_SEED_DOT: the square mixes cheb_enc_1 (L1), cheb_enc_2 (L2),
# cheb_dec_0 (L3, 32 -> 32), cheb_dec_2 (L1) and cheb_dec_3 (L0) x 9;
# cheb_enc_3 (16 -> 32) and cheb_dec_1 (32 -> 16) stay eager
SCALED_SEED_DOT = 45
FLAG_STEPS = 3
# the block-sparse convs' basis mixes: (level, n_pad, F_pad, F_out, calls
# per train step[, rows per mesh batch where not the cell's B]) of each
# cell, each call a mix and a dW
MIX_CELLS = {
    "scaled80k bf16": (SCALED_BATCH, 10, "bfloat16", (
        ("L0", 80000, 4, 16, 1), ("L0", 80000, 16, 16, 1),
        ("L1", 20096, 16, 16, 2), ("L2", 5120, 16, 16, 1),
        ("L2", 5120, 32, 16, 1), ("L3", 1280, 16, 32, 1),
        ("L3", 1280, 32, 32, 1))),
    "config-1 fp32": (BATCH, 6, "float32", (
        ("L0", 5120, 8, 16, 1), ("L0", 5120, 16, 16, 1),
        ("L1", 1280, 16, 16, 2))),
    # the encoder and the GCN at B (cheb_0: 6 -> 16 packed at F_pad 8),
    # the two decodes as one pass at 2B; last, so the cells above keep
    # their inputs
    "joint80k bf16": (SCALED_BATCH, 10, "bfloat16", (
        ("L0", 80000, 4, 16, 1), ("L0", 80000, 8, 16, 1),
        ("L0 2B", 80000, 16, 16, 1, 2 * SCALED_BATCH),
        ("L1", 20096, 16, 16, 2),
        ("L1 2B", 20096, 16, 16, 1, 2 * SCALED_BATCH),
        ("L2", 5120, 16, 16, 2),
        ("L2 2B", 5120, 32, 16, 1, 2 * SCALED_BATCH),
        ("L3", 1280, 16, 32, 2),
        ("L3 2B", 1280, 32, 32, 1, 2 * SCALED_BATCH))),
}
# one mix per block-sparse conv call (K - 1 = 9 launches of the kernel):
# 8 a train step, each with its dW, and 16 an eval step
SCALED_MIX_TRAIN, SCALED_MIX_EVAL = 8, SCALED_EVAL_LAUNCHES // 9
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


def reset_launches():
    """Zero the launch counts of the model paths' kernels,
    bsr_grouped_spmm, pool_transpose (the pool backward's P^T), cheb_mix
    (the basis mix and dW) and the scanned steps' phase marks, just before
    a main-path run."""
    from meshvae_tpu_torch.ops import bsr_spmm, cheb_mix, pool_transpose
    from meshvae_tpu_torch.train import phases

    bsr_spmm.reset_launches()
    pool_transpose.reset_launches()
    cheb_mix.reset_launches()
    phases.reset_launches()


def pt_counts() -> tuple[dict, dict]:
    """pool_transpose's launches per mode and per (mode, n_in, n_out, C)."""
    from meshvae_tpu_torch.ops import pool_transpose

    return (dict(pool_transpose.LAUNCHES),
            dict(pool_transpose.LAUNCHES_BY_SHAPE))


# the keys of launch_modes(): bsr_grouped_spmm's modes, then
# pool_transpose's as "pool " + its mode
LAUNCH_KEYS = ("fp32", "bf16x3", "bf16", "pool fp32", "pool bf16")


def launch_modes() -> dict:
    """Launches per LAUNCH_KEYS entry: bsr_grouped_spmm's per mode and
    pool_transpose's (the P^T) per "pool " + mode."""
    from meshvae_tpu_torch.ops import bsr_spmm

    return {**bsr_spmm.launches(),
            **{f"pool {m}": v for m, v in pt_counts()[0].items()}}


def launch_shapes() -> dict:
    """bsr_grouped_spmm's launches_by_shape() with pool_transpose's launches
    added under ("pool " + mode, n_in, n_out), summed over C."""
    from meshvae_tpu_torch.ops import bsr_spmm

    out = bsr_spmm.launches_by_shape()
    for (mode, n_in, n_out, _), v in pt_counts()[1].items():
        key = (f"pool {mode}", n_in, n_out)
        out[key] = out.get(key, 0) + v
    return out


def launch_calls() -> dict:
    """bsr_grouped_spmm's LAUNCHES_BY_CALL with pool_transpose's launches
    added as calls ("pool " + mode, n_in, n_out, C, "a1")."""
    from meshvae_tpu_torch.ops import bsr_spmm

    return {**bsr_spmm.LAUNCHES_BY_CALL,
            **{(f"pool {m}", n_in, n_out, c, "a1"): v
               for (m, n_in, n_out, c), v in pt_counts()[1].items()}}


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

    names = ["bsr_spmm", "cheb_fused", "emitted_spmm", "pool_transpose",
             "phase_mark", "cheb_mix"]
    t0 = time.perf_counter()
    logs = _build.build_libraries(names)
    for name in names:
        _build.load_library(name)
    say(f"build_sec {time.perf_counter() - t0:.2f} "
        f"({'compiled ' + ', '.join(logs) if logs else 'already built'})")
    for name in names:
        for row in _build.ptxas_table(logs.get(name, "")):
            say(f"  ptxas[{name}] {row['kernel']}: {row['registers']} "
                f"registers, {row['smem']} B static shared memory, spill "
                f"stores {row['spill_stores']} B, loads {row['spill_loads']} B")
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
    have taken the kernel's (launches_seed_dot()). Returns (abs, rel) err."""
    from meshvae_tpu_torch.ops import bsr_spmm

    alpha, kw = _seed_args(kind, seeds)
    before = bsr_spmm.launches_seed_dot()
    y = bsr_spmm.bsr_grouped_spmm(bsr, x, mode, alpha, **kw)
    torch.cuda.synchronize()
    ref = bsr_spmm.bsr_grouped_spmm_reference(bsr, x, mode, alpha, **kw)
    lazy = bsr_spmm.launches_seed_dot()[mode] - before[mode]
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


def phase_pool_transpose(torch, ops, s20, s80, dev):
    """Phase 3b: pool_transpose at every P^T shape of the model paths: the
    config-1 train step (B=16: C = 256, 256, 512), the joint model at 2B
    (B=32), scaled20k fp32 (B=64), scaled80k bf16 (B=32) and the joint80k
    decode's at 2B (B=64); each held
    (bit-equal to bsr_grouped_spmm on t_bsr in fp32, one bf16 ulp of the
    twin in bf16) and timed beside its twin, the earlier
    bsr_grouped_spmm call, torch.sparse and the byte bound (_pt_case),
    after the events' floor (a one-kernel zero_). Returns the worst
    absolute error per mode."""
    say("== phase 3b: pool_transpose (the pool backward's P^T) vs "
        "bsr_grouped_spmm and its twin, per call (median of %d, CUDA "
        "events)" % RUNS)
    gen = torch.Generator(device=dev).manual_seed(31)
    cases = [(f"config-1 up-pool {i} P^T", ops.up[i], BATCH) for i in
             (0, 1, 2)]
    cases += [(f"joint 2B up-pool {i} P^T", ops.up[i], 2 * BATCH)
              for i in (0, 1, 2)]
    cases += [(f"scaled20k up-pool {i} P^T", up, SCALED20_BATCH)
              for i, up in enumerate(s20["ops"].up) if up.t_ptr is not None]
    cases += [(f"scaled80k up-pool {i} P^T", up, SCALED_BATCH)
              for i, up in enumerate(s80["ops"].up)]
    cases += [(f"joint80k 2B up-pool {i} P^T", up, 2 * SCALED_BATCH)
              for i, up in enumerate(s80["ops"].up)]
    tiny = torch.zeros(16, device=dev)
    say(f"  the timing's floor: one zero_ of 16 floats "
        f"{1e3 * time_ms(torch, tiny.zero_):.1f} us between its events")
    worst, rows = {"fp32": 0.0, "bf16": 0.0}, []
    for tag, up, b in cases:
        f = POOL_F[int(tag.split("up-pool ")[1][0])]
        got = _pt_case(torch, up, b, f, dev, gen, tag)
        worst[got["row"]["mode"]] = max(worst[got["row"]["mode"]],
                                        got["err_abs"])
        rows.append(got["row"])
    say("shape_rows_pool_transpose " + json.dumps(rows))
    say(f"checked pool_transpose at {len(rows)} shapes: worst abs error "
        f"{worst}; fp32 bit-equal to bsr_grouped_spmm at every shape")
    return worst


def _bf16_ulp(scale: float) -> float:
    """One bf16 ulp at `scale` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _mix_case(torch, cm, k, m, f, f_out, dtype, gen, dev, tag):
    """One shape's mix and dW against the twin on the card, then per call
    times: kernel (mix, dW), twin, library (torch.cat and the two cuBLAS
    products), cuBLAS alone, the byte bound."""
    txs = [torch.randn(m, f, device=dev, generator=gen).to(dtype)
           for _ in range(k)]
    w = (0.3 * torch.randn(k, f, f_out, device=dev, generator=gen)).to(dtype)
    g = torch.randn(m, f_out, device=dev, generator=gen).to(dtype)
    before = dict(cm.LAUNCHES)
    out, dw, dw2 = cm.cheb_mix(txs, w), cm.cheb_mix_dw(txs, g), \
        cm.cheb_mix_dw(txs, g)
    torch.cuda.synchronize()
    mode = cm.DTYPES[dtype]
    for kind, n in (("fwd", 1), ("dw", 2)):
        key = (kind, mode, k, f, f_out)
        if cm.LAUNCHES.get(key, 0) - before.get(key, 0) != n:
            fail(f"{tag}: cheb_mix {kind} was not launched {n} times")
    if not torch.equal(dw, dw2):
        fail(f"{tag}: two dW launches differ")
    err = {}
    for name, got, want in (("mix", out, cm.cheb_mix_reference(txs, w)),
                            ("dW", dw, cm.cheb_mix_dw_reference(txs, g))):
        scale = want.float().abs().max().item()
        bar = (TOL_KERNEL * scale if dtype == torch.float32
               else _bf16_ulp(scale))
        err[name] = (got.float() - want.float()).abs().max().item()
        if not err[name] <= bar:
            fail(f"cheb_mix disagrees with its twin: {tag} {name} "
                 f"{err[name]:.3e} > {bar:.3e}")
    txcat = torch.cat(txs, dim=-1)
    w2 = w.reshape(k * f, f_out)

    def library():
        cat = torch.cat(txs, dim=-1)
        torch.matmul(cat, w2)
        torch.matmul(cat.t(), g)

    size = txs[0].element_size()
    bound = 1e3 * (k * m * f + m * f_out + k * f * f_out) * size \
        / HBM_BYTES_PER_S
    row = dict(
        shape=tag, mode=mode, k=k, m=m, f_pad=f, f_out=f_out,
        mix_ms=time_ms(torch, lambda: cm.cheb_mix(txs, w)),
        dw_ms=time_ms(torch, lambda: cm.cheb_mix_dw(txs, g)),
        plain_ms=time_ms(torch, lambda: (cm.cheb_mix_reference(txs, w),
                                         cm.cheb_mix_dw_reference(txs, g))),
        library_ms=time_ms(torch, library),
        cublas_ms=time_ms(torch, lambda: (torch.matmul(txcat, w2),
                                          torch.matmul(txcat.t(), g))),
        mix_bound_ms=bound, dw_bound_ms=bound,
        err_mix=err["mix"], err_dw=err["dW"])
    say(f"  {tag}: mix {row['mix_ms']:.4f} ms ({bound / row['mix_ms']:.1%} "
        f"of the byte bound {bound:.4f}), dW {row['dw_ms']:.4f} ms "
        f"({bound / row['dw_ms']:.1%}); twin {row['plain_ms']:.4f}, cat + "
        f"cuBLAS {row['library_ms']:.4f}, cuBLAS alone "
        f"{row['cublas_ms']:.4f}; max err mix {err['mix']:.2e}, dW "
        f"{err['dW']:.2e}")
    return row


def phase_mix(torch, dev):
    """Phase 3c: cheb_mix at the cells' shapes (MIX_CELLS), held against
    its twin and timed beside it, the torch.cat + cuBLAS pair it replaces,
    the cuBLAS products alone and the byte bound. Returns, per cell, the
    per-train-step sums (ms = mix + dW) and the worst absolute error."""
    say("== phase 3c: cheb_mix (the basis mix and dW over the K orders) vs "
        "its twin, torch.cat + cuBLAS and the byte bound, per call (median "
        "of %d, CUDA events)" % RUNS)
    from meshvae_tpu_torch.ops import cheb_mix as cm

    gen = torch.Generator(device=dev).manual_seed(41)
    out, rows = {}, []
    for cell, (b, k, dtype_name, shapes) in MIX_CELLS.items():
        dtype = getattr(torch, dtype_name)
        acc = dict.fromkeys(("ms", "mix_ms", "dw_ms", "plain_ms",
                             "library_ms", "cublas_ms", "bound_ms"), 0.0)
        worst, calls = 0.0, 0
        for level, n_pad, f, f_out, count, *rows_b in shapes:
            row = _mix_case(torch, cm, k, n_pad * (rows_b or [b])[0], f,
                            f_out, dtype, gen, dev,
                            f"{cell} {level} {f}->{f_out}")
            row["per_step"] = count
            rows.append(row)
            for key in ("mix_ms", "dw_ms", "plain_ms", "library_ms",
                        "cublas_ms"):
                acc[key] += count * row[key]
            acc["bound_ms"] += count * (row["mix_bound_ms"]
                                        + row["dw_bound_ms"])
            worst = max(worst, row["err_mix"], row["err_dw"])
            calls += count
        acc["ms"] = acc["mix_ms"] + acc["dw_ms"]
        acc["bytes_ms"], acc["ops_ms"] = acc["bound_ms"], 0.0
        say(f"per {cell} train step ({calls} mix + {calls} dW calls): "
            f"kernels {acc['ms']:.3f} ms (mix {acc['mix_ms']:.3f}, dW "
            f"{acc['dw_ms']:.3f}), twin {acc['plain_ms']:.3f}, cat + cuBLAS "
            f"{acc['library_ms']:.3f}, cuBLAS alone {acc['cublas_ms']:.3f}, "
            f"byte bound {acc['bound_ms']:.3f} ms "
            f"({acc['bound_ms'] / acc['ms']:.1%} of it); no slower than "
            f"cuBLAS alone: {acc['ms'] <= acc['cublas_ms']}")
        out[cell] = {"acc": acc, "worst": worst, "calls": 2 * calls}
    say("shape_rows_cheb_mix " + json.dumps(rows))
    return out


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
    reset_launches()
    outs = {}
    for p, server in servers.items():
        fout = io.StringIO()
        server.serve_forever(io.StringIO(request), fout)
        outs[p] = fout.getvalue()
    launches = bsr_spmm.launches()
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


def _bounds(bsr, c, dtype, seeds, ops_n, peak):
    """The two bounds of one call: bytes with only the occupied 16x16 tiles
    and tile_mask (what the kernel must read; bound_ms, which the kernel is
    measured against) and with the blocks as stored (stored_ms, the bound
    of the dense-block design), each the larger of its bytes (indices, x,
    seeds or gm, y, each once) over the HBM rate and ops_n over `peak`."""
    from meshvae_tpu_torch.bench.tile_probe import bounds

    b = bounds(bsr, c, dtype, seeds)
    ops_ms = 1e3 * ops_n / peak
    return dict(bound_ms=max(b["bytes_ms"], ops_ms), bytes_ms=b["bytes_ms"],
                ops_ms=ops_ms, stored_ms=max(
                    1e3 * b["stored_bytes"] / HBM_BYTES_PER_S, ops_ms),
                bytes=b["bytes"], stored_bytes=b["stored_bytes"])


def _time_kind(torch, bsr, csr, c, kind, modes, gen, dev, f=16):
    """Kernel, twin and library times of one call kind at one shape, with
    its bounds (_bounds) for the operations the data needs (2 per nonzero
    per column, 6 in bf16x3, plus 2 f per output for a lazy seed) at the
    peak rate of their type."""
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
        b = _bounds(bsr, c, torch.float32, len(kw), ops_n, PEAK_OPS[mode])
        bound_nnz = 1e3 * max((nnz_bytes + act) / HBM_BYTES_PER_S,
                              ops_n / PEAK_OPS[mode])
        out[mode] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                         **{k: b[k] for k in ACC_KEYS if k in b})
        say(f"  {c=} {mode} {kind}: kernel {1e3 * k_ms:.1f} us, twin "
            f"{1e3 * p_ms:.1f} us, torch.sparse {1e3 * lib_ms:.1f} us (rel "
            f"err {lib_err:.1e}), bound {1e3 * b['bound_ms']:.2f} us "
            f"(occupied tiles; {1e3 * b['stored_ms']:.2f} us with the blocks "
            f"as stored, {1e3 * bound_nnz:.2f} us with CSR storage)")
        out[mode]["row"] = dict(
            n_pad=bsr.n_pad, n_pad_cols=bsr.n_pad_cols, C=c,
            blocks=bsr.num_blocks, nnz=nnz, mode=mode, kind=kind,
            kernel_us=1e3 * k_ms, plain_us=1e3 * p_ms,
            library_us=1e3 * lib_ms, library_rel_err=lib_err,
            bound_us=1e3 * b["bound_ms"], bound_stored_us=1e3 * b["stored_ms"],
            bound_nnz_us=1e3 * bound_nnz, bytes=b["bytes"],
            stored_bytes=b["stored_bytes"], ops=ops_n)
    return out


@dataclasses.dataclass(frozen=True)
class PoolT:
    """An up-pool's P^T as the pool backward calls it: pool_transpose
    (ops/csrc/pool_transpose.cu) on its CSR form, g [B, N_out, f] with B =
    C / f. The call tables name it in the place of a block-sparse
    operand."""
    pool: object
    f: int


# the features entering up-pool i in every configuration the script runs
# (filters 16/16/16/32/32): P^T calls run at C = B * POOL_F[i]
POOL_F = (16, 16, 32, 32)
SOURCE_POOL = "meshvae_tpu_torch/ops/csrc/pool_transpose.cu"


def _pt_library(torch, pool, g2):
    """The torch.sparse (cuSPARSE) yardstick of P^T @ g on g's [N_out,
    B * f] layout (a row shard's [g_rows, B * f]), in the operator's dtype
    where cuSPARSE takes it, else fp32: (callable, its dtype)."""
    crow, col = pool.t_ptr.long(), pool.t_col.long()
    shape = (pool.x_rows, pool.g_rows)
    csr = torch.sparse_csr_tensor(crow, col, pool.t_val, size=shape,
                                  check_invariants=True)
    try:
        torch.sparse.mm(csr, g2)
        torch.cuda.synchronize()
        return (lambda: torch.sparse.mm(csr, g2)), str(g2.dtype)[6:]
    except (RuntimeError, NotImplementedError):
        csr32 = torch.sparse_csr_tensor(crow, col, pool.t_val.float(),
                                        size=shape, check_invariants=True)
        g32 = g2.float()
        return (lambda: torch.sparse.mm(csr32, g32)), "float32"


def _pt_case(torch, pool, b, f, dev, gen, tag):
    """pool_transpose at one shape: the kernel bit-equal to the earlier
    bsr_grouped_spmm call on t_bsr in fp32 (else the first differing
    element), within TOL_KERNEL (fp32) or one bf16 ulp (bf16) of max |y|
    of its twin; then its time per call beside the twin, the earlier call
    (bsr_grouped_spmm on the padded [N_out, B * f_pad] layout, without the
    copies around it), torch.sparse and the byte bound (CSR, g and y once
    each). Returns the per-call dict of ACC_KEYS plus old_ms, err_abs and
    row."""
    import torch.nn.functional as F

    from meshvae_tpu_torch.ops import pool_transpose as pt
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm, pad_features

    dt = pool.t_val.dtype
    mode = pt.DTYPES[dt]
    g = torch.randn(b, pool.n_out, f, device=dev, generator=gen).to(dt)
    bsr, f_pad = pool.t_bsr, pad_features(b, f)
    gt = F.pad(g.transpose(0, 1), (0, f_pad - f, 0, 0, 0,
                                   bsr.n_pad_cols - pool.n_out))
    gt = gt.reshape(bsr.n_pad_cols, b * f_pad).contiguous()
    y = pt.pool_transpose(pool, g)
    old = bsr_grouped_spmm(bsr, gt, mode).reshape(
        bsr.n_pad, b, f_pad)[:pool.n_in, :, :f].transpose(0, 1)
    torch.cuda.synchronize()
    twin = pt.pool_transpose_reference(pool, g)
    scale = twin.float().abs().max().item()
    err_abs = (y.float() - twin.float()).abs().max().item()
    old_err = (old.float() - twin.float()).abs().max().item()
    bar = TOL_KERNEL if mode == "fp32" else TOL_BF16
    if not err_abs <= bar * scale:
        fail(f"pool_transpose disagrees with its twin: {tag} "
             f"{err_abs / scale:.3e} > {bar:.3e} of max|y|")
    equal = bool(torch.equal(y, old))
    if mode == "fp32" and not equal:
        at = tuple(int(i) for i in (y != old).nonzero()[0])
        fail(f"pool_transpose not bit-equal to bsr_grouped_spmm: {tag} first "
             f"at {at}: {y[at].item()!r} vs {old[at].item()!r}")
    lib, lib_dtype = _pt_library(
        torch, pool, g.transpose(0, 1).reshape(pool.n_out, b * f)
        .contiguous())
    k_ms = time_ms(torch, lambda: pt.pool_transpose(pool, g))
    p_ms = time_ms(torch, lambda: pt.pool_transpose_reference(pool, g))
    o_ms = time_ms(torch, lambda: bsr_grouped_spmm(bsr, gt, mode))
    l_ms = time_ms(torch, lib)
    nnz, es = pool.t_col.shape[0], g.element_size()
    n_bytes = (es * b * f * (pool.n_out + pool.n_in) + 4 * (pool.n_in + 1)
               + (4 + es) * nnz)
    ops_n = 2 * nnz * b * f  # fp32 FMAs in both modes
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops_n / PEAK_OPS["fp32"]
    bound = max(bytes_ms, ops_ms)
    say(f"  {tag} [{pool.n_in} x {pool.n_out}, nnz {nnz}, B={b}, f={f}] "
        f"{mode}: pool_transpose {1e3 * k_ms:.1f} us (max_err/max|y| "
        f"{err_abs / scale:.2e}, "
        f"{'bit-equal to' if equal else 'vs'} bsr_grouped_spmm "
        f"{old_err / scale:.2e}), twin {1e3 * p_ms:.1f} us, "
        f"bsr_grouped_spmm {1e3 * o_ms:.1f} us, torch.sparse[{lib_dtype}] "
        f"{1e3 * l_ms:.1f} us, bound {1e3 * bound:.2f} us")
    row = dict(shape=tag, n_in=pool.n_in, n_out=pool.n_out, nnz=nnz, B=b,
               f=f, mode=mode, kernel_us=1e3 * k_ms, plain_us=1e3 * p_ms,
               old_us=1e3 * o_ms, library_us=1e3 * l_ms,
               library_dtype=lib_dtype, bound_us=1e3 * bound, bytes=n_bytes,
               ops=ops_n, err=err_abs / scale, bit_equal_old=equal)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, old_ms=o_ms,
                bound_ms=bound, bytes_ms=bytes_ms, ops_ms=ops_ms,
                stored_ms=bound, err_abs=err_abs, row=row)


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
    acc = {m: dict.fromkeys(ACC_KEYS, 0.0) for m in modes}
    for label, key, c, kinds in calls:
        if isinstance(operands[key], PoolT):
            mode = ("bf16" if operands[key].pool.t_val.dtype
                    == torch.bfloat16 else "fp32")
            if mode not in acc:
                fail(f"{label}: a {mode} P^T in a table of {sorted(acc)}")
            _pool_calls(torch, acc[mode], operands[key], label, c, kinds,
                        gen, dev, rows)
            continue
        bsr, csr = operands[key]
        say(f" {label} ({key}, n_pad {bsr.n_pad} x {bsr.n_pad_cols}):")
        for kind, count in kinds.items():
            got = _time_kind(torch, bsr, csr, c, kind, modes, gen, dev)
            for mode in modes:
                for k in ACC_KEYS:
                    acc[mode][k] += count * got[mode][k]
                rows.append(dict(got[mode]["row"], shape=label, per_step=count))
    return acc


def _pool_calls(torch, acc, op, label, c, kinds, gen, dev, rows):
    """A P^T entry of a call table (PoolT): each call is one pool_transpose
    at B = C / f, added to acc, the sums of its mode (with old_ms, the
    earlier bsr_grouped_spmm call's time, where the pool is whole, and
    err_abs, the worst absolute error against the twin); a pool shard
    runs _pt_shard_case."""
    case = _pt_case if op.pool.t_bsr is not None else _pt_shard_case
    got = case(torch, op.pool, c // op.f, op.f, dev, gen, label)
    count = sum(kinds.values())
    for k in ACC_KEYS + (("old_ms",) if "old_ms" in got else ()):
        acc[k] = acc.get(k, 0.0) + count * got[k]
    acc["err_abs"] = max(acc.get("err_abs", 0.0), got["err_abs"])
    rows.append(dict(got["row"], per_step=count))


def _acc_tail(acc: dict) -> str:
    """The end of a per-step sum's line: the stored-block bound of a
    bsr_grouped_spmm sum, the earlier call's time of a P^T (pool_transpose)
    sum on whole pools."""
    if "old_ms" in acc:
        return f"earlier bsr_grouped_spmm {acc['old_ms']:.3f} ms)"
    if "err_abs" in acc:   # P^T on pool shards: no earlier call, no blocks
        return "pool shards: no earlier call)"
    return f"{acc['stored_ms']:.3f} ms with the blocks as stored)"


def _bound_by(entry: dict) -> str:
    return "bytes" if entry["bytes_ms"] >= entry["ops_ms"] else "operations"


def _kernel_times(prof, n):
    """(us per run, name) of every kernel in a torch.profiler run of n
    runs, longest first: device-side kernel events only (an aten op's
    entry repeats its kernels, and a user annotation such as
    Optimizer.step#Adam.step spans them)."""
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
    return sorted(kern, reverse=True)


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
    kern = _kernel_times(prof, n)
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


def _operands(torch, ops, hier, dev) -> dict:
    """Config 1's operands by name: L0 and L1 block-sparse, each with its
    torch.sparse CSR form; the P^T of up-pools 0-2 as the pool backward
    calls them (P0T-P2T: PoolT, pool_transpose) and as the earlier
    block-sparse operator with its CSR (P0T bsr-P2T bsr: bsr_grouped_spmm's
    rectangular case, still held and timed in mode bf16x3)."""
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    operands = {}
    for i in (0, 1):
        bsr = ops.lap[i].bsr
        operands[f"L{i}"] = (bsr, _csr(torch, normalized_neg_adjacency(
            hier.adjacency[i]), bsr.n_pad, bsr.n_pad_cols, dev))
    for i in (0, 1, 2):
        bsr = ops.up[i].t_bsr
        operands[f"P{i}T"] = PoolT(ops.up[i], POOL_F[i])
        operands[f"P{i}T bsr"] = (bsr, _csr(torch, hier.upsample[i].T,
                                            bsr.n_pad, bsr.n_pad_cols, dev))
    return operands


def _operand_names(operands: dict) -> dict:
    """{shape: name} of an operand map: (n_pad, n_pad_cols) of each
    block-sparse operand, (x_rows, g_rows) of each PoolT (its (n_in,
    n_out), or a pool shard's rows), as the launch tables key them."""
    return {((op.pool.x_rows, op.pool.g_rows) if isinstance(op, PoolT)
             else (op[0].n_pad, op[0].n_pad_cols)): k
            for k, op in operands.items()}


def phase_times(torch, servers, ops, hier, dev, host):
    """Per-call times at every shape and call kind of the serving step and
    the train step, summed per step; the serving step itself."""
    say("== phase 5: times (median of %d, CUDA events)" % RUNS)
    gen = torch.Generator(device=dev).manual_seed(1)
    operands = _operands(torch, ops, hier, dev)
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
            ("pool_bf16x3_colmajor", [("up-pool 0 P^T", "P0T bsr", 256,
                                       {"a1": 1}),
                                      ("up-pool 1 P^T", "P1T bsr", 256,
                                       {"a1": 1})]),
            ("pool_bf16x3_perblock", [("up-pool 0 P^T", "P0T bsr", 512,
                                       {"a2 plus prev": 1})])):
        per_step[name] = _per_step(torch, calls, operands, ("bf16x3",), gen,
                                   dev, rows)["bf16x3"]
    say("shape_rows " + json.dumps(rows))
    for name, acc in per_step.items():
        say(f"per step {name}: kernel {acc['ms']:.3f} ms, twin "
            f"{acc['plain_ms']:.3f} ms, torch.sparse {acc['library_ms']:.3f}"
            f" ms, bound {acc['bound_ms']:.3f} ms ({_bound_by(acc)}; "
            + _acc_tail(acc))

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

    pool_keys = [("fp32", up.n_in, up.n_out, BATCH * POOL_F[i])
                 for i, up in enumerate(ops.up[:3])]
    trainers, launches, pt_launches, by_shape = {}, {}, {}, {}
    for p in models:
        tr = trainer_for(p, dev, ops)
        norm = tr.norm_to_device(ds.mean, ds.std)
        fixed_dev = tr.to_device(fixed)
        before = tr.eval_step(fixed_dev, *norm)["scalars"][0].item()
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        # --- the main path: counts reset just before, read just after ---
        reset_launches()
        t0 = time.perf_counter()
        epochs = [tr.train_epoch(loader, gen, ds.mean, ds.std)
                  for _ in range(TRAIN_EPOCHS)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[p] = bsr_spmm.launches()
        pt_launches[p], by_shape[p] = pt_counts()
        # ----------------------------------------------------------------
        after = tr.eval_step(fixed_dev, *norm)["scalars"][0].item()
        avg, errors = tr.evaluate(BatchIterator(ds, BATCH), ds.mean, ds.std)
        say(f"train[{p}]: {steps} steps in {secs:.2f}s (first steps "
            f"included); epoch losses "
            f"{[round(float(e['loss']), 2) for e in epochs]}; fixed-batch eval "
            f"loss {before:.2f} -> {after:.2f}")
        say(f"  evaluate: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                         avg.items()))
        say(f"  launches: bsr_grouped_spmm {launches[p]}, pool_transpose "
            f"{pt_launches[p]}; P^T by (mode, n_in, n_out, C) "
            f"{sorted(by_shape[p].items())}")
        lap, pool = TRAIN_LAP_LAUNCHES * steps, TRAIN_POOL_LAUNCHES * steps
        want = ({"bf16x3": lap, "fp32": 0, "bf16": 0} if p == "high"
                else {"bf16x3": 0, "fp32": lap, "bf16": 0})
        if (launches[p], pt_launches[p]) != (want, {"fp32": pool, "bf16": 0}):
            fail(f"train[{p}] launched {launches[p]} and P^T "
                 f"{pt_launches[p]}, expected {want} and {pool} fp32 "
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
            reset_launches()
            tr.train_step(tr.to_device(fixed), None,
                          *tr.norm_to_device(ds.mean, ds.std))
            torch.cuda.synchronize()
            counts[side] = (bsr_spmm.launches()["fp32"],
                            bsr_spmm.launches_seed_dot()["fp32"],
                            pt_counts()[0]["fp32"])
        finally:
            port_cheb.FUSED_SEED_DOT = False
        grads[side] = {k: v.grad.cpu()
                       for k, v in tr.model.named_parameters()}
    worst = {other: max((grads["card"][k] - g).abs().max().item()
                        / _layer_scale(grads[other], k)
                        for k, g in grads[other].items())
             for other in ("cpu", "card, flag off")}
    say(f"lazy seed at config 1, highest: launches (all, lazy, P^T) "
        f"{counts}; "
        f"worst gradient delta vs the CPU {worst['cpu']:.2e}, vs the card "
        f"with the flag off {worst['card, flag off']:.2e} of the layer's "
        f"max|g| (bar 1e-4)")
    lap, pool = TRAIN_LAP_LAUNCHES, TRAIN_POOL_LAUNCHES
    if counts["card"] != (lap, CONFIG1_SEED_DOT, pool) or counts[
            "card, flag off"] != (lap, 0, pool):
        fail(f"config-1 lazy-seed step launched {counts}, expected "
             f"({lap}, {CONFIG1_SEED_DOT}, {pool}) with the flag on")
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


# the joint80k cell's train step (meshbench/configs/joint80k.json: the
# joint VAE + GCN at 80k, B = 32, K = 10, bf16): the encoder's convs at B,
# the true- and opposite-label decodes as one decoder pass at 2B and the
# GCN's four convs (cheb_0 6 -> 16 at f_pad 8, then 16 -> 16, 16 -> 16,
# 16 -> 32) at B on the differences; the backward of every conv but
# enc_0, cheb_0's dx recurrence included; each up-pool's P^T at 2B
JOINT80_CALLS = {
    "lap": [("enc_0 L0", "L0", 128, _FWD80),
            ("cheb_0 L0", "L0", 256, _BOTH80),
            ("2B dec_3 L0", "L0", 1024, _BOTH80),
            ("enc_1+cheb_1 L1", "L1", 512,
             {k: 2 * v for k, v in _BOTH80.items()}),
            ("2B dec_2 L1", "L1", 1024, _BOTH80),
            ("enc_2+cheb_2 L2", "L2", 512,
             {k: 2 * v for k, v in _BOTH80.items()}),
            ("2B dec_1 L2", "L2", 2048, _BOTH80),
            ("enc_3+cheb_3 L3", "L3", 512,
             {k: 2 * v for k, v in _BOTH80.items()}),
            ("2B dec_0 L3", "L3", 2048, _BOTH80)],
    "pool_perblock": [("up-pool 0 P^T at 2B", "P0T", 1024, {"a1": 1})],
    "pool_colmajor": [("up-pool 1 P^T at 2B", "P1T", 1024, {"a1": 1}),
                      ("up-pool 2 P^T at 2B", "P2T", 2048, {"a1": 1}),
                      ("up-pool 3 P^T at 2B", "P3T", 2048, {"a1": 1})]}
# its eval step, forward calls only: the train step's forward, then the
# counterfactual's decode at B and its re-encode
_FWD80_X = lambda n: {k: n * v for k, v in _FWD80.items()}
JOINT80_EVAL_CALLS = {
    "lap": [("enc_0, re-encode enc_0 L0", "L0", 128, _FWD80_X(2)),
            ("cheb_0 L0", "L0", 256, _FWD80),
            ("counterfactual dec_3 L0", "L0", 512, _FWD80),
            ("2B dec_3 L0", "L0", 1024, _FWD80),
            ("enc_1, cheb_1, re-encode enc_1, counterfactual dec_2 L1",
             "L1", 512, _FWD80_X(4)),
            ("2B dec_2 L1", "L1", 1024, _FWD80),
            ("enc_2, cheb_2, re-encode enc_2 L2", "L2", 512, _FWD80_X(3)),
            ("counterfactual dec_1 L2", "L2", 1024, _FWD80),
            ("2B dec_1 L2", "L2", 2048, _FWD80),
            ("enc_3, cheb_3, re-encode enc_3 L3", "L3", 512, _FWD80_X(3)),
            ("counterfactual dec_0 L3", "L3", 1024, _FWD80),
            ("2B dec_0 L3", "L3", 2048, _FWD80)]}
# cheb_mix per (F_pad, F_out): one mix per block-sparse conv call, and a
# dW per conv in the train step's backward
JOINT80_MIX_TRAIN = {(4, 16): 1, (8, 16): 1, (16, 16): 6, (16, 32): 2,
                     (32, 16): 1, (32, 32): 1}
JOINT80_MIX_EVAL = {(4, 16): 2, (8, 16): 1, (16, 16): 10, (16, 32): 3,
                    (32, 16): 2, (32, 32): 2}
JOINT80_CFG = os.path.join("meshbench", "configs", "joint80k.json")


def _operands80(ops):
    out = {f"L{i}": op.bsr for i, op in enumerate(ops.lap)
           if op.bsr is not None}
    out.update({f"P{i}T": up.t_bsr for i, up in enumerate(ops.up)
                if up.t_bsr is not None})
    return out


def _round_bf16(torch, v):
    """float64 v rounded once to bf16's 8 significant bits, to nearest,
    ties to even (a cast through float32 could round twice)."""
    _, e = torch.frexp(v)
    ulp = torch.ldexp(torch.ones_like(v), e - 8)
    return torch.where(v == 0, v, torch.round(v / ulp) * ulp)


def _exact_bsr_rows(torch, bsr, x, alpha, kw, at):
    """alpha * (L @ x) + t_plus - t_prev in float64 at the elements `at`
    [n, 2] (row, column): the sum the kernel and its twin round to bf16,
    as bsr_grouped_spmm_reference forms it, over the block rows that
    hold them."""
    from meshvae_tpu_torch.ops.bsr_spmm import BLOCK, masked_blocks

    n_rows, g = bsr.g_idx.shape
    rows = torch.unique(at[:, 0] // BLOCK)
    zero = bsr.blocks.new_zeros((1, BLOCK, BLOCK))
    lg = torch.cat([masked_blocks(bsr), zero])[
        bsr.g_idx[rows].long()].double()
    xg = x.reshape(-1, BLOCK, x.shape[1])[
        bsr.g_bcol.reshape(n_rows, g)[rows].long()].double()
    y = alpha * torch.matmul(lg, xg).sum(dim=1).reshape(-1, x.shape[1])
    local = (torch.searchsorted(rows, at[:, 0] // BLOCK) * BLOCK
             + at[:, 0] % BLOCK)
    out = y[local, at[:, 1]]
    if kw.get("t_plus") is not None:
        out = out + kw["t_plus"][at[:, 0], at[:, 1]].double()
    if kw.get("t_prev") is not None:
        out = out - kw["t_prev"][at[:, 0], at[:, 1]].double()
    return out


def phase_kernel_bf16(torch, ops80, dev):
    """The bf16 mode against its twin at every 80k Laplacian shape of the
    vae80k and joint80k train steps (alpha 1 and 2, no seed, t_prev,
    t_plus, both), the four P^T at B (as called, plus one both-seed case
    on the widest) and the lazy
    seed at the square convs' shapes (and L2 at C = 1024, f = 32). An
    element more than TOL_BF16 of max|y| from the twin passes only where
    the kernel holds the exact (float64) sum rounded to bf16: the twin's
    fp32 sum can round the other way near a tie, one ulp, which in the
    top binade exceeds TOL_BF16 of max|y|. Returns the worst absolute
    error of the rest, "lap", "pool" and "seed"."""
    from meshvae_tpu_torch.ops.bsr_spmm import (bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    operands = _operands80(ops80)
    every = ("a1", "a2", "a1 prev", "a2 prev", "a1 plus", "a2 plus",
             "a1 plus prev", "a2 plus prev")
    cases = sorted({(key, c) for calls in SCALED_CALLS.values()
                    for _, key, c, _ in calls})
    # the joint80k step's other shapes draw from a generator of their own,
    # so the vae80k shapes and the lazy seed keep their inputs
    gen_joint = torch.Generator(device=dev).manual_seed(23)
    joint = sorted({(key, c) for _, key, c, _ in JOINT80_CALLS["lap"]}
                   - set(cases))
    worst = {"lap": 0.0, "pool": 0.0}
    rel_worst, equal = 0.0, []
    for key, c, draw in ([(*case, gen) for case in cases]
                         + [(*case, gen_joint) for case in joint]):
        bsr = operands[key]
        kinds = every if key.startswith("L") else (
            ("a1", "a2 plus prev") if key == "P0T" else ("a1",))
        x = torch.randn(bsr.n_pad_cols, c, device=dev,
                        generator=draw).to(bf)
        seeds = {k: torch.randn(bsr.n_pad, c, device=dev,
                                generator=draw).to(bf)
                 for k in ("t_plus", "t_prev")}
        for kind in kinds:
            alpha, kw = _seed_args(kind, seeds)
            y = bsr_grouped_spmm(bsr, x, "bf16", alpha, **kw)
            torch.cuda.synchronize()
            ref = bsr_grouped_spmm_reference(bsr, x, "bf16", alpha, **kw)
            if y.dtype != bf or ref.dtype != bf:
                fail(f"bf16 mode returned {y.dtype} / {ref.dtype}")
            scale = ref.float().abs().max().item()
            gap = (y.float() - ref.float()).abs()
            over = (gap > TOL_BF16 * scale).nonzero()
            tie = ""
            if len(over):   # the twin's fp32 sum may round the other way
                exact = _exact_bsr_rows(torch, bsr, x, alpha, kw, over)
                if not torch.equal(y[over[:, 0], over[:, 1]].double(),
                                   _round_bf16(torch, exact)):
                    fail(f"bf16 kernel disagrees with its twin: {key} "
                         f"C={c} {kind} {gap.max().item() / scale:.3e} > "
                         f"{TOL_BF16:.3e}, and is not the exact sum "
                         f"rounded there")
                gap[over[:, 0], over[:, 1]] = 0.0
                tie = (f"; {len(over)} element(s) over the bar, each the "
                       f"exact sum rounded (the twin's rounds the other "
                       f"way)")
            err_abs = gap.max().item()
            err = err_abs / scale
            eq = (y == ref).float().mean().item()
            equal.append(eq)
            group = "lap" if key.startswith("L") else "pool"
            worst[group] = max(worst[group], err_abs)
            rel_worst = max(rel_worst, err)
            say(f"  80k {key} C={c} bf16 {kind}: max_err/max|y| {err:.3e} "
                f"(bar {TOL_BF16:.3e}), bit-equal {eq:.5f}{tie}")
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
    shape, with its bounds (_bounds: bf16 tiles or blocks, int32 indices,
    bf16 x, seeds or gm and y) for 2 operations per nonzero per column
    (plus 2 f per output for a lazy seed) at the bf16 tensor-core rate."""
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
    nnz = int((bsr.blocks != 0).sum())
    ops_n = 2 * nnz * c + (2 * f * bsr.n_pad * c if "dot" in kind else 0)
    b = _bounds(bsr, c, bf, len(kw), ops_n, PEAK_OPS["bf16"])
    say(f"  {c=} bf16 {kind}: kernel {1e3 * k_ms:.1f} us, twin "
        f"{1e3 * p_ms:.1f} us, torch.sparse[{csr['lib_dtype']}] "
        f"{1e3 * lib_ms:.1f} us, bound {1e3 * b['bound_ms']:.2f} us "
        f"(occupied tiles; {1e3 * b['stored_ms']:.2f} us as stored)")
    row = dict(n_pad=bsr.n_pad, n_pad_cols=bsr.n_pad_cols, C=c,
               blocks=bsr.num_blocks, G=bsr.g_width, nnz=nnz, mode="bf16",
               kind=kind, kernel_us=1e3 * k_ms, plain_us=1e3 * p_ms,
               library_us=1e3 * lib_ms, library_dtype=csr["lib_dtype"],
               bound_us=1e3 * b["bound_ms"],
               bound_stored_us=1e3 * b["stored_ms"], bytes=b["bytes"],
               stored_bytes=b["stored_bytes"], ops=ops_n)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, row=row,
                **{k: b[k] for k in ACC_KEYS if k in b})


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
        out[key] = _csr(torch, mat, bsr.n_pad, bsr.n_pad_cols, dev)
    return _with_bf16(torch, out, dev) if bf16 else out


def _with_bf16(torch, csrs: dict, dev) -> dict:
    """{name: fp32 CSR} -> {name: {"fp32", "bf16", "lib_dtype"}}: each
    operand's CSR also in bf16 where cuSPARSE takes bf16 (probed once),
    else None with lib_dtype fp32 (the yardstick then runs fp32)."""
    out = {k: {"fp32": f32, "bf16": torch.sparse_csr_tensor(
        f32.crow_indices(), f32.col_indices(),
        f32.values().to(torch.bfloat16), size=f32.shape,
        check_invariants=True)} for k, f32 in csrs.items()}
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
        "folds": 2, "epoch": 2,
        # the per-step loop, as before the scanned epoch (phase 15)
        "scan_epoch": False})
    if (config["compute_dtype"], config["batch_size"],
            config["polygon_order"]) != ("bfloat16", SCALED_BATCH, [10] * 5):
        fail(f"{SCALED_CFG} no longer is bf16, B=32, K=10")

    results, secs, steps, launches, _, by_shape = _run_driver(torch, config,
                                                              dev)
    want = {**dict.fromkeys(LAUNCH_KEYS, 0),
            "bf16": SCALED_TRAIN_LAUNCHES * steps["train"]
            + SCALED_EVAL_LAUNCHES * steps["eval"],
            "pool bf16": SCALED_POOL_LAUNCHES * steps["train"]}
    if steps["train"] < 1 or launches != want:
        fail(f"scaled80k launched {launches}, expected {want} "
             f"({steps['train']} train, {steps['eval']} eval steps)")
    from meshvae_tpu_torch.ops import cheb_mix

    mixes = {kind: sum(n for key, n in cheb_mix.LAUNCHES.items()
                       if key[:2] == (kind, "bf16")) for kind in ("fwd", "dw")}
    want_mix = {"fwd": SCALED_MIX_TRAIN * steps["train"]
                + SCALED_MIX_EVAL * steps["eval"],
                "dw": SCALED_MIX_TRAIN * steps["train"]}
    if mixes != want_mix or sum(cheb_mix.LAUNCHES.values()) != sum(
            mixes.values()):
        fail(f"scaled80k launched cheb_mix {dict(cheb_mix.LAUNCHES)}, "
             f"expected {want_mix} in bf16")
    say(f"cheb_mix launches: {SCALED_MIX_TRAIN} mix + {SCALED_MIX_TRAIN} dW "
        f"per train step, {SCALED_MIX_EVAL} mix per eval step ({mixes} over "
        f"{steps['train']} train and {steps['eval']} eval steps)")
    pool_keys = [("pool bf16", up.n_in, up.n_out) for up in s80["ops"].up]
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
        reset_launches()
        for _ in range(FLAG_STEPS):
            step()
        torch.cuda.synchronize()
        on = (bsr_spmm.launches(), bsr_spmm.launches_seed_dot(),
              pt_counts()[0])
        ms_on = time_ms(torch, step, backlog=False)
    finally:
        port_cheb.FUSED_SEED_DOT = False
    say(f"train step [scaled80k bf16, FUSED_SEED_DOT]: {ms_on:.3f} ms "
        f"host-paced ({ms:.3f} ms with the flag off, same call); "
        f"launches over {FLAG_STEPS} steps {on[0]}, lazy seed {on[1]}, "
        f"pool_transpose {on[2]}")
    want = ({"fp32": 0, "bf16x3": 0, "bf16": SCALED_TRAIN_LAUNCHES
             * FLAG_STEPS}, {"fp32": 0, "bf16x3": 0,
                             "bf16": SCALED_SEED_DOT * FLAG_STEPS},
            {"fp32": 0, "bf16": SCALED_POOL_LAUNCHES * FLAG_STEPS})
    if on != want:
        fail(f"scaled80k with the lazy seed launched {on}, expected {want}")

    # --- the bf16 kernel per 80k shape and call kind --------------------
    per_step = _per_step80(torch, s80, dev, "80k", {
        **SCALED_CALLS, "lap_seed_dot": SCALED_DOT_CALLS})
    counts = {"lap": launches["bf16"],
              "pool_perblock": by_shape.get(pool_keys[0], 0),
              "pool_colmajor": sum(by_shape.get(k, 0)
                                   for k in pool_keys[1:]),
              "seed_dot": on[1]["bf16"]}
    return per_step, counts


def _per_step80(torch, s80, dev, label, tables):
    """The bf16 kernel per call kind at the 80k shapes of each call table
    (kernel, twin, torch.sparse, bounds; a P^T entry is pool_transpose's),
    summed per step: {table name: sums}."""
    say(f"{label} bf16 train step, per call (median of {RUNS}, CUDA "
        f"events):")
    csr = _csr80(torch, s80, dev)
    operands = _operands80(s80["ops"])
    pools = {f"P{i}T": PoolT(up, POOL_F[i])
             for i, up in enumerate(s80["ops"].up)}
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, per_step = [], {}
    for name, calls in tables.items():
        acc = dict.fromkeys(ACC_KEYS, 0.0)
        for call, key, c, kinds, *f in calls:
            if key in pools:
                _pool_calls(torch, acc, pools[key], call, c, kinds, gen,
                            dev, rows)
                continue
            bsr = operands[key]
            say(f" {call} ({key}, n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
                f"G {bsr.g_width}):")
            for kind, count in kinds.items():
                got = _time_kind_bf16(torch, bsr, csr[key], c, kind, gen,
                                      dev, *f)
                for k in ACC_KEYS:
                    acc[k] += count * got[k]
                rows.append(dict(got["row"], shape=call, per_step=count))
        per_step[name] = acc
        say(f"per {label} train step {name}: kernel {acc['ms']:.3f} ms, "
            f"twin {acc['plain_ms']:.3f} ms, torch.sparse "
            f"{acc['library_ms']:.3f} ms, bound {acc['bound_ms']:.3f} ms "
            f"({_bound_by(acc)}; " + _acc_tail(acc))
    say(f"shape_rows_{label} " + json.dumps(rows))
    return per_step


def _joint80_counts(torch, step, names: dict) -> dict:
    """One step's launches, the counts zeroed just before: per
    LAUNCH_KEYS entry, per (operand, C, kind) of the block-sparse calls
    and the P^T (launch_calls, named by `names`), and cheb_mix's per
    (kind, F_pad, F_out) in bf16."""
    from meshvae_tpu_torch.ops import cheb_mix

    torch.cuda.synchronize()
    reset_launches()
    step()
    torch.cuda.synchronize()
    mixes = {}
    for (kind, mode, _, f, f_out), n in cheb_mix.LAUNCHES.items():
        key = (kind if mode == "bf16" else f"{kind} {mode}", f, f_out)
        mixes[key] = mixes.get(key, 0) + n
    return {"modes": launch_modes(),
            "calls": _launch_table(launch_calls(), names, 1),
            "mixes": mixes}


def phase_joint80k(torch, dev, s80, tmp):
    """Phase 7b: the joint80k cell's model at 80k, built as the k-fold
    driver builds it; its launches in one train step and one eval step
    against JOINT80_CALLS, JOINT80_EVAL_CALLS and the mix tables, then the
    train step's calls timed. Returns (per-step sums, launches per train
    step of each JOINT80_CALLS table)."""
    say("== phase 7b: joint80k (the joint VAE + GCN of "
        f"{JOINT80_CFG}, B={SCALED_BATCH}, K=10, bf16) at 80k")
    from meshvae_tpu_torch.config import default_config
    from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                        generate_synthetic_dataset,
                                        list_meshes)
    from meshvae_tpu_torch.train.driver import (build_model_and_ops,
                                                make_trainer)

    with open(os.path.join(ROOT, JOINT80_CFG)) as fp:
        program = json.load(fp)["program"]
    config = default_config()
    config.update(program)
    config.update({"template": s80["path"],     # paths only
                   "hierarchy_cache_dir": s80["cache"]})
    if (config["type"], config["compute_dtype"], config["batch_size"],
            config["polygon_order"]) != ("joint_VAE", "bfloat16",
                                         SCALED_BATCH, [10] * 5):
        fail(f"{JOINT80_CFG} no longer is joint_VAE, bf16, B=32, K=10")
    model, ops, hier, _ = build_model_and_ops(
        config, dev, generator=torch.Generator().manual_seed(71))
    if hier.levels != SCALED_LEVELS:
        fail(f"joint80k hierarchy levels {hier.levels}")
    tr = make_trainer(config, model, ops, dev)
    if type(tr).__name__ != "JointTrainer":
        fail(f"joint80k built a {type(tr).__name__}, not a JointTrainer")
    data_dir = os.path.join(tmp, "data80k")   # phase 7's meshes
    if not os.path.isdir(data_dir):
        generate_synthetic_dataset(s80["tmpl"], data_dir,
                                   n_samples=SCALED_BATCH, seed=21)
    index, labels = list_meshes({"root_dir": data_dir})
    ds = MeshDataset(index[:SCALED_BATCH],
                     {"root_dir": data_dir,
                      "checkpoint_dir": os.path.join(tmp, "norm_joint80k")},
                     labels, s80["tmpl"].v)
    batch = tr.to_device(next(iter(BatchIterator(ds, SCALED_BATCH))))
    norm = tr.norm_to_device(ds.mean, ds.std)
    gen = torch.Generator(device=dev).manual_seed(0)
    names = {(op.bsr.n_pad, op.bsr.n_pad_cols): f"L{i}"
             for i, op in enumerate(ops.lap) if op.bsr is not None}
    names.update({(up.x_rows, up.g_rows): f"P{i}T"
                  for i, up in enumerate(ops.up)})
    if sorted(names.values()) != ["L0", "L1", "L2", "L3", "P0T", "P1T",
                                  "P2T", "P3T"]:
        fail(f"joint80k operators {names}: expected L0-L3 block-sparse "
             f"and four up-pools")
    tr.train_step(batch, gen, *norm)   # first call: kernels load
    got = {"train": _joint80_counts(
               torch, lambda: tr.train_step(batch, gen, *norm), names),
           "eval": _joint80_counts(
               torch, lambda: tr.eval_step(batch, *norm), names)}
    for kind, calls, mix in (
            ("train", JOINT80_CALLS, {("fwd",) + k: v for k, v in
                                      JOINT80_MIX_TRAIN.items()}
             | {("dw",) + k: v for k, v in JOINT80_MIX_TRAIN.items()}),
            ("eval", JOINT80_EVAL_CALLS, {("fwd",) + k: v for k, v in
                                          JOINT80_MIX_EVAL.items()})):
        want_calls = _table_counts(calls)
        lap = sum(v for (key, _, _), v in want_calls.items()
                  if key.startswith("L"))
        want_modes = {**dict.fromkeys(LAUNCH_KEYS, 0), "bf16": lap,
                      "pool bf16": sum(want_calls.values()) - lap}
        seen = got[kind]
        if seen["modes"] != want_modes:
            fail(f"joint80k {kind} step launched {seen['modes']}, expected "
                 f"{want_modes}")
        if seen["calls"] != want_calls:
            fail(f"joint80k {kind} step calls {seen['calls']}, expected "
                 f"{want_calls}")
        if seen["mixes"] != mix:
            fail(f"joint80k {kind} step launched cheb_mix {seen['mixes']}, "
                 f"expected {mix}")
        say(f"joint80k {kind} step launches (counts zeroed just before): "
            f"{want_modes['bf16']} bsr_grouped_spmm[bf16] at "
            f"{len(want_calls)} (operand, C, kind) keys as "
            f"JOINT80{'_EVAL' if kind == 'eval' else ''}_CALLS, "
            f"{want_modes['pool bf16']} pool_transpose[bf16], cheb_mix "
            + json.dumps({f"{k[0]} {k[1]}->{k[2]}": v
                          for k, v in sorted(mix.items())}))
    del tr, model, ops
    torch.cuda.empty_cache()
    per_step = _per_step80(torch, s80, dev, "joint80k", JOINT80_CALLS)
    train = got["train"]["calls"]
    return per_step, {
        name: int(sum(train.get((key, c, kind), 0) for _, key, c, kinds in calls
                      for kind in kinds))
        for name, calls in JOINT80_CALLS.items()}


def _run_driver(torch, config, dev, vis=False, run=None):
    """train/driver.run(config) with train and test (or run(), another
    entry point's), the launch counts reset just before and read just
    after, and the train and eval steps counted (the per-step loop's
    calls; a scanned epoch's steps, replays included, by staged epoch).
    Returns (results, seconds, steps, launches, lazy-seed launches,
    launches by shape): bsr_grouped_spmm's and pool_transpose's
    (launch_modes, launch_shapes)."""
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train import Trainer
    from meshvae_tpu_torch.train import driver

    steps = {"train": 0, "eval": 0}
    real = {k: getattr(Trainer, f"{k}_step") for k in steps}
    real_scan = Trainer._run_scan
    scanned = bool(config.get("scan_epoch", True))

    def counted(kind):
        def step(self, *args, **kwargs):
            if not scanned:
                steps[kind] += 1
            return real[kind](self, *args, **kwargs)
        return step

    def run_scan(self, st):
        steps["train" if "metrics" in st.outs else "eval"] += st.steps
        return real_scan(self, st)

    Trainer.train_step, Trainer.eval_step = counted("train"), counted("eval")
    Trainer._run_scan = run_scan
    try:
        torch.cuda.synchronize()
        # --- the main path: counts reset just before, read just after ----
        reset_launches()
        t0 = time.perf_counter()
        results = (run() if run is not None else driver.run(
            config, do_train=True, do_test=True, vis=vis, device=dev))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_modes()
        seed_dot = bsr_spmm.launches_seed_dot()
        by_shape = launch_shapes()
        # -----------------------------------------------------------------
    finally:
        Trainer.train_step, Trainer.eval_step = (real["train"],
                                                 real["eval"])
        Trainer._run_scan = real_scan
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


def _held_bf16(name, card, cpu16, cpu32, scale) -> float:
    """Phase 8's bar: the card's bf16 result may be no further from the
    CPU's bf16 result than that is from the CPU's fp32 result, plus one
    bf16 ulp (2^-8) of the scale. Returns the margin used, (|card -
    cpu_bf16| - |cpu_bf16 - cpu_fp32|) / scale."""
    d_card = float(abs(card - cpu16).max())
    d_bf16 = float(abs(cpu16 - cpu32).max())
    say(f"  {name}: |card - cpu_bf16| {d_card:.3e}, |cpu_bf16 - "
        f"cpu_fp32| {d_bf16:.3e} (scale {scale:.3e})")
    if not d_card <= d_bf16 + TOL_BF16 * scale:
        fail(f"card vs CPU in bf16: {name} {d_card:.3e} > "
             f"{d_bf16:.3e} + one ulp of {scale:.3e}")
    return (d_card - d_bf16) / scale


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
    worst = []
    held = lambda *args: worst.append(_held_bf16(*args))
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


def _trace_report(prof, folds):
    """The Chrome traces run() wrote for epoch 2 of each fold with
    profile_dir set: one per fold and no other file; the top kernels by
    device time (kernel events) of the first, which must include
    bsr_grouped_spmm's."""
    from meshvae_tpu_torch.train.metrics import PROFILE_EPOCHS, trace_path

    want = sorted(os.path.basename(trace_path(prof, n, e))
                  for n in range(1, folds + 1) for e in PROFILE_EPOCHS)
    got = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    if got != want:
        fail(f"profile_dir holds {got}, expected {want}")
    path = trace_path(prof, 1, PROFILE_EPOCHS[0])
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total = sum(by_name.values())
    say(f"profile_dir trace {os.path.basename(path)} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB): {len(by_name)} kernels, "
        f"{total / 1e3:.3f} ms of device time in the epoch (train and "
        f"validation); the top ones:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"  {us / 1e3:9.3f} ms {us / total:6.1%}  {name[:90]}")
    if not any("bsr_grouped_spmm" in name for name in by_name):
        fail("the profile_dir trace shows no bsr_grouped_spmm kernel")


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
    prof = os.path.join(tmp, "profile20k")
    config.update({   # paths, folds, epochs and the profiler only
        "template": s20["path"], "root_dir": data_dir,
        "checkpoint_dir": ckpt, "log_file": os.path.join(ckpt, "log.txt"),
        "hierarchy_cache_dir": s20["cache"], "folds": 2, "epoch": 2,
        "profile_dir": prof,
        # the per-step loop, as before the scanned epoch (phase 15)
        "scan_epoch": False})
    if (config.get("compute_dtype", "float32"), config["matmul_precision"],
            config["batch_size"], config["polygon_order"]) != (
                "float32", "highest", SCALED20_BATCH, [10] * 5):
        fail(f"{SCALED20_CFG} no longer is fp32 at highest, B=64, K=10")
    ops = s20["ops"]
    pools = [i for i, up in enumerate(ops.up) if up.t_bsr is not None]
    pool_keys = [("pool fp32", ops.up[i].n_in, ops.up[i].n_out)
                 for i in pools]
    per_train = SCALED20_FWD + SCALED20_BWD

    port_cheb.FUSED_SEED_DOT = True
    try:
        results, secs, steps, launches, seed_dot, by_shape = _run_driver(
            torch, config, dev)
    finally:
        port_cheb.FUSED_SEED_DOT = False
    want = ({**dict.fromkeys(LAUNCH_KEYS, 0),
             "fp32": per_train * steps["train"]
             + SCALED20_EVAL * steps["eval"],
             "pool fp32": len(pools) * steps["train"]},
            {"fp32": SCALED20_SEED_DOT * steps["train"], "bf16x3": 0,
             "bf16": 0})
    say(f"expected per train step {per_train} = {SCALED20_FWD} forward + "
        f"{SCALED20_BWD} backward, {SCALED20_SEED_DOT} of them lazy-seed, "
        f"and {len(pools)} pool_transpose (up-pools {pools}); "
        f"{SCALED20_EVAL} per eval")
    if steps["train"] < 1 or (launches, seed_dot) != want:
        fail(f"scaled20k launched {launches}, lazy seed {seed_dot}, expected "
             f"{want} ({steps['train']} train, {steps['eval']} eval steps)")
    for key in pool_keys:
        if by_shape.get(key) != steps["train"]:
            fail(f"scaled20k P^T {key} launched {by_shape.get(key)} times, "
                 f"expected once per train step ({steps['train']})")
    _check_run(config, ckpt, results, s20["hier"])
    _trace_report(prof, folds=2)

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
        acc = dict.fromkeys(ACC_KEYS, 0.0)
        for label, key, c, kinds, f in group:
            if key.startswith("P"):
                i = int(key[1])
                _pool_calls(torch, acc, PoolT(ops.up[i], POOL_F[i]), label,
                            c, kinds, gen, dev, rows)
                continue
            bsr = operands[key]
            say(f" {label} ({key}, n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
                f"G {bsr.g_width}):")
            for kind, count in kinds.items():
                got = _time_kind(torch, bsr, csr[key], c, kind, ("fp32",),
                                 gen, dev, f)["fp32"]
                for k in ACC_KEYS:
                    acc[k] += count * got[k]
                rows.append(dict(got["row"], shape=label, per_step=count))
        per_step[name] = acc
        say(f"per 20k train step {name}: kernel {acc['ms']:.3f} ms, twin "
            f"{acc['plain_ms']:.3f} ms, torch.sparse {acc['library_ms']:.3f}"
            f" ms, bound {acc['bound_ms']:.3f} ms ({_bound_by(acc)}; "
            + _acc_tail(acc))
    say("shape_rows_20k " + json.dumps(rows))
    pool_n = sum(by_shape.get(k, 0) for k in pool_keys)
    counts = {"lap": launches["fp32"] - seed_dot["fp32"],
              "seed_dot": seed_dot["fp32"], "pool": pool_n}
    return per_step, counts


def _twins():
    """Context: the fused step, every SpMM of the conv backward and the
    pool backward's P^T run their plain twins, on whatever device the
    tensors are."""
    import contextlib

    from meshvae_tpu_torch.ops import (bsr_spmm, cheb, cheb_fused, pool,
                                       pool_transpose)

    @contextlib.contextmanager
    def ctx():
        real = (cheb_fused.cheb_fused_step, cheb.bsr_grouped_spmm,
                pool.pool_transpose)
        cheb_fused.cheb_fused_step = cheb_fused.cheb_fused_step_reference
        cheb.bsr_grouped_spmm = bsr_spmm.bsr_grouped_spmm_reference
        pool.pool_transpose = pool_transpose.pool_transpose_reference
        try:
            yield
        finally:
            (cheb_fused.cheb_fused_step, cheb.bsr_grouped_spmm,
             pool.pool_transpose) = real

    return ctx()


# the fused step's synthetic cases: (B, f_pad, f_out), C = B * f_pad
FUSED_SHAPES = [(16, 16, 16), (4, 32, 16), (1, 128, 8), (8, 16, 3),
                (16, 8, 5)]


def _fused_sweep(torch, dev):
    """The fused step on square patterned operators (G = 1..9, padded
    slots, a dense block, a block with no set bit, every other strip
    empty, sparse tiles) at FUSED_SHAPES, both modes, alpha 1 without
    T_{k-2} and alpha 2 with it: T_k bit-equal to bsr_grouped_spmm with
    the same seed, T_k and acc within 1e-5 of their max of the twin (acc
    1e-4 at bf16x3). Returns the worst error as a share of its bar."""
    from meshvae_tpu_torch.bench.tile_probe import patterned_operator, rel_err
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm
    from meshvae_tpu_torch.ops.cheb_fused import (cheb_fused_step,
                                                  cheb_fused_step_reference)

    gen = torch.Generator().manual_seed(10)
    worst = 0.0
    for g in range(1, 10):
        bsr = patterned_operator(g, torch.float32, dev, seed=g, square=True)
        for b, f_pad, f_out in FUSED_SHAPES:
            c = b * f_pad
            t1, t2 = (torch.randn(bsr.n_pad, c, generator=gen).to(dev)
                      for _ in range(2))
            w = torch.randn(f_pad, f_out, generator=gen).to(dev)
            acc = torch.randn(bsr.n_pad, b * f_out, generator=gen).to(dev)
            for mode in MODES:
                for alpha, prev in ((1.0, None), (2.0, t2)):
                    got_t, got_a = cheb_fused_step(bsr, t1, prev, w,
                                                   acc.clone(), alpha, mode)
                    same = bsr_grouped_spmm(bsr, t1, mode, alpha,
                                            t_prev=prev)
                    torch.cuda.synchronize()
                    want_t, want_a = cheb_fused_step_reference(
                        bsr, t1, prev, w, acc, alpha, mode)
                    bar = TOL_KERNEL if mode == "fp32" else 1e-4
                    errs = (rel_err(got_t, want_t) / TOL_KERNEL,
                            rel_err(got_a, want_a) / bar)
                    worst = max(worst, *errs)
                    if not (torch.equal(got_t, same) and max(errs) <= 1.0):
                        fail(f"cheb_fused_step at G={g} B={b} f_pad={f_pad} "
                             f"f_out={f_out} {mode} alpha {alpha}: T_k "
                             f"bit-equal {torch.equal(got_t, same)}, errors "
                             f"{errs} of the bars")
    return worst


def phase_fused(torch, dev, ops, hier, ops20, hier20):
    """TPU kernel #9 on the card: the fused step and cheb_conv_fused
    against their twins, the step over the synthetic sweep, then times in
    turns beside the main-path conv, the library and both bounds."""
    say("== phase 10: fused propagate + mix (cheb_conv_fused, #9)")
    from meshvae_tpu_torch.bench.tile_probe import fused_bounds, in_turns
    from meshvae_tpu_torch.ops import cheb_fused
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm
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
    launches = dict(cheb_fused.LAUNCHES)
    # ----------------------------------------------------------------------
    want_n = {"fp32": sum(k - 1 for _, _, _, k in shapes), "bf16x3": 6 - 1}
    say(f"cheb_fused_step launches {launches} (expected {want_n}: K - 1 per "
        f"kernel-side conv forward)")
    if launches != want_n:
        fail(f"cheb_fused_step launched {launches}, expected {want_n}")
    worst = _fused_sweep(torch, dev)
    say(f"  synthetic G = 1..9 (padded slots, dense, empty and half-empty "
        f"blocks), (B, f_pad, f_out) in {FUSED_SHAPES}, fp32 and bf16x3: "
        f"T_k bit-equal to bsr_grouped_spmm, worst {worst:.3f} of the bars")

    # --- each step against its twin; per-call times in turns and bounds --
    per_call = {}
    for name, op, b, k in shapes:
        bsr, f = op.bsr, 16
        c = b * f
        t1, t2 = (torch.randn(bsr.n_pad, c, device=dev, generator=gen)
                  for _ in range(2))
        w = 0.1 * torch.randn(f, f, device=dev, generator=gen)
        acc = torch.randn(bsr.n_pad, c, device=dev, generator=gen)
        got_t, got_acc = cheb_fused_step(bsr, t1, t2, w, acc.clone(), 2.0)
        same = bsr_grouped_spmm(bsr, t1, "fp32", 2.0, t_prev=t2)
        torch.cuda.synchronize()
        want_t, want_acc = cheb_fused_step_reference(bsr, t1, t2, w, acc, 2.0)
        errs = [(a - r).abs().max().item() for a, r in
                ((got_t, want_t), (got_acc, want_acc))]
        rel = max(e / r.abs().max().item()
                  for e, r in zip(errs, (want_t, want_acc)))
        worst_abs = max(worst_abs, *errs)
        if not (rel <= TOL_KERNEL and torch.equal(got_t, same)):
            fail(f"cheb_fused_step disagrees at {name}: {rel}, T_k bit-equal "
                 f"to bsr_grouped_spmm {torch.equal(got_t, same)}")
        scratch = acc.clone()
        csr = _csr(torch, normalized_neg_adjacency(adjacency[name]),
                   bsr.n_pad, bsr.n_pad, dev)

        def library():
            t = torch.addmm(t2, csr, t1, beta=-1.0, alpha=2.0)
            return t, acc + torch.matmul(t.reshape(bsr.n_pad, b, f), w
                                         ).reshape(bsr.n_pad, c)

        ms = in_turns({"kernel": lambda: cheb_fused_step(
            bsr, t1, t2, w, scratch, 2.0), "library": library}, 50,
            spread=True)
        p_ms = time_ms(torch, lambda: cheb_fused_step_reference(
            bsr, t1, t2, w, acc, 2.0))
        bnd = fused_bounds(bsr, c, f, f)
        per_call[name] = dict(ms=ms["kernel"], plain_ms=p_ms,
                              library_ms=ms["library"],
                              bound_ms=bnd["bound_ms"],
                              bytes_ms=bnd["bytes_ms"], ops_ms=bnd["ops_ms"],
                              stored_ms=bnd["stored_ms"], k=k)
        say(f"  step {name} C={c}: max_err/max {rel:.3e}, T_k bit-equal to "
            f"bsr_grouped_spmm; kernel {1e3 * ms['kernel']:.1f} us (spread "
            f"{1e3 * ms['kernel_spread']:.1f}), twin {1e3 * p_ms:.1f} us, "
            f"torch.sparse + torch.matmul {1e3 * ms['library']:.1f} us, "
            f"bound {1e3 * bnd['bound_ms']:.2f} us ({bnd['bound_by']}, "
            f"occupied tiles; {1e3 * bnd['stored_ms']:.2f} us with the "
            f"blocks as stored)")

    # --- the conv beside the main path's, forward and forward+backward,
    # in turns (fused, cheb_conv_bsr, cheb_conv_bsr, fused) ---------------
    for name, op, b, k in shapes:
        x = torch.randn(b, op.n, 16, device=dev, generator=gen)
        w = (0.1 * torch.randn(k, 16, 16, device=dev, generator=gen)
             ).requires_grad_(True)
        bias = torch.zeros(16, device=dev, requires_grad=True)
        xg = x.clone().requires_grad_(True)
        convs = {"fused": cheb_conv_fused,
                 "cheb_conv_bsr": lambda a, o, *r, **kw: cheb_conv_bsr(
                     a, o.bsr, *r, **kw)}

        def fwd(conv):
            with torch.no_grad():
                return time_ms(torch, lambda: conv(x, op, w, bias,
                                                   precision="highest"))

        def fwd_bwd(conv):
            return time_ms(torch, lambda: conv(
                xg, op, w, bias, precision="highest").sum().backward(),
                backlog=False)

        row = {}
        for label, timer in (("fwd", fwd), ("fwd+bwd", fwd_bwd)):
            turns = {key: [] for key in convs}
            for key in ("fused", "cheb_conv_bsr", "cheb_conv_bsr", "fused"):
                turns[key].append(timer(convs[key]))
            for key, v in turns.items():
                row[f"{key} {label}"] = statistics.mean(v)
                row[f"{key} {label} spread"] = abs(v[0] - v[1])
        say(f"  conv {name} B={b} K={k}, turns F B B F (ms): " + ", ".join(
            f"{key} {v:.3f}" for key, v in row.items()))
    name = "scaled20k L0"
    entry = {key: v * (per_call[name]["k"] - 1) if key.endswith("ms") else v
             for key, v in per_call[name].items()}
    return entry, launches, worst_abs


def phase_emitted(torch, dev, ops, s20, s80):
    """TPU kernel #10 on the card: emitted_spmm against its twin and
    bsr_grouped_spmm at the level-0 shapes and over the synthetic G = 1..9
    sweep, then its path, the probe (bench/emitted_probe.py) at 5k fp32
    C = 256, 20k fp32 C = 512 and 80k bf16 C = 512, its launches counted,
    and the twin's time. Returns the kernels-line entries' numbers per
    probe run and the launches."""
    say("== phase 11: emitted-pipeline SpMM (emitted_spmm, #10)")
    import argparse

    from meshvae_tpu_torch.bench import emitted_probe
    from meshvae_tpu_torch.bench.tile_probe import (patterned_operator,
                                                    ulp_bar)
    from meshvae_tpu_torch.ops import emitted_spmm as em
    from meshvae_tpu_torch.ops.bsr_spmm import bsr_grouped_spmm

    gen = torch.Generator(device=dev).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    mode_of = {f32: "fp32", bf: "bf16"}
    worst = {f32: 0.0, bf: 0.0}

    def hold(tag, bsr, x, ctas=0):
        """fp32: bit-equal to bsr_grouped_spmm; bf16: within the bf16 ulp
        of max |y| of the twin (and of bsr_grouped_spmm). Returns the
        error as a share of the bar and the bit-equal share."""
        dt = x.dtype
        y = em.emitted_spmm(bsr, x, ctas)
        grouped = bsr_grouped_spmm(bsr, x, mode_of[dt])
        torch.cuda.synchronize()
        twin = em.emitted_spmm_reference(bsr, x).float()
        top = twin.abs().max().item()
        bar = TOL_KERNEL if dt == f32 else ulp_bar(twin)
        err = max((y.float() - r.float()).abs().max().item()
                  for r in (twin, grouped))
        equal = (y == grouped).float().mean().item()
        worst[dt] = max(worst[dt], err)
        if not (err <= bar * top and (dt == bf or equal == 1.0)):
            fail(f"emitted_spmm at {tag} ({dt}, {ctas} CTAs/SM): "
                 f"{err / top:.3e} of max|y| (bar {bar:.3e}), bit-equal to "
                 f"bsr_grouped_spmm {equal:.5f}")
        return err / top / bar, equal

    shapes = [("config-1 L0", ops.lap[0].bsr, 256, f32),
              ("scaled20k L0", s20["ops"].lap[0].bsr, 1024, f32),
              ("scaled80k L0", s80["ops"].lap[0].bsr, 512, bf)]
    for name, bsr, c, dt in shapes:
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen).to(dt)
        share, equal = hold(name, bsr, x)
        say(f"  {name} C={c} {str(dt)[6:]} G={bsr.g_width}: {share:.3f} of "
            f"the bar; bit-equal to bsr_grouped_spmm {equal:.5f}")
    # the work items across G = 1..9 with padded slots, a dense block, a
    # block with no set bit, every other strip empty and sparse tiles, at
    # 1, 2 or the resident CTAs per SM
    sweep = 0.0
    for g in range(1, 10):
        for dt in (f32, bf):
            bsr = patterned_operator(g, dt, dev, seed=g)
            for c in (128, 512, 2048):
                x = torch.randn(bsr.n_pad_cols, c, device=dev,
                                generator=gen).to(dt)
                for ctas in (0, 1, 2):
                    sweep = max(sweep, hold(f"G={g} C={c}", bsr, x, ctas)[0])
    say(f"  synthetic G = 1..9 (padded slots, dense, empty and half-empty "
        f"blocks), C = 128/512/2048, 0/1/2 CTAs per SM cap: fp32 bit-equal "
        f"to bsr_grouped_spmm, worst {sweep:.3f} of the bar")

    # --- the probe: counts reset just before, read just after ------------
    tdir = os.path.dirname(s80["path"])
    runs = {"5k fp32": ["--workload", "5k", "--compute-dtype", "float32",
                        "--batch-size", "16", "--iters", "200",
                        "--cache-dir", os.path.join(os.path.dirname(tdir),
                                                    "cache5")],
            "20k fp32": ["--workload", "20k", "--compute-dtype", "float32",
                         "--iters", "200", "--cache-dir", s20["cache"]],
            "80k bf16": ["--workload", "80k", "--iters", "200",
                         "--cache-dir", s80["cache"]]}
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
        dt = bf if key.endswith("bf16") else f32
        bsr = emitted_probe.level0(argparse.Namespace(
            workload=rep["workload"], template_dir=tdir,
            cache_dir=runs[key][-1]), dev, dt)[0]
        x = torch.randn(bsr.n_pad_cols, rep["c"], device=dev,
                        generator=gen).to(dt)
        plain = time_ms(torch, lambda: em.emitted_spmm_reference(bsr, x))
        info = rep["kernel"]
        say(f"probe {key} C={rep['c']} G={rep['g']}: emitted "
            f"{rep['emitted_ms']:.4f} ms (CTAs/SM "
            f"{rep['emitted_ms_by_ctas_per_sm']}), grouped "
            f"{rep['grouped_ms']:.4f} ms, torch.sparse[{rep['library_dtype']}]"
            f" {rep['library_ms']:.4f} ms, twin {plain:.4f} ms, bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}, occupied tiles; "
            f"{rep['stored_ms']:.4f} as stored); emitted/grouped "
            f"{rep['emitted_ms'] / rep['grouped_ms']:.3f}; spreads "
            f"{rep['spread_ms']}; bit-equal to grouped {rep['bit_equal']:.5f}"
            f"; kernel {info['registers']} registers, {info['dynamic_smem']} "
            f"B shared, {info['local_bytes']} B local, {info['ctas_per_sm']} "
            f"CTAs/SM")
        out[key] = dict(ms=rep["emitted_ms"], plain_ms=plain,
                        library_ms=rep["library_ms"],
                        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
                        stored_ms=rep["stored_ms"],
                        grouped_ms=rep["grouped_ms"],
                        launches=rep["launches"][mode_of[dt]], c=rep["c"])
    say(f"emitted_spmm launches in the probe runs {launches}")
    if not all(e["launches"] > 0 for e in out.values()):
        fail(f"a probe run did not launch emitted_spmm: {launches}")
    return out, launches, worst


def phase_tiles(dev, s80, tmp):
    """The occupied-tile design of bsr_grouped_spmm against the TMA
    pipeline of emitted_spmm (#10, the same tile products) and
    torch.sparse: bench/tile_probe.py's synthetic masks, bsr_grouped_spmm's
    fingerprints against those recorded before its engine moved into
    csrc/tile_engine.cuh (the same bits), the level-0 occupancy and fp32
    bit-equality at 5k, 20k and 80k, and the per-call times in turns."""
    say("== phase 13: occupied 16x16 tiles (bsr_grouped_spmm against "
        "emitted_spmm and torch.sparse, and against its recorded bits)")
    from meshvae_tpu_torch.bench import tile_probe

    argv = ["--workloads", "5k,20k,80k", "--iters", "100"]
    say("probe: python -m meshvae_tpu_torch.bench.tile_probe "
        + " ".join(argv) + " --template-dir <tmp>")
    try:
        return tile_probe.main(argv + [
            "--template-dir", os.path.dirname(s80["path"]),
            "--cache-dir", os.path.join(tmp, "cache_tiles")])
    except SystemExit as exc:
        fail(f"the tile probe failed: {exc}")


# --- phase 14: distribution --------------------------------------------

# (label, operand set, level, modes the configuration runs, C of its
# widest Laplacian call): config 1 serves and trains at high (bf16x3) and
# highest (fp32), scaled20k trains in fp32, scaled80k in bf16
SHARD_CASES = [("config-1 L0", "c1", 0, ("fp32", "bf16x3"), 256),
               ("config-1 L1", "c1", 1, ("fp32", "bf16x3"), 256),
               ("scaled20k L0", "s20", 0, ("fp32",), 1024),
               ("scaled20k L1", "s20", 1, ("fp32",), 1024),
               ("scaled80k L0", "s80", 0, ("bf16",), 512)]
# none, t_prev, t_plus, both, and the lazy seed (not in bf16x3, where the
# seed is eager)
SHARD_KINDS = ("a2", "a2 prev", "a2 plus", "a2 plus prev", "a2 dot prev")
DP_STEPS = 2
SP_STEPS = 2
TIMED_STEPS = 2
PROFILED_STEPS = 1
# ops a rank of phase 14's worlds builds for itself; rank 0 runs in this
# process and takes the ones built here
_PREBUILT = {}


def _shard_products(torch, dev, operands):
    """Phase 14a: every shard of each operator at sp 2 and 4 against the
    unsharded kernel (stacked rows bit-equal in fp32 and bf16, 1e-5 of
    max|y| in bf16x3) and against its twin; prints the shard shapes.
    Returns the worst |kernel - twin| per mode."""
    from meshvae_tpu_torch.ops.bsr_shard import shard_block_sparse_all
    from meshvae_tpu_torch.ops.bsr_spmm import (MODE_DTYPE,
                                                bsr_grouped_spmm,
                                                bsr_grouped_spmm_reference)

    import types

    gen = torch.Generator(device=dev).manual_seed(14)
    worst = {}
    for label, key, level, modes, c in SHARD_CASES:
        for mode in modes:
            dt = MODE_DTYPE[mode]
            bsr = operands[key][mode][level]
            for sp in (2, 4):
                rel, same = 0.0, True
                shards = shard_block_sparse_all(bsr, sp)
                n_glob = shards[0].n_pad_global
                holders = [int((s.op.g_idx >= s.op.num_blocks).all(1).sum())
                           for s in shards]
                say(f" {label} [{mode}] sp={sp}: n {bsr.n}, n_pad "
                    f"{bsr.n_pad} -> n_pad_global {n_glob}; local "
                    f"[{shards[0].rows_local}, {n_glob}]; blocks "
                    f"{[s.op.num_blocks for s in shards]} (unsharded "
                    f"{bsr.num_blocks}), G {[s.op.g_width for s in shards]} "
                    f"(unsharded {bsr.g_width}), rows of placeholders only "
                    f"{holders}")
                x = torch.zeros(n_glob, c, device=dev, dtype=dt)
                x[:bsr.n_pad] = torch.randn(bsr.n_pad, c, device=dev,
                                            generator=gen).to(dt)
                seeds = _seeds(torch, types.SimpleNamespace(n_pad=n_glob),
                               c, gen, dev, dt)
                for kind in SHARD_KINDS:
                    if "dot" in kind and mode == "bf16x3":
                        continue
                    alpha, kw = _seed_args(kind, seeds)
                    rows = lambda r0, r1: {
                        k: ((v[0][r0:r1], v[1]) if k == "t_plus_dot"
                            else v[r0:r1]) for k, v in kw.items()}
                    full = bsr_grouped_spmm(bsr, x[:bsr.n_pad], mode, alpha,
                                            **rows(0, bsr.n_pad))
                    parts = []
                    for s in shards:
                        r0, r1 = s.row0, s.row0 + s.rows_local
                        y = bsr_grouped_spmm(s.op, x, mode, alpha,
                                             **rows(r0, r1))
                        ref = bsr_grouped_spmm_reference(s.op, x, mode,
                                                         alpha, **rows(r0, r1))
                        err = (y.float() - ref.float()).abs().max().item()
                        bar = TOL_BF16 if mode == "bf16" else TOL_KERNEL
                        if not err <= bar * ref.float().abs().max().item():
                            fail(f"{label} [{mode}] sp={sp} shard "
                                 f"{s.sp_rank} {kind}: kernel vs twin "
                                 f"{err:.3e}")
                        worst[mode] = max(worst.get(mode, 0.0), err)
                        parts.append(y)
                    got = torch.cat(parts)[:bsr.n_pad]
                    torch.cuda.synchronize()
                    if mode == "bf16x3":
                        rel = max(rel, ((got - full).abs().max()
                                        / full.abs().max()).item())
                        same = same and bool(torch.equal(got, full))
                        if not rel <= TOL_KERNEL:
                            fail(f"{label} [{mode}] sp={sp} {kind}: stacked "
                                 f"shards vs unsharded {rel:.3e}")
                    elif not torch.equal(got, full):
                        fail(f"{label} [{mode}] sp={sp} {kind}: stacked "
                             f"shards are not bit-equal to the unsharded "
                             f"kernel")
                say(f"  {len(SHARD_KINDS) - (mode == 'bf16x3')} call kinds: "
                    f"stacked shards " + (
                        f"within {rel:.1e} of the unsharded kernel (bit-equal "
                        f"{same})" if mode == "bf16x3" else
                        "bit-equal to the unsharded kernel")
                    + "; each shard within its bar of the twin")
    return worst


def _world_ops(torch, spec, device):
    from meshvae_tpu_torch.mesh import load_obj, load_or_build_hierarchy
    from meshvae_tpu_torch.models import build_operators

    if spec["ops_key"] in _PREBUILT:
        return _PREBUILT[spec["ops_key"]]
    hier = load_or_build_hierarchy(load_obj(spec["template"]),
                                   spec["factors"], cache_dir=spec["cache"])
    return build_operators(hier, device,
                           cheb_method=spec.get("cheb_method", "pallas"),
                           dtype=spec["dtype"])


def _digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode() + v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _world_rank(world, specs):
    """One rank of phase 14's gloo worlds on the shared card: _world_case
    for each spec in turn; rank 0 returns their results."""
    outs = [_world_case(world, spec) for spec in specs]
    return outs if world.rank == 0 else None


def _world_case(world, spec):
    """The spec's deterministic train steps from its weights, then (sp)
    one eval step and the MeshServer request; the launch counts and the
    world's collective counts reset just before and read just after; then
    the step's time, its collectives replayed, and the idle share. Returns
    the results, with every rank's launches, digests and per-step memory
    (peak and the step's own, of the rank's process)."""
    import torch
    import torch.distributed as tdist

    from meshvae_tpu_torch.models import MeshVAE, VAEConfig
    from meshvae_tpu_torch.parallel import fetch
    from meshvae_tpu_torch.train import Trainer

    dev = world.device
    ops = _world_ops(torch, spec, dev)
    kind = spec.get("kind", "vae")
    if kind == "vae":
        model = MeshVAE(VAEConfig.from_config(spec["config"],
                                              coarse_verts=spec["coarse"]))
        model.load_state_dict(spec["weights"])
        tr = Trainer(model, ops, spec["config"], dist=world)
    else:
        tr = _classifier_trainer(spec, ops, dev, world)
    norm = tr.norm_to_device(*spec["norm"])
    out = {"steps": []}
    torch.cuda.synchronize()
    tdist.barrier()
    # --- the main path: counts reset just before, read just after -------
    reset_launches()
    world.reset_stats()
    for i, host in enumerate(spec["batches"]):
        pre = {"model": {k: v.detach().cpu().clone()
                         for k, v in tr.model.state_dict().items()},
               "optimizer": _cpu_state(tr.optimizer.state_dict())}
        batch, res = tr.to_device(host), []
        # (peak, the step's own) MiB of this process: per rank
        mem = _step_memory(torch, lambda: res.append(
            _train_call(tr, kind, batch, norm)))
        packed = res[0]
        out["steps"].append({
            "pre": pre, "metrics": packed.cpu(), "mem_mib": mem,
            "grads": {k: v.grad.detach().cpu().clone()
                      for k, v in tr.model.named_parameters()},
            "params": {k: v.detach().cpu().clone()
                       for k, v in tr.model.named_parameters()}})
    if spec.get("eval_batch") is not None:
        ev = _eval_call(tr, kind, tr.to_device(spec["eval_batch"]), norm)
        out["eval"] = {"loss": ev["scalars"][0].item(),
                       "scalars": ev["scalars"].cpu()}
        if "recon_orig" in ev:
            out["eval"]["recon_orig"] = torch.from_numpy(
                fetch(ev["recon_orig"], world, rows=tr.vertex_shard))
    torch.cuda.synchronize()
    launches = launch_shapes()
    out["by_call"] = launch_calls()
    stats = dict(world.stats)
    # --------------------------------------------------------------------
    out["serve"] = _world_serve(torch, world, spec.get("serve"))
    ranks = [None] * world.size
    tdist.all_gather_object(ranks, {"launches": launches, "stats": stats,
                                    "digest": _digest(tr.model),
                                    "mem_mib": [st["mem_mib"]
                                                for st in out["steps"]]})
    out["ranks"] = ranks
    out.update(_world_times(torch, world, tr, spec, norm))
    return out


def _cpu_state(state):
    if isinstance(state, dict):
        return {k: _cpu_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_cpu_state(v) for v in state]
    return state.detach().cpu().clone() if hasattr(state, "detach") else state


def _world_serve(torch, world, spec):
    """The sp world's MeshServer (config 1, high) answering one request of
    20 meshes; the results on every rank."""
    if spec is None:
        return None
    from meshvae_tpu_torch.infer.serve import MeshServer
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig

    ops = _world_ops(torch, spec, world.device)
    model = MeshVAE(VAEConfig.from_config(spec["config"],
                                          coarse_verts=spec["coarse"]))
    model.load_state_dict(spec["weights"])
    server = MeshServer(model.to(world.device).eval(), ops, *spec["norm"],
                        template=spec["tmpl_v"], faces=spec["tmpl_f"],
                        batch_size=BATCH, save_meshes=False, dist=world)
    try:
        return server.handle(spec["paths"])
    finally:
        server.close()


def _world_times(torch, world, tr, spec, norm):
    """Host-clock step time (median of TIMED_STEPS, each ending in a
    synchronize), one step's all-gathers (count, bytes received by this
    rank, and their time replayed one by one at the same shapes), and
    rank 0's device busy time per step under torch.profiler. Every rank
    runs the same collectives in the same order."""
    import torch.distributed as tdist

    batch = tr.to_device(spec["batches"][0])
    step = lambda: _train_call(tr, spec.get("kind", "vae"), batch, norm)
    times = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times)
    # one step's collectives, recorded, then replayed one by one
    calls = []
    comms = {id(c): c for c in (world.world, world.dp_group,
                                world.sp_group)}.values()

    def recorder(comm, name):
        real = getattr(comm, name)

        def recorded(t, *args, **kwargs):
            calls.append((real, tuple(t.shape), t.dtype))
            return real(t, *args, **kwargs)
        return recorded

    for comm in comms:
        comm.all_gather = recorder(comm, "all_gather")
        comm.all_reduce_ = recorder(comm, "all_reduce_")
    world.reset_stats()
    try:
        step()
    finally:
        for comm in comms:
            del comm.all_gather, comm.all_reduce_
    stats = dict(world.stats)
    gather_ms = 0.0
    for real, shape, dtype in calls:
        t = torch.zeros(shape, dtype=dtype, device=world.device)
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        real(t)
        torch.cuda.synchronize()
        gather_ms += 1e3 * (time.perf_counter() - t0)
    busy = None
    if world.rank == 0:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                step()
            torch.cuda.synchronize()
        busy = sum(t for t, _ in _kernel_times(prof, PROFILED_STEPS)) or None
    else:
        for _ in range(PROFILED_STEPS):
            step()
    return {"step_ms": ms, "step_times": times, "gathers": stats,
            "gather_ms": gather_ms, "busy_us": busy}


def _load_state(tr, pre):
    """A trainer at state `pre` (model and Adam). The optimizer gets a
    copy: load_state_dict keeps Adam's step tensors, which the next step
    increments in place."""
    import copy

    tr.model.load_state_dict(pre["model"])
    tr.optimizer.load_state_dict(copy.deepcopy(pre["optimizer"]))
    return tr


def _adam_on(torch, make_trainer, pre, grads):
    """Params after one Adam step from state `pre` with `grads`."""
    tr = _load_state(make_trainer(), pre)
    for k, v in tr.model.named_parameters():
        v.grad = grads[k].to(v.device)
    tr.optimizer.step()
    return {k: v.detach().cpu() for k, v in tr.model.named_parameters()}


def _single_step(torch, make_trainer, pre, host, norm_host, kind="vae"):
    """The single-process reference of one world step: from `pre` (the
    world's state before it), the full batch, deterministic."""
    tr = _load_state(make_trainer(), pre)
    packed = _train_call(tr, kind, tr.to_device(host),
                         tr.norm_to_device(*norm_host))
    return {"metrics": packed.cpu(),
            "grads": {k: v.grad.detach().cpu()
                      for k, v in tr.model.named_parameters()}}


def _hold_world(torch, label, world_out, make_trainer, host_batches,
                norm_host, grad_bar, lr, yardstick=None, kind="vae"):
    """Each world step against the single-process step from the same
    state: the loss within 1e-5 relative (or, with a yardstick, phase 8's
    bf16 bar), every gradient within grad_bar of its layer's max|g| (or
    the bf16 bar), the world's params bit-equal to (within 1e-2 lr of)
    Adam on the world's gradients from the same state, and every rank's
    params bit-equal."""
    worst = 0.0
    for i, (st, host) in enumerate(zip(world_out["steps"], host_batches)):
        ref = _single_step(torch, make_trainer, st["pre"], host, norm_host,
                           kind)
        w_loss = st["metrics"][0].item()
        s_loss = ref["metrics"][0].item()
        if yardstick is None:
            rel = abs(w_loss - s_loss) / abs(s_loss)
            g_worst = max((st["grads"][k] - g).abs().max().item()
                          / _layer_scale(ref["grads"], k)
                          for k, g in ref["grads"].items())
            ok = rel <= 1e-5 and g_worst <= grad_bar
            detail = (f"loss rel {rel:.2e} (bar 1e-5); worst gradient delta "
                      f"{g_worst:.2e} of its layer's max|g| (bar "
                      f"{grad_bar:g})")
        else:
            y32 = _single_step(torch, yardstick, st["pre"], host, norm_host,
                               kind)
            ulp = 2.0 ** -8
            excess = []
            for name, w, s16, s32, scale in (
                    [("loss", torch.tensor(w_loss), torch.tensor(s_loss),
                      y32["metrics"][0], abs(y32["metrics"][0].item()))]
                    + [(f"grad {k}", st["grads"][k], ref["grads"][k],
                        y32["grads"][k], _layer_scale(y32["grads"], k))
                       for k in ref["grads"]]):
                d_w = float((w - s16).abs().max())
                d_b = float((s16 - s32).abs().max())
                excess.append(((d_w - d_b) / scale, name))
            g_worst, worst_name = max(excess)
            ok = g_worst <= ulp
            detail = (f"loss {w_loss:.6g} vs {s_loss:.6g}; worst "
                      f"(|world - single_bf16| - |single_bf16 - "
                      f"single_fp32|) / scale {g_worst:.3e} at "
                      f"{worst_name} (bar one bf16 ulp, {ulp:.3e})")
        p_adam = _adam_on(torch, make_trainer, st["pre"], st["grads"])
        p_delta = max((st["params"][k] - v).abs().max().item()
                      for k, v in p_adam.items())
        say(f"{label} step {i + 1} vs one process: {detail}; params vs "
            f"Adam on the world's gradients: max delta {p_delta / lr:.2e} "
            f"lr (bar 1e-2 lr)")
        if not ok or p_delta > 1e-2 * lr:
            fail(f"{label}: step {i + 1} disagrees with the single-process "
                 f"step")
        worst = max(worst, g_worst)
    digests = {r["digest"] for r in world_out["ranks"]}
    say(f"{label}: every rank's parameters bit-equal: {len(digests) == 1}")
    if len(digests) != 1:
        fail(f"{label}: the ranks' parameters differ")
    return worst


def _world_report(label, out, batch):
    g = out["gathers"]
    busy = out["busy_us"]
    say(f"{label} [shared-card gloo world, not a scaling result]: step "
        f"{out['step_ms']:.1f} ms (median of {TIMED_STEPS}, host clock, "
        f"{batch / out['step_ms'] * 1e3:.1f} meshes/sec); per step and "
        f"rank {g['all_gather']} all-gathers receiving "
        f"{g['all_gather_bytes'] / 2**20:.1f} MiB and {g['all_reduce']} "
        f"all-reduces of {g['all_reduce_bytes'] / 2**20:.1f} MiB, "
        f"{out['gather_ms']:.1f} ms replayed one by one; "
        + (f"rank 0's device busy {busy / 1e3:.1f} ms/step, idle share "
           f"{1 - busy / (1e3 * out['step_ms']):.2f}" if busy else
           "device busy not measured"))


def _at_shard_shapes(ops, single: dict) -> dict:
    """One process's launch_shapes() as a rank of an sp=2 world launches
    them: a Laplacian call (n_pad, n_pad) at its row shard's
    [rows_local, n_pad_global], a P^T call (n_in, n_out) at its pool
    shard's [x_rows, g_rows], where every level of at least
    ops.bsr_min_n vertices is row-sharded, whatever its layout
    (RowShard.for_level)."""
    from meshvae_tpu_torch.ops.bsr_shard import RowShard

    lap_of, rows_of = {}, {}
    for op in ops.lap:
        if op.bsr is not None or op.n >= ops.bsr_min_n:
            rows = RowShard.for_level(op.n, 2, 0, None)
            rows_of[op.n] = (rows.rows_local, rows.n_pad_global)
            if op.bsr is not None:
                lap_of[op.bsr.n_pad] = rows_of[op.n]
    want = {}
    for (mode, a, b), count in single.items():
        if mode.startswith("pool"):
            key = (mode, rows_of.get(a, (a,))[0],
                   rows_of.get(b, (None, b))[1])
        elif a == b and a in lap_of:
            key = (mode, *lap_of[a])
        else:
            key = (mode, a, b)
        want[key] = want.get(key, 0) + count
    return want


def _hold_eval80(torch, label, out, make80, host, norm_host):
    """The world's eval step (after its train steps) against one process's
    from the world's final state, at phase 8's bar: |world - single_bf16|
    within |single_bf16 - single_fp32| plus one bf16 ulp of the scale, for
    the loss and recon_orig."""
    evs = {}
    for side, tr in (("single16", make80()),
                     ("single32", make80(torch.float32))):
        tr.model.load_state_dict(out["steps"][-1]["params"])
        ev = tr.eval_step(tr.to_device(host), *tr.norm_to_device(*norm_host))
        evs[side] = {"loss": ev["scalars"][0].item(),
                     "recon_orig": ev["recon_orig"].float().cpu()}
    w_ev = out["eval"]
    ulp = 2.0 ** -8
    for name, w, s16, s32, scale in (
            ("eval loss", torch.tensor(w_ev["loss"]),
             torch.tensor(evs["single16"]["loss"]),
             torch.tensor(evs["single32"]["loss"]),
             abs(evs["single32"]["loss"])),
            ("eval recon_orig", w_ev["recon_orig"].float(),
             evs["single16"]["recon_orig"], evs["single32"]["recon_orig"],
             float(evs["single32"]["recon_orig"].abs().max()))):
        d_w = float((w - s16).abs().max())
        d_b = float((s16 - s32).abs().max())
        say(f"{label} {name}: |world - single_bf16| {d_w:.3e}, "
            f"|single_bf16 - single_fp32| {d_b:.3e} (scale {scale:.3e})")
        if not d_w <= d_b + ulp * scale:
            fail(f"{label} {name}: {d_w:.3e} > {d_b:.3e} + one ulp of "
                 f"{scale:.3e}")


def phase_distribution(torch, dev, models, ops, hier, tmpl, norm, many_dir,
                       s20, s80, tmp, card):
    """Phase 14: the shard products (a), a dp=2 world at config 1 (b), an
    sp=2 world at scaled80k bf16 full width in the row layout (activations
    at the block-sparse levels are each rank's rows: its launches and each
    rank's memory beside one process's) and its MeshServer at config 1
    (c), the times of _mapped_product and of pool_transpose at the sp=2
    80k shard shapes (d), crecon and the joint model in a dp=2 and an sp=2
    world (e-g, _classifier_worlds) and the sp=2 world with cheb_method ell
    (h, _ell_world). Returns the kernels-line entry of d and those of g."""
    say("== phase 14: distribution (dp / sp over torch.distributed; "
        "_mapped_product = bsr_grouped_spmm on row shards)")
    import numpy as np

    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                        list_meshes)
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig, build_operators
    from meshvae_tpu_torch.ops.bsr_shard import shard_block_sparse_all
    from meshvae_tpu_torch.parallel import spawn_local
    from meshvae_tpu_torch.train import Trainer

    # --- a. the shard shapes, in one process ----------------------------
    say("-- 14a: shard products against the unsharded kernel and the twin")
    lap = lambda o: [op.bsr for op in o.lap if op.bsr is not None]
    operands = {"c1": {"fp32": lap(ops), "bf16x3": lap(ops)},
                "s20": {"fp32": lap(s20["ops"])},
                "s80": {"bf16": lap(s80["ops"])}}
    worst = _shard_products(torch, dev, operands)

    # --- b. dp=2 at config 1 on the shared card -------------------------
    say("-- 14b: data parallel, 2 gloo ranks on cuda:0, config 1 full width")
    config = config_1(tmp)
    data_dir = os.path.join(tmp, "train_data")   # phase 6's meshes
    dcfg = {"root_dir": data_dir, "checkpoint_dir": os.path.join(tmp, "c14")}
    index, labels = list_meshes(dcfg)
    ds = MeshDataset(index, dcfg, labels, tmpl.v)
    batches = list(BatchIterator(ds, BATCH))[:DP_STEPS]
    weights = {k: v.cpu() for k, v in models["high"].state_dict().items()}
    lr = float(config["learning_rate"])
    _PREBUILT["c1"] = ops
    precisions = ("high", "highest")
    specs = [{"label": f"dp=2 config 1 {p}",
              "config": dict(config, matmul_precision=p),
              "coarse": hier.levels[-1], "weights": weights,
              "norm": (ds.mean, ds.std), "batches": batches,
              "batch_size": BATCH, "ops_key": "c1",
              "template": config["template"],
              "factors": config["downsampling_factors"],
              "cache": config["hierarchy_cache_dir"],
              "dtype": torch.float32} for p in precisions]
    t0 = time.perf_counter()
    outs = spawn_local(_world_rank, 2, 1, "cuda:0", args=(specs,),
                       timeout=600)
    say(f"dp=2: world of 2 ranks ran both precisions in "
        f"{time.perf_counter() - t0:.1f}s (spawn and set-up included)")
    dp_worst = {}
    for p, spec, out in zip(precisions, specs, outs):
        def make(p=p, cfg=spec["config"]):
            m = MeshVAE(models[p].cfg)
            m.load_state_dict(weights)
            return Trainer(m, ops, cfg, device=dev)

        dp_worst[p] = _hold_world(torch, f"dp=2 [{p}]", out, make, batches,
                                  (ds.mean, ds.std),
                                  1e-4 if p == "highest" else 1e-3, lr)
        single = _launches_of(torch, make, batches, (ds.mean, ds.std))
        for r, rank in enumerate(out["ranks"]):
            if rank["launches"] != single:
                fail(f"dp=2 [{p}] rank {r} launched {rank['launches']}, "
                     f"one process {single}")
        say(f"dp=2 [{p}]: launches per rank {out['ranks'][0]['launches']} "
            f"= one process's over the same {DP_STEPS} steps")
        _world_report(f"dp=2 config 1 {p}", out, BATCH)

    # --- c. sp=2 at scaled80k bf16, and a MeshServer at config 1 --------
    say("-- 14c: vertex sharding, 2 gloo ranks on cuda:0, scaled80k bf16 "
        "full width (K=10, B=32)")
    config80 = read_config(os.path.join(ROOT, SCALED_CFG))
    config80.update({"template": s80["path"],
                     "hierarchy_cache_dir": s80["cache"]})
    data80 = os.path.join(tmp, "data80k")          # phase 7's meshes
    d80 = {"root_dir": data80, "checkpoint_dir": os.path.join(tmp, "c14s")}
    index80, labels80 = list_meshes(d80)
    ds80 = MeshDataset(index80[:SP_STEPS * SCALED_BATCH], d80, labels80,
                       s80["tmpl"].v)
    batches80 = list(BatchIterator(ds80, SCALED_BATCH))[:SP_STEPS]
    cfg80 = VAEConfig.from_config(config80,
                                  coarse_verts=s80["hier"].levels[-1])
    weights80 = MeshVAE(cfg80, generator=torch.Generator().manual_seed(
        141)).state_dict()
    _PREBUILT["s80"] = s80["ops"]
    many = sorted(os.path.join(many_dir, f) for f in os.listdir(many_dir))
    spec = {"label": "sp=2 scaled80k bf16", "config": config80,
            "coarse": s80["hier"].levels[-1], "weights": weights80,
            "norm": (ds80.mean, ds80.std), "batches": batches80,
            "eval_batch": batches80[0], "batch_size": SCALED_BATCH,
            "ops_key": "s80", "template": s80["path"],
            "factors": [4, 4, 4, 4], "cache": s80["cache"],
            "dtype": torch.bfloat16,
            "serve": {"config": config, "coarse": hier.levels[-1],
                      "weights": weights, "norm": norm,
                      "tmpl_v": tmpl.v, "tmpl_f": tmpl.f, "paths": many,
                      "ops_key": "c1", "template": config["template"],
                      "factors": config["downsampling_factors"],
                      "cache": config["hierarchy_cache_dir"],
                      "dtype": torch.float32}}
    t0 = time.perf_counter()
    [out] = spawn_local(_world_rank, 1, 2, "cuda:0", args=([spec],),
                        timeout=900)
    say(f"sp=2: world of 2 ranks ran in {time.perf_counter() - t0:.1f}s "
        f"(spawn and set-up included)")
    ops32 = build_operators(s80["hier"], dev, cheb_method="pallas",
                            dtype=torch.float32)

    def make80(dtype=torch.bfloat16):
        m = MeshVAE(cfg80 if dtype == torch.bfloat16 else
                    dataclasses.replace(cfg80, compute_dtype="float32",
                                        precision="highest"))
        m.load_state_dict(weights80)
        return Trainer(m, s80["ops"] if dtype == torch.bfloat16 else ops32,
                       config80, device=dev)

    sp_worst = _hold_world(torch, "sp=2 [scaled80k bf16]", out, make80,
                           batches80, (ds80.mean, ds80.std), None,
                           float(config80["learning_rate"]),
                           yardstick=lambda: make80(torch.float32))
    _hold_eval80(torch, "sp=2", out, make80, batches80[0],
                 (ds80.mean, ds80.std))
    # launches per rank: the single process's Laplacian calls at the shard
    # shapes, and its P^T calls at the pool shards' (the input level's
    # rows of P^T, the output level's gathered rows of g)
    single = _launches_of(torch, make80, batches80, (ds80.mean, ds80.std),
                          eval_batch=batches80[0])
    want = _at_shard_shapes(s80["ops"], single)
    for r, rank in enumerate(out["ranks"]):
        if rank["launches"] != want:
            fail(f"sp=2 rank {r} launched {rank['launches']}, expected the "
                 f"single process's at the shard shapes {want}")
    lap_launches = sum(v for (m, n_pad, cols), v in
                       out["ranks"][0]["launches"].items()
                       if cols == 2 * n_pad)
    pool_launches = {k: v for k, v in out["ranks"][0]["launches"].items()
                     if k[0].startswith("pool")}
    say(f"sp=2: launches per rank {out['ranks'][0]['launches']} = one "
        f"process's {single} at the shard shapes ({lap_launches} "
        f"_mapped_product launches per rank over {SP_STEPS} train steps "
        f"and one eval step; pool_transpose at the pool shards' [rows of "
        f"P^T, gathered rows of g]: {pool_launches})")
    # each rank's memory over the main path's train steps, beside one
    # process's step from the same state (step 2: Adam's state exists)
    _say_rank_memory("sp_memory", "sp=2", out, _single_memory(
        torch, make80, out["steps"][-1]["pre"], batches80[-1],
        (ds80.mean, ds80.std)), card)
    _world_report("sp=2 scaled80k bf16", out, SCALED_BATCH)
    # the sp=2 MeshServer against one process
    from meshvae_tpu_torch.infer.serve import MeshServer

    server = MeshServer(models["high"], ops, *norm,
                        template=tmpl.v, faces=tmpl.f, batch_size=BATCH,
                        save_meshes=False, device=dev)
    try:
        want_srv = server.handle(many)
        scale = float(np.abs(server.preprocess(many)["original"]).max())
    finally:
        server.close()
    got_srv = out["serve"]
    d_err = max(abs(a["reconstruction_error"][k]
                    - b["reconstruction_error"][k])
                for a, b in zip(got_srv, want_srv) for k in ("mean", "max"))
    preds = [a["sex"] for a in got_srv] == [b["sex"] for b in want_srv]
    say(f"sp=2 MeshServer (config 1, high, {len(many)} meshes): pred equal "
        f"{preds}, max error delta {d_err:.3e} (bar {TOL_STEP * scale:.3e}, "
        f"1e-4 of the mesh scale {scale:.1f})")
    if len(got_srv) != len(many) or not preds or d_err > TOL_STEP * scale:
        fail("the sp=2 MeshServer disagrees with one process")

    # --- d. _mapped_product at the sp=2 80k shard shapes ----------------
    say("-- 14d: _mapped_product per call at rank 0's sp=2 scaled80k shard "
        "shapes (median of %d, CUDA events)" % RUNS)
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    operands80 = _operands80(s80["ops"])
    shard_ops, csrs = {}, {}
    for key, bsr in operands80.items():
        if key[0] != "L":
            continue
        shard = shard_block_sparse_all(bsr, 2)[0]
        shard_ops[key] = shard.op
        mat = normalized_neg_adjacency(s80["hier"].adjacency[int(key[1])])
        rows = mat[:min(shard.rows_local, mat.shape[0])]
        f32 = _csr(torch, rows, shard.rows_local, shard.n_pad_global, dev)
        bf = None
        try:
            bf = torch.sparse_csr_tensor(
                f32.crow_indices(), f32.col_indices(),
                f32.values().to(torch.bfloat16), size=f32.shape)
            torch.sparse.mm(bf, torch.ones(f32.shape[1], 128,
                                           dtype=torch.bfloat16, device=dev))
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError):
            bf = None
        csrs[key] = {"fp32": f32, "bf16": bf,
                     "lib_dtype": "bf16" if bf is not None else "fp32"}
    gen = torch.Generator(device=dev).manual_seed(15)
    acc = dict.fromkeys(ACC_KEYS, 0.0)
    rows_out = []
    for label, key, c, kinds in SCALED_CALLS["lap"]:
        bsr = shard_ops[key]
        say(f" {label} ({key} shard 0 of 2, [{bsr.n_pad}, {bsr.n_pad_cols}],"
            f" G {bsr.g_width}):")
        for kind, count in kinds.items():
            got = _time_kind_bf16(torch, bsr, csrs[key], c, kind, gen, dev)
            for k in acc:
                acc[k] += count * got[k]
            rows_out.append(dict(got["row"], shape=label, per_step=count))
    say(f"per sp=2 80k train step, rank 0's _mapped_product calls: kernel "
        f"{acc['ms']:.3f} ms, twin {acc['plain_ms']:.3f} ms, torch.sparse "
        f"{acc['library_ms']:.3f} ms, bound {acc['bound_ms']:.3f} ms "
        f"({_bound_by(acc)}; {acc['stored_ms']:.3f} ms with the blocks as "
        f"stored)")
    say("shape_rows_sp2_80k " + json.dumps(rows_out))
    pool_rows = _pool_shard_times(torch, s80, dev, gen)
    say("shape_rows_sp2_80k_pool_transpose " + json.dumps(pool_rows))
    err = max(worst.values())
    entry = dict(
        name="_mapped_product: bsr_grouped_spmm[bf16] on rank 0's sp=2 "
             "scaled80k row shards, per train step",
        route="cuda", source=SOURCE,
        replaces="meshvae_tpu/ops/pallas_shard.py:150",
        launches=lap_launches, max_abs_err=worst.get("bf16", err),
        ms=acc["ms"], plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
        bound_by=_bound_by(acc), library_ms=acc["library_ms"],
        bound_stored_ms=acc["stored_ms"],
        shapes=sorted({f"[{b.n_pad}, {b.n_pad_cols}]"
                       for b in shard_ops.values()}))
    say(f"phase 14 worst: kernel vs twin {worst}; dp=2 worst gradient "
        f"delta {dp_worst}; sp=2 worst bf16 excess {sp_worst:.3e}")
    classifiers = _classifier_worlds(torch, dev, models, ops, hier, tmpl,
                                     tmp, worst, card)
    _ell_world(torch, dev, s80, config80, batches80, ds80, weights80, card)
    return entry, classifiers


def _pt_shard_case(torch, pool, b, f, dev, gen, tag):
    """pool_transpose on a pool shard (the input level's rows of P^T's CSR;
    g all-gathered to the output level's g_rows): held against its twin
    within TOL_KERNEL (fp32) or one bf16 ulp (bf16) of max|y| and timed
    beside the twin and torch.sparse on the same CSR rows; the bound
    counts the CSR, y and the rows of g that the shard reads, once each.
    Returns the per-call dict of ACC_KEYS plus err_abs and row."""
    from meshvae_tpu_torch.ops import pool_transpose as pt

    dt = pool.t_val.dtype
    mode = pt.DTYPES[dt]
    g = torch.randn(b, pool.g_rows, f, device=dev, generator=gen).to(dt)
    y = pt.pool_transpose(pool, g)
    twin = pt.pool_transpose_reference(pool, g)
    scale = twin.float().abs().max().item()
    err = (y.float() - twin.float()).abs().max().item()
    bar = TOL_KERNEL if mode == "fp32" else TOL_BF16
    if not err <= bar * scale:
        fail(f"pool_transpose on the pool shard {tag} disagrees with its "
             f"twin: {err / scale:.3e} of max|y|")
    lib, lib_dtype = _pt_library(torch, pool, g.transpose(0, 1).reshape(
        pool.g_rows, b * f).contiguous())
    k_ms = time_ms(torch, lambda: pt.pool_transpose(pool, g))
    p_ms = time_ms(torch, lambda: pt.pool_transpose_reference(pool, g))
    l_ms = time_ms(torch, lib)
    nnz, es = pool.t_col.shape[0], g.element_size()
    g_read = int(torch.unique(pool.t_col).numel())
    n_bytes = (es * b * f * (g_read + pool.x_rows)
               + 4 * (pool.x_rows + 1) + (4 + es) * nnz)
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * nnz * b * f / PEAK_OPS["fp32"]
    bound = max(bytes_ms, ops_ms)
    say(f"  {tag} [{pool.x_rows} x {pool.g_rows}, nnz {nnz}, g rows read "
        f"{g_read}, B={b}, f={f}] {mode}: pool_transpose "
        f"{1e3 * k_ms:.1f} us (max_err/max|y| {err / scale:.2e}), twin "
        f"{1e3 * p_ms:.1f} us, torch.sparse[{lib_dtype}] {1e3 * l_ms:.1f} "
        f"us, bound {1e3 * bound:.2f} us")
    row = dict(shape=tag, x_rows=pool.x_rows, g_rows=pool.g_rows, nnz=nnz,
               g_rows_read=g_read, B=b, f=f, mode=mode, kernel_us=1e3 * k_ms,
               plain_us=1e3 * p_ms, library_us=1e3 * l_ms,
               library_dtype=lib_dtype, bound_us=1e3 * bound,
               err=err / scale)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                bytes_ms=bytes_ms, ops_ms=ops_ms, stored_ms=bound,
                err_abs=err, row=row)


def _pool_shards(ops):
    """Rank 0's sp=2 pool shards: every up-pool of `ops` cut at the row
    shards of its block-sparse levels (graph.shard_pool_operator, as
    shard_operators cuts them)."""
    from meshvae_tpu_torch.ops.bsr_shard import RowShard, shard_block_sparse
    from meshvae_tpu_torch.ops.graph import shard_pool_operator

    levels = [None if op.bsr is None else
              RowShard.of(shard_block_sparse(op.bsr, 2, 0), None)
              for op in ops.lap]
    return [shard_pool_operator(up, levels[i + 1], levels[i])
            for i, up in enumerate(ops.up)]


def _pool_shard_times(torch, s80, dev, gen):
    """pool_transpose on rank 0's sp=2 shard of each 80k up-pool's P^T in
    bf16 (_pt_shard_case). Returns the rows."""
    return [_pt_shard_case(torch, pool, SCALED_BATCH, POOL_F[i], dev, gen,
                           f"up-pool {i} P^T sp=2 shard 0")["row"]
            for i, pool in enumerate(_pool_shards(s80["ops"]))]


def _say_rank_memory(tag, label, out, single, card, **extra):
    """Each rank's memory over a world's last train step (the peak of its
    process and the step's own, MiB) beside one process's step from the
    same state, and the `tag` line of every step's, as JSON."""
    steps = len(out["steps"])
    for r, rank in enumerate(out["ranks"]):
        peak, own = rank["mem_mib"][-1]
        say(f"{label} rank {r} memory, train step {steps}: peak {peak:.1f} "
            f"MiB of its process, the step's own {own:.1f} MiB; one "
            f"process: peak {single[0]:.1f} MiB, the step's own "
            f"{single[1]:.1f} MiB ({card}; rank 0 shares this process, "
            f"whose earlier phases hold memory)")
    say(f"{tag} " + json.dumps({
        **extra, "ranks": [rank["mem_mib"] for rank in out["ranks"]],
        "single": single, "unit": "MiB (peak, own) per train step"}))


def _single_memory(torch, make_trainer, pre, host, norm_host, kind="vae"):
    """_step_memory of one process's deterministic train step from state
    `pre` (model and Adam)."""
    tr = _load_state(make_trainer(), pre)
    batch, norm = tr.to_device(host), tr.norm_to_device(*norm_host)
    return _step_memory(torch, lambda: _train_call(tr, kind, batch, norm))


def _launches_of(torch, make_trainer, batches, norm_host, eval_batch=None,
                 kind="vae"):
    """launch_shapes() of the single-process deterministic steps (and
    eval step) that a world's main path runs."""
    tr = make_trainer()
    norm = tr.norm_to_device(*norm_host)
    torch.cuda.synchronize()
    reset_launches()
    for host in batches:
        _train_call(tr, kind, tr.to_device(host), norm)
    if eval_batch is not None:
        _eval_call(tr, kind, tr.to_device(eval_batch), norm)
    torch.cuda.synchronize()
    return launch_shapes()


def _train_call(tr, kind, batch, norm):
    """One deterministic train step (no dropout, z = mu) of a trainer of
    `kind` ("vae", "crecon", "joint"); its packed metrics."""
    if kind == "crecon":
        return tr.train_step(batch)
    return tr.train_step(batch, None, *norm)


def _eval_call(tr, kind, batch, norm):
    return tr.eval_step(batch) if kind == "crecon" else tr.eval_step(
        batch, *norm)


def _classifier_trainer(spec, ops, device, dist=None):
    """spec's crecon (a frozen VAE and a GCN) or joint trainer from its
    weights."""
    from meshvae_tpu_torch.models import (ChebGCN, GCNConfig, MeshVAE,
                                          VAEConfig)
    from meshvae_tpu_torch.models.joint import build_joint_model
    from meshvae_tpu_torch.train import JointTrainer
    from meshvae_tpu_torch.train.crecon_driver import CreconTrainer

    config, coarse, weights = spec["config"], spec["coarse"], spec["weights"]
    if spec["kind"] == "joint":
        model = build_joint_model(config, coarse)
        model.load_state_dict(weights["joint"])
        return JointTrainer(model, ops, config, device=device, dist=dist)
    vae = MeshVAE(VAEConfig.from_config(config, coarse_verts=coarse))
    vae.load_state_dict(weights["vae"])
    gcn = ChebGCN(GCNConfig.from_config(config, coarse_verts=coarse))
    gcn.load_state_dict(weights["gcn"])
    return CreconTrainer(gcn, vae, ops, config, device=device, dist=dist)


def _ell_world(torch, dev, s80, config80, batches80, ds80, weights80, card):
    """Phase 14h: the VAE's sp=2 world at scaled80k bf16 full width with
    cheb_method ell, two gloo ranks on cuda:0: every level of at least
    BSR_MIN_N vertices row-sharded as the rank's rows of its neighbour
    list (the same rows as 14c's block-sparse shards). Its train steps
    and eval step against one process at phase 8's bars, replicas
    bit-equal, launches per rank (pool_transpose at the pool shards; the
    ELL propagation is plain torch), each rank's step memory beside one
    process's, collectives per step and their bytes."""
    say("-- 14h: vertex sharding with cheb_method ell, 2 gloo ranks on "
        "cuda:0, scaled80k bf16 full width (K=10, B=32)")
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig, build_operators
    from meshvae_tpu_torch.parallel import spawn_local
    from meshvae_tpu_torch.train import Trainer

    config = dict(config80, cheb_method="ell")
    hier = s80["hier"]
    ops = {torch.bfloat16: build_operators(hier, dev, cheb_method="ell",
                                           dtype=torch.bfloat16)}
    _PREBUILT["s80ell"] = ops[torch.bfloat16]
    norm = (ds80.mean, ds80.std)
    spec = {"label": "sp=2 scaled80k bf16 ell", "config": config,
            "coarse": hier.levels[-1], "weights": weights80, "norm": norm,
            "batches": batches80, "eval_batch": batches80[0],
            "batch_size": SCALED_BATCH, "ops_key": "s80ell",
            "template": s80["path"], "factors": [4, 4, 4, 4],
            "cache": s80["cache"], "dtype": torch.bfloat16,
            "cheb_method": "ell"}
    t0 = time.perf_counter()
    [out] = spawn_local(_world_rank, 1, 2, "cuda:0", args=([spec],),
                        timeout=900)
    say(f"sp=2 ell: world of 2 ranks ran in {time.perf_counter() - t0:.1f}s "
        f"(spawn and set-up included)")
    cfg = VAEConfig.from_config(config, coarse_verts=hier.levels[-1])

    def make(dtype=torch.bfloat16):
        if dtype not in ops:
            ops[dtype] = build_operators(hier, dev, cheb_method="ell",
                                         dtype=dtype)
        m = MeshVAE(cfg if dtype == torch.bfloat16 else
                    dataclasses.replace(cfg, compute_dtype="float32",
                                        precision="highest"))
        m.load_state_dict(weights80)
        return Trainer(m, ops[dtype], config, device=dev)

    _hold_world(torch, "sp=2 ell [scaled80k bf16]", out, make, batches80,
                norm, None, float(config["learning_rate"]),
                yardstick=lambda: make(torch.float32))
    _hold_eval80(torch, "sp=2 ell", out, make, batches80[0], norm)
    single = _launches_of(torch, make, batches80, norm,
                          eval_batch=batches80[0])
    want = _at_shard_shapes(ops[torch.bfloat16], single)
    for r, rank in enumerate(out["ranks"]):
        if rank["launches"] != want:
            fail(f"sp=2 ell rank {r} launched {rank['launches']}, expected "
                 f"the single process's at the pool-shard shapes {want}")
    if not want or any(not k[0].startswith("pool") for k in want):
        fail(f"sp=2 ell: expected pool_transpose launches alone, {want}")
    say(f"sp=2 ell: launches per rank {out['ranks'][0]['launches']} = one "
        f"process's {single} at the pool-shard shapes [x_rows, g_rows] "
        f"({SP_STEPS} train steps and one eval step)")
    _say_rank_memory("ell_sp_memory", "sp=2 ell", out, _single_memory(
        torch, make, out["steps"][-1]["pre"], batches80[-1], norm), card)
    _world_report("sp=2 scaled80k bf16 ell", out, SCALED_BATCH)
    _PREBUILT.pop("s80ell")
    ops.clear()
    torch.cuda.empty_cache()


# --- phase 14e-g: crecon and the joint model in a world --------------------
CLASSIFIER_WORLDS = {"dp=2": (2, 1), "sp=2": (1, 2)}
WORLD_TRAIN_STEPS = 2   # then one eval step of the padded third batch


def _shard_operands(torch, ops, hier, dev):
    """_operands with L0 and L1 replaced by rank 0's sp=2 row shards, each
    with the torch.sparse CSR of its rows (as 14d's), and P0T-P2T by rank
    0's pool shards, as in the world: up-pool 0's P^T [640 x 5120] and
    up-pool 1's [313 x 1280] (level 2 is whole); up-pool 2's stays whole
    (both its levels are)."""
    from meshvae_tpu_torch.ops.bsr_shard import shard_block_sparse_all
    from meshvae_tpu_torch.ops.graph import normalized_neg_adjacency

    operands = _operands(torch, ops, hier, dev)
    for i in (0, 1):
        shard = shard_block_sparse_all(ops.lap[i].bsr, 2)[0]
        mat = normalized_neg_adjacency(hier.adjacency[i])
        rows = mat[:min(shard.rows_local, mat.shape[0])]
        operands[f"L{i}"] = (shard.op, _csr(torch, rows, shard.rows_local,
                                            shard.n_pad_global, dev))
    for i, pool in enumerate(_pool_shards(ops)[:3]):
        operands[f"P{i}T"] = PoolT(pool, POOL_F[i])
    return operands


def _scaled_calls(calls: dict, div: int) -> dict:
    """A CALLS table at B / div rows per rank: every C divided, but no
    narrower than the kernel's column panel, which pad_features pads
    B x F up to."""
    from meshvae_tpu_torch.ops.bsr_spmm import COL_PANEL

    return {part: [(label, key, max(c // div, COL_PANEL), kinds)
                   for label, key, c, kinds in table]
            for part, table in calls.items()}


def _classifier_worlds(torch, dev, models, ops, hier, tmpl, tmp, worst14,
                       card="card not read"):
    """Phases 14e-g: crecon (config 2: the frozen config-1 VAE, GCN K = 6,
    hidden 128) and the joint model (config 3, files/joint.cfg) at B = 16
    and high in the dp=2 and the sp=2 world (two gloo ranks on cuda:0):
    two deterministic train steps and one eval step of the padded third
    batch, each held against one process on the card at 14b's bars, the
    eval loss within 1e-5 relative, replicas bit-equal, launches per rank
    against one process's (under sp in the row layout: the Laplacian
    calls at the row shards, the P^T at the pool shards) and against
    CRECON_CALLS / JOINT_CALLS (35 / 30, 55 + 3 P^T / 50), each rank's
    step memory beside one process's; the kernel against its twin at
    every (shape, C, call kind) rank 0 launched, and its times at rank
    0's shapes. Returns the kernels-line entries."""
    import numpy as np

    from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                        list_meshes)
    from meshvae_tpu_torch.models import ChebGCN, GCNConfig
    from meshvae_tpu_torch.models.joint import build_joint_model
    from meshvae_tpu_torch.parallel import spawn_local

    say("-- 14e: crecon (config 2) and the joint model (config 3) at "
        "config-1 width, high, B=16, in a dp=2 and an sp=2 world (2 gloo "
        "ranks on cuda:0)")
    configs = _classifier_configs(tmp)
    data_dir = os.path.join(tmp, "train_data")   # phase 6's meshes
    dcfg = {"root_dir": data_dir, "checkpoint_dir": os.path.join(tmp, "c14e")}
    index, labels = list_meshes(dcfg)
    ds = MeshDataset(index, dcfg, labels, tmpl.v)
    batches = list(BatchIterator(ds, BATCH))
    coarse = hier.levels[-1]
    weights = {
        "vae": {k: v.cpu() for k, v in models["high"].state_dict().items()},
        "gcn": ChebGCN(GCNConfig.from_config(configs["crecon"],
                                             coarse_verts=coarse),
                       generator=torch.Generator().manual_seed(142)
                       ).state_dict(),
        "joint": build_joint_model(configs["joint"], coarse,
                                   generator=torch.Generator().manual_seed(
                                       143)).state_dict()}
    _PREBUILT["c1"] = ops
    specs = [{"label": name, "kind": name, "config": configs[name],
              "coarse": coarse, "weights": weights,
              "norm": (ds.mean, ds.std),
              "batches": batches[:WORLD_TRAIN_STEPS],
              "eval_batch": batches[WORLD_TRAIN_STEPS], "batch_size": BATCH,
              "ops_key": "c1", "template": configs[name]["template"],
              "factors": configs[name]["downsampling_factors"],
              "cache": configs[name]["hierarchy_cache_dir"],
              "dtype": torch.float32} for name in ("crecon", "joint")]
    per_train = {"crecon": sum(_table_counts(CRECON_CALLS).values()),
                 "joint": sum(v for (key, _, _), v in
                              _table_counts(JOINT_CALLS).items()
                              if key.startswith("L"))}
    per_eval = {"crecon": CRECON_EVAL_LAUNCHES, "joint": JOINT_EVAL_LAUNCHES}
    pools = {"crecon": 0, "joint": 3}
    steps = {"train": WORLD_TRAIN_STEPS, "eval": 1}
    operands = {"dp=2": _operands(torch, ops, hier, dev),
                "sp=2": _shard_operands(torch, ops, hier, dev)}
    results = {}
    for world_tag, (dp, sp) in CLASSIFIER_WORLDS.items():
        t0 = time.perf_counter()
        outs = spawn_local(_world_rank, dp, sp, "cuda:0", args=(specs,),
                           timeout=600)
        say(f"{world_tag}: world of 2 ranks ran crecon and the joint model "
            f"in {time.perf_counter() - t0:.1f}s (spawn and set-up "
            f"included)")
        for spec, out in zip(specs, outs):
            name, config = spec["kind"], spec["config"]
            label = f"{world_tag} {name}"
            make = lambda spec=spec: _classifier_trainer(spec, ops, dev)
            _hold_world(torch, label, out, make, spec["batches"],
                        spec["norm"], 1e-3, float(config["learning_rate"]),
                        kind=name)
            tr = make()
            tr.model.load_state_dict(out["steps"][-1]["params"])
            ev = _eval_call(tr, name, tr.to_device(spec["eval_batch"]),
                            tr.norm_to_device(*spec["norm"]))
            s_loss = ev["scalars"][0].item()
            rel = abs(out["eval"]["loss"] - s_loss) / abs(s_loss)
            say(f"{label} eval step (padded batch) vs one process from the "
                f"world's final state: loss {out['eval']['loss']:.6g} vs "
                f"{s_loss:.6g}, rel {rel:.2e} (bar 1e-5); scalars "
                f"{out['eval']['scalars'].tolist()} vs "
                f"{ev['scalars'].cpu().tolist()}")
            if not rel <= 1e-5:
                fail(f"{label}: the eval step disagrees with one process")
            single = _launches_of(torch, make, spec["batches"], spec["norm"],
                                  eval_batch=spec["eval_batch"], kind=name)
            by_mode = lambda shapes: {m: sum(v for (mm, _, _), v in
                                             shapes.items() if mm == m)
                                      for m in LAUNCH_KEYS}
            _hold_launches(f"{label} one process", by_mode(single), steps,
                           per_train[name], per_eval[name], pool=pools[name])
            want = _at_shard_shapes(ops, single) if sp > 1 else single
            for r, rank in enumerate(out["ranks"]):
                if rank["launches"] != want:
                    fail(f"{label} rank {r} launched {rank['launches']}, "
                         f"expected one process's {want}")
            say(f"{label}: launches per rank {out['ranks'][0]['launches']} "
                f"= one process's {single}"
                + (" at the shard and pool-shard shapes" if sp > 1 else ""))
            _say_rank_memory(
                "classifier_memory", label, out, _single_memory(
                    torch, make, out["steps"][-1]["pre"],
                    spec["batches"][-1], spec["norm"], name), card,
                world=world_tag, model=name)
            _world_report(label, out, BATCH)
            results[(world_tag, name)] = out

    # --- f. the kernel against its twin at every call rank 0 launched ---
    say("-- 14f: the kernel against its twin at each (shape, C, call kind) "
        "rank 0 launched in the two worlds")
    gen = torch.Generator(device=dev).manual_seed(146)
    worst = {}
    launched_keys = {}
    for world_tag in CLASSIFIER_WORLDS:
        names = _operand_names(operands[world_tag])
        keys = set()
        for name in ("crecon", "joint"):
            keys |= set(results[(world_tag, name)]["by_call"])
        launched_keys[world_tag] = {(names[(n, m)], c, kind)
                                 for _, n, m, c, kind in keys}
        for mode, n, m, c, kind in sorted(keys):
            if mode.startswith("pool"):  # 14g holds pool_transpose's calls
                continue
            bsr = operands[world_tag][names[(n, m)]][0]
            x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen)
            err, _ = _hold(torch, bsr, x, mode, kind,
                           _seeds(torch, bsr, c, gen, dev), TOL_KERNEL,
                           f"{world_tag} {names[(n, m)]} [{n}, {m}] C={c} "
                           f"{mode} {kind}")
            part = "lap" if names[(n, m)].startswith("L") else "pool"
            worst[(world_tag, part)] = max(worst.get((world_tag, part), 0.0),
                                           err)

    # --- g. per-call times at rank 0's shapes, summed per train step ----
    say("-- 14g: the classifiers' kernel calls per train step at rank 0's "
        "shapes (dp=2: B=8 per rank on the whole operators; sp=2: B=16 on "
        "the row shards and the pool shards), median of %d, CUDA events"
        % RUNS)
    entries = []
    for world_tag, (dp, sp) in CLASSIFIER_WORLDS.items():
        rows = []
        tables = {name: _scaled_calls(calls, dp) for name, calls in
                  (("crecon", CRECON_CALLS), ("joint", JOINT_CALLS))}
        # the timed calls are the train steps'; rank 0 launched them all
        # (and, in the eval step, the counterfactual's at B rows)
        unlaunched = {k for table in tables.values()
                      for k in _table_counts(table)} - launched_keys[world_tag]
        if unlaunched:
            fail(f"{world_tag}: the tables time calls rank 0 never "
                 f"launched: {sorted(unlaunched)}")
        for name, table in tables.items():
            acc = {}
            for part, tab in table.items():
                modes = ("bf16x3",) if part == "lap" else ("fp32",)
                acc[part] = _per_step(torch, tab, operands[world_tag], modes,
                                      gen, dev, rows)[modes[0]]
            r0 = results[(world_tag, name)]["ranks"][0]["launches"]
            lap_launches = sum(v for (m, _, _), v in r0.items()
                               if m == "bf16x3")
            shards = " on its row shards" if sp > 1 else ", B=8 per rank"
            lap_err = max(worst.get((world_tag, "lap"), 0.0),
                          worst14.get("bf16x3", 0.0) if sp > 1 else 0.0)
            entries.append(kernel_entry(
                f"bsr_grouped_spmm[bf16x3] {name} train step in the "
                f"{world_tag} world (rank 0{shards}): Laplacian",
                "meshvae_tpu/ops/pallas_shard.py:150" if sp > 1
                else REPLACES["bf16x3"], lap_launches, lap_err, acc["lap"]))
            if name == "joint":
                pools = {k: operands[world_tag][k].pool
                         for k in ("P0T", "P1T", "P2T")}
                p_launch = {k: r0.get(("pool fp32", p.x_rows, p.g_rows), 0)
                            for k, p in pools.items()}
                p_err = max(acc["pool_colmajor"]["err_abs"],
                            acc["pool_grouped"]["err_abs"])
                cut = ("rank 0's pool shards " + ", ".join(
                    f"[{pools[k].x_rows} x {pools[k].g_rows}]"
                    for k in ("P0T", "P1T")) if sp > 1 else "unsharded")
                entries.append(kernel_entry(
                    f"pool_transpose[fp32] joint train step in the "
                    f"{world_tag} world (rank 0): up-pools 0-1 P^T, "
                    f"{cut}", REPLACES["colmajor"],
                    p_launch["P0T"] + p_launch["P1T"], p_err,
                    acc["pool_colmajor"], source=SOURCE_POOL))
                entries.append(kernel_entry(
                    f"pool_transpose[fp32] joint train step in the "
                    f"{world_tag} world (rank 0): up-pool 2 P^T, "
                    "unsharded", REPLACES["grouped"], p_launch["P2T"], p_err,
                    acc["pool_grouped"], source=SOURCE_POOL))
            for part, a in acc.items():
                say(f"{world_tag} {name} per train step, {part}: kernel "
                    f"{a['ms']:.3f} ms, twin {a['plain_ms']:.3f} ms, "
                    f"torch.sparse {a['library_ms']:.3f} ms, bound "
                    f"{a['bound_ms']:.3f} ms ({_bound_by(a)}; "
                    + _acc_tail(a))
        say(f"shape_rows_{world_tag.replace('=', '')}_classifiers "
            + json.dumps(rows))
    return entries


def kernel_entry(name, replaces, launched, err, acc, source=SOURCE):
    """One entry of the kernels line from a per-step sum of times."""
    out = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=launched, max_abs_err=err, ms=acc["ms"],
               plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
               bound_by=_bound_by(acc), library_ms=acc["library_ms"],
               bound_stored_ms=acc.get("stored_ms", acc["bound_ms"]))
    if "old_ms" in acc:  # a P^T: the earlier bsr_grouped_spmm call's time
        out["earlier_ms"] = acc["old_ms"]
    return out


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
    import numpy as np

    from meshvae_tpu_torch.data import (MeshDataset, generate_synthetic_dataset,
                                        list_meshes)
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
    cfg_path = os.path.join(root, "infer.cfg")
    _infer_cfg(cfg_path, dict(config_1(tmp), checkpoint_dir="ckpt/"))
    batches = -(-INFER_MESHES // BATCH)

    def cli(out, device, precision, *flags):
        """main(argv) of the CLI; returns its seconds, run_inference's and
        InferenceEngine.run_dataset's (the device pass and its one pull)."""
        return _infer_cli(torch, [
            "-c", cfg_path, "-d", data_dir, "-o", out, "-n", "1", "-p",
            "matmul_precision", precision, "--device", device, *flags])

    outputs = _infer_outputs
    launches = {}
    for p, mode in (("high", "bf16x3"), ("highest", "fp32")):
        card_out = os.path.join(root, f"card_{p}")
        torch.cuda.synchronize()
        # --- the main path: counts reset just before, read just after ----
        reset_launches()
        secs, pass_secs, _ = cli(card_out, "cuda", p)
        launches[p] = bsr_spmm.launches()
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


# --- phase 15: the scanned epoch --------------------------------------------
SCAN_STEPS = 4           # steps of phase 15's staged epochs
SCAN_TIMED_EPOCHS = 3    # epochs per timing turn (A B B A)
# an eval step at config 1: 4 block-sparse convs x 5 forward, then the
# counterfactual's decode (cheb_dec_2, cheb_dec_3) and encode (cheb_enc_0,
# cheb_enc_1) x 5
CONFIG1_EVAL_LAUNCHES = 40
# the runtime calls that queue device work, counted per step on the host
_HOST_CALLS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")


def _scan_batches(ds, batch, seed):
    """SCAN_STEPS batches of `ds` (drawn with a seeded generator, with
    repetition where the set is small) as host batches; the last step's
    last quarter is padding (mask 0), which the permutations move around."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(SCAN_STEPS):
        idx = rng.integers(0, len(ds.x), batch)
        mask = np.ones(batch, np.float32)
        if i == SCAN_STEPS - 1:
            mask[-batch // 4:] = 0.0
        out.append({"x": ds.x[idx], "label": ds.labels[idx], "r": ds.r[idx],
                    "s": ds.s[idx], "m": ds.m[idx], "mask": mask,
                    "index": idx})
    return out


def _scan_snapshot(tr):
    """The trainer's params, gradients and Adam state, copied."""
    named = dict(tr.model.named_parameters())
    return {"params": {k: v.detach().clone() for k, v in named.items()},
            "grads": {k: v.grad.detach().clone() for k, v in named.items()},
            "adam": {f"{k}:{n}": t.detach().clone() for k, v in named.items()
                     for n, t in tr.optimizer.state[v].items()}}


def _scan_delta(eager, graphed, rows_e, rows_g):
    """Worst graphed-vs-eager deltas: the loss per step (relative), every
    gradient and Adam moment against its layer's max, params absolute;
    and whether every tensor is bit-equal."""
    def group(k):  # (layer, Adam moment)
        name, _, moment = k.partition(":")
        return name.rsplit(".", 1)[0], moment

    def scale(named, k):
        return max(v.abs().max().item() for n, v in named.items()
                   if group(n) == group(k)) or 1.0

    equal = all(a.equal(b) for part in ("params", "grads", "adam")
                for a, b in zip(eager[part].values(),
                                graphed[part].values())) and rows_e.equal(
                                    rows_g)
    loss = ((rows_g[:, 0] - rows_e[:, 0]).abs()
            / rows_e[:, 0].abs()).max().item()
    out = {"bit_equal": equal, "loss_rel": loss,
           "params_abs": max((graphed["params"][k] - v).abs().max().item()
                             for k, v in eager["params"].items())}
    for part in ("grads", "adam"):
        out[part] = max(((graphed[part][k] - v).abs().max()
                         / scale(eager[part], k)).item()
                        for k, v in eager[part].items()
                        if v.is_floating_point() and v.dim())
    return out


def _scan_hold(label, what, d, bar, lr_steps):
    """Bit-equality expected; otherwise the train bars: loss 1e-5
    relative, gradients and Adam's moments `bar` of the layer's max, params
    1e-2 lr per step."""
    say(f"  {what}: " + ("bit-equal" if d["bit_equal"] else
                         "NOT bit-equal: " + json.dumps(
                             {k: v for k, v in d.items()
                              if k != "bit_equal"})))
    if not d["bit_equal"] and not (
            d["loss_rel"] <= 1e-5 and d["grads"] <= bar
            and d["adam"] <= 2 * bar and d["params_abs"] <= 1e-2 * lr_steps):
        fail(f"scanned epoch [{label}] {what}: graphed and eager steps "
             f"disagree beyond the train bars: {d}")


def _no_host_sync(torch, run):
    """The messages of torch's sync debug mode (warn) over run()."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({str(w.message)[:160] for w in caught
                   if "called a synchronizing" in str(w.message)})


def _epoch_profile(torch, run, steps):
    """torch.profiler over one epoch: device busy ms, kernels and device
    ops (kernels, copies, fills; also by name) and host calls that queue
    device work (launches, graph launches, copies, fills), each per
    step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = kernels = device_ops = host = 0
    by_name = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue
        if "CUDA" in str(getattr(evt, "device_type", "")):
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            if us:
                busy += us
                device_ops += evt.count
                by_name[evt.key] = by_name.get(evt.key, 0) + evt.count / steps
                if not evt.key.startswith(("Memcpy", "Memset")):
                    kernels += evt.count
        elif evt.key.startswith("cu") and any(h in evt.key
                                              for h in _HOST_CALLS):
            host += evt.count
    return {"busy_ms": busy / 1e3 / steps, "kernels": kernels / steps,
            "device_ops": device_ops / steps, "host_calls": host / steps,
            "by_name": by_name}


def _epoch_ms(torch, run, steps, epochs=SCAN_TIMED_EPOCHS):
    """Median over `epochs` epochs of (CUDA-event ms per step, host ms per
    step to queue the epoch)."""
    dev_ms, host_ms = [], []
    for _ in range(epochs):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end) / steps)
    return statistics.median(dev_ms), statistics.median(host_ms)


def _epoch_memory(torch, run):
    """(peak allocated, peak reserved) bytes over one epoch, from an
    emptied cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()


def _scan_case(torch, dev, label, model_cfg, ops, config, ds, batch, bar,
               want, flag=False):
    """Phase 15 for one workload: eager and graphed trainers from the same
    weights (see the phase's docstring). Returns its report and the
    graphed run's train launches."""
    import numpy as np

    from meshvae_tpu_torch.models import MeshVAE
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.ops import cheb as port_cheb
    from meshvae_tpu_torch.train import Trainer, phases, set_learning_rate

    say(f"-- 15 [{label}]: B={batch}, {SCAN_STEPS} steps per staged epoch")
    weights = MeshVAE(model_cfg, generator=torch.Generator().manual_seed(
        5)).state_dict()

    def trainer(graphs):
        model = MeshVAE(model_cfg)
        model.load_state_dict(weights)
        tr = Trainer(model, ops, config, device=dev)
        tr.graphs = graphs
        return tr

    host = _scan_batches(ds, batch, seed=3)
    tr = {False: trainer(False), True: trainer(True)}
    staged = tr[True].stage_batches(host, with_index=True)
    two = {k: (v[:2] if k in Trainer.BATCH_KEYS + ("mask_host",) else v)
           for k, v in staged.items()}
    norm = tr[True].norm_to_device(ds.mean, ds.std)
    lr = float(config["learning_rate"])
    n = SCAN_STEPS * batch
    rng = np.random.default_rng(5)
    perms = [rng.permutation(n), rng.permutation(n),
             np.tile(np.arange(batch), SCAN_STEPS)]  # one batch each step
    lrs = [lr, lr / 2, 0.0]
    report = {"case": label, "batch": batch, "steps": SCAN_STEPS}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()  # before any graph of the case
    port_cheb.FUSED_SEED_DOT = flag
    try:
        # --- one replayed step: the warm-up, then the first replay --------
        one = {}
        for graphs, t in tr.items():
            gen = torch.Generator(device=dev).manual_seed(7)
            rows = t.train_epoch_scanned_async(two, gen, *norm,
                                               perm=np.arange(2 * batch))
            one[graphs] = (rows.wait().clone(), _scan_snapshot(t))
        _scan_hold(label, "one replayed step (loss, every gradient, "
                   "params, Adam)", _scan_delta(one[False][1], one[True][1],
                                                one[False][0], one[True][0]),
                   bar, lr * 2)
        for t in tr.values():
            t.model.load_state_dict(weights)
            t.reset_optimizer()

        # --- three epochs: lr, lr / 2, then 0 on one batch each step ------
        epochs, launches, marks = {}, {}, {}
        for graphs, t in tr.items():
            gen = torch.Generator(device=dev).manual_seed(7)
            torch.cuda.synchronize()
            # the main path: counts reset just before, read just after
            reset_launches()
            epochs[graphs] = []
            for rate, perm in zip(lrs, perms):
                set_learning_rate(t.optimizer, rate)
                rows = t.train_epoch_scanned_async(staged, gen, *norm,
                                                   perm=perm)
                epochs[graphs].append((rows.wait().clone(),
                                       _scan_snapshot(t)))
            torch.cuda.synchronize()
            launches[graphs] = (launch_modes(),
                                bsr_spmm.launches_seed_dot())
            marks[graphs] = dict(phases.LAUNCHES)
        for e in range(3):
            _scan_hold(label, f"epoch {e + 1} at lr {lrs[e]:g}",
                       _scan_delta(epochs[False][e][1], epochs[True][e][1],
                                   epochs[False][e][0], epochs[True][e][0]),
                       bar, lr * SCAN_STEPS * (e + 1))
        steps = 3 * SCAN_STEPS
        per_step = {k: {m: c / steps for m, c in d.items() if c}
                    for k, d in zip(("all", "lazy seed"), launches[True])}
        say(f"  launches over {steps} train steps: graphed {launches[True]}"
            f", eager {launches[False]}; per graphed step {per_step}")
        if launches[True] != launches[False] or per_step != want["train"]:
            fail(f"scanned epoch [{label}]: graphed launches "
                 f"{launches[True]} (per step {per_step}), eager "
                 f"{launches[False]}, expected {want['train']} per step")
        report["train_launches"] = launches[True]
        want_marks = dict.fromkeys(phases.slots("train"), steps)
        say(f"  phase marks over {steps} train steps: graphed "
            f"{marks[True]}, eager {marks[False]}")
        if marks != {False: want_marks, True: want_marks}:
            fail(f"scanned epoch [{label}]: phase marks {marks}, expected "
                 f"{want_marks} each")
        report["mark_launches"] = {"train": marks[True]}
        params = [s["params"] for _, s in epochs[True]]
        same_params = all(params[2][k].equal(v) for k, v in params[1].items())
        moved = not all(params[1][k].equal(v) for k, v in params[0].items())
        losses = epochs[True][2][0][:, 0].tolist()
        del params
        say(f"  lr: epoch 3 at lr 0 left the params "
            f"{'as they were' if same_params else 'CHANGED'} (epoch 2 at "
            f"lr/2 moved them: {moved}); its {SCAN_STEPS} replays of one "
            f"batch drew losses {[round(x, 4) for x in losses]}")
        if not (same_params and moved):
            fail(f"scanned epoch [{label}]: the lr set between epochs was "
                 f"not followed by the graph")
        if len(set(losses)) != SCAN_STEPS:
            fail(f"scanned epoch [{label}]: replays drew the same dropout "
                 f"masks and noise: losses {losses}")

        # --- the eval variants, graphed vs eager vs evaluate() -------------
        evals = {}
        reset_launches()
        ev_launches, ev_marks = {}, {}
        for graphs, t in tr.items():
            before = sum(bsr_spmm.launches().values())
            phases.reset_launches()
            evals[graphs] = {v: t.finalize_eval_scanned(
                t.evaluate_scanned_async(staged, *norm,
                                         collect_meshes=v == "collect",
                                         with_errors=v != "light"),
                with_errors=v != "light")
                for v in ("light", "errors", "collect")}
            ev_launches[graphs] = sum(bsr_spmm.launches().values()) - before
            ev_marks[graphs] = dict(phases.LAUNCHES)
        plain = tr[False].evaluate(host, ds.mean, ds.std,
                                   collect_meshes=True)
        scale = float(np.abs(ds.original).max())
        worst = 0.0
        for v in ("light", "errors", "collect"):
            a, b = evals[False][v], evals[True][v]
            ok = a[0] == b[0] and all(
                (x is None and y is None) or (
                    {k: np.array_equal(x[k], y[k]) for k in x}
                    == {k: True for k in x} if isinstance(x, dict)
                    else np.array_equal(x, y)) for x, y in zip(a[1:], b[1:]))
            if not ok:
                fail(f"scanned epoch [{label}]: the graphed {v} eval differs "
                     f"from the eager one")
        for x, y in ((evals[True]["collect"][1], plain[1]),
                     (evals[True]["collect"][2]["recon"], plain[2]["recon"]),
                     (evals[True]["collect"][2]["oppo"], plain[2]["oppo"])):
            worst = max(worst, float(np.abs(x - y).max()) / scale)
        rel = abs(evals[True]["collect"][0]["loss"] - plain[0]["loss"]) / abs(
            plain[0]["loss"])
        say(f"  eval: graphed light/errors/collect equal to the eager "
            f"scanned ones; against the per-batch evaluate(): loss rel "
            f"{rel:.2e}, errors and meshes {worst:.2e} of the mesh scale "
            f"(bars 1e-5, 1e-4); launches graphed {ev_launches[True]}, eager "
            f"{ev_launches[False]}")
        if rel > 1e-5 or worst > 1e-4 or not np.array_equal(
                evals[True]["collect"][2]["oppo_pred"],
                plain[2]["oppo_pred"]):
            fail(f"scanned epoch [{label}]: the scanned eval and "
                 f"evaluate() disagree")
        want_ev = 3 * SCAN_STEPS * want["eval"]
        if ev_launches != {False: want_ev, True: want_ev}:
            fail(f"scanned epoch [{label}]: eval launches {ev_launches}, "
                 f"expected {want_ev} each")
        want_marks = dict.fromkeys(phases.slots("light"), 3 * SCAN_STEPS)
        if ev_marks != {False: want_marks, True: want_marks}:
            fail(f"scanned epoch [{label}]: eval phase marks {ev_marks}, "
                 f"expected {want_marks} each")
        report["mark_launches"]["eval"] = ev_marks[True]
        report["capture_s"] = {k: round(st.graph.capture_seconds, 3)
                               for k, st in tr[True]._scans.items()}
        del one, epochs, evals, plain  # the copies compared above

        # --- no host sync inside the eager scanned epoch ------------------
        t = tr[True]
        shuffle = torch.Generator(device=dev).manual_seed(9)
        gen = torch.Generator(device=dev).manual_seed(8)
        run = lambda: t.train_epoch_scanned_async(staged, gen, *norm,
                                                  shuffle_generator=shuffle)
        run()  # a new generator: warm-up and capture before the times
        t.graphs = False
        syncs = _no_host_sync(torch, run)
        t.graphs = True
        say(f"  host syncs in an eager scanned epoch: {syncs or 'none'}")
        if syncs:
            fail(f"scanned epoch [{label}]: the step syncs with the host: "
                 f"{syncs}")

        # --- times A B B A (A eager steps, B replays), the per-step loop ---
        times = {}
        for graphs in (False, True, True, False):
            t.graphs = graphs
            times.setdefault(graphs, []).append(
                _epoch_ms(torch, run, SCAN_STEPS))
        gen_loop = torch.Generator(device=dev).manual_seed(8)
        loop_ms = _epoch_ms(torch, lambda: t.train_epoch(
            host, gen_loop, ds.mean, ds.std), SCAN_STEPS)
        prof = {}
        mem = {}
        for graphs in (False, True):
            t.graphs = graphs
            prof[graphs] = _epoch_profile(torch, run, SCAN_STEPS)
            mem[graphs] = _epoch_memory(torch, run)
        t.graphs = True
        # the graphs' private pools (train and three evals) and both
        # trainers' gradients and Adam state: reserved memory now, cache
        # emptied, minus before the case's first step
        torch.cuda.empty_cache()
        report["pools_gib"] = (torch.cuda.memory_reserved()
                               - reserved) / 2**30
        bsr = sum(v for k, v in per_step["all"].items()
                  if not k.startswith("pool"))
        pt_step = sum(v for k, v in per_step["all"].items()
                      if k.startswith("pool"))
        for graphs, name in ((False, "eager"), (True, "graphed")):
            ms = [d for d, _ in times[graphs]]
            report[name] = {
                "step_ms": ms, "queue_ms": [h for _, h in times[graphs]],
                "busy_ms": prof[graphs]["busy_ms"],
                "idle": [1 - prof[graphs]["busy_ms"] / m for m in ms],
                "kernels_per_step": prof[graphs]["kernels"],
                "device_ops_per_step": prof[graphs]["device_ops"],
                "host_calls_per_step": prof[graphs]["host_calls"],
                "peak_allocated_gib": mem[graphs][0] / 2**30,
                "peak_reserved_gib": mem[graphs][1] / 2**30}
        report["per_step_loop_ms"] = loop_ms[0]
        report["bsr_grouped_spmm_per_step"] = bsr
        report["pool_transpose_per_step"] = pt_step
        e, g = report["eager"], report["graphed"]
        say(f"  per step A B B A: eager {e['step_ms'][0]:.3f} / "
            f"{e['step_ms'][1]:.3f} ms, graphed {g['step_ms'][0]:.3f} / "
            f"{g['step_ms'][1]:.3f} ms (host queues a step in "
            f"{e['queue_ms'][0]:.3f} / {g['queue_ms'][0]:.3f} ms); the "
            f"per-step loop {loop_ms[0]:.3f} ms")
        say(f"  device busy {e['busy_ms']:.3f} / {g['busy_ms']:.3f} ms per "
            f"step, idle share {e['idle'][0]:.2f} / {g['idle'][0]:.2f}; "
            f"kernels per step {e['kernels_per_step']:.0f} / "
            f"{g['kernels_per_step']:.0f} (bsr_grouped_spmm {bsr:.0f}, "
            f"pool_transpose {pt_step:.0f}); host"
            f" calls per step {e['host_calls_per_step']:.1f} / "
            f"{g['host_calls_per_step']:.1f}; peak allocated "
            f"{e['peak_allocated_gib']:.2f} / {g['peak_allocated_gib']:.2f} "
            f"GiB (a replay allocates nothing: its activations sit in the "
            f"graph's pool), reserved {e['peak_reserved_gib']:.2f} / "
            f"{g['peak_reserved_gib']:.2f} GiB (both with the pools); the "
            f"pools hold {report['pools_gib']:.2f} GiB; capture s "
            f"{report['capture_s']}")
        # one graph launch per step, and the epoch's own few calls (the
        # permutation, the step index, the normalisation, the one pull)
        if (g["host_calls_per_step"] > 1 + 32 / SCAN_STEPS
                or g["kernels_per_step"] < bsr):
            fail(f"scanned epoch [{label}]: replays made "
                 f"{g['host_calls_per_step']} host calls and "
                 f"{g['kernels_per_step']} kernels per step")
        diff = {k: round(prof[True]["by_name"].get(k, 0)
                         - prof[False]["by_name"].get(k, 0), 2)
                for k in set(prof[True]["by_name"]) | set(
                    prof[False]["by_name"])}
        diff = sorted(((v, k) for k, v in diff.items() if v), reverse=True)
        say(f"  device ops per step, graphed minus eager: "
            f"{[(v, k[:60]) for v, k in diff[:6] + diff[-6:]]}")
    finally:
        port_cheb.FUSED_SEED_DOT = False
    say("scan_case " + json.dumps(report))
    return report


def _scan_driver_run(torch, dev, hier, tmp):
    """python -m meshvae_tpu_torch.train's run() with files/default.cfg
    (scan_epoch left at its default, True) at config-1 width on the block-
    sparse path (cheb_method pallas): train, test and -v on phase 6's 40
    synthetic meshes, 2 folds x 2 epochs, profile_dir set, counts reset
    just before and read just after: 38 launches per train step and 40 per
    eval step; never the per-step loop; history, checkpoints, the .obj
    triples, epoch 2's trace with the kernels; the log names the graphs."""
    from meshvae_tpu_torch.config import read_config

    config = read_config(os.path.join(ROOT, "files", "default.cfg"))
    if not config["scan_epoch"] or "pipeline_epochs" in config:
        fail("files/default.cfg no longer leaves the scanned, pipelined "
             "epoch on")
    from meshvae_tpu_torch.train import Trainer

    ckpt = os.path.join(tmp, "ckpt_default")
    prof = os.path.join(tmp, "profile_default")
    config.update({   # paths, folds, epochs, the profiler, block-sparse path
        "template": os.path.join(ROOT, "template", "template5k.obj"),
        "root_dir": os.path.join(tmp, "train_data"), "checkpoint_dir": ckpt,
        "log_file": os.path.join(ckpt, "log.txt"),
        "hierarchy_cache_dir": os.path.join(tmp, "cache"), "folds": 2,
        "epoch": 2, "profile_dir": prof, "cheb_method": "pallas"})
    per_step_loop = (Trainer.train_epoch, Trainer.evaluate)

    def refuse(*args, **kwargs):
        fail("the default config ran the per-step loop (train_epoch or "
             "evaluate, one pull per step)")

    Trainer.train_epoch = Trainer.evaluate = refuse
    try:
        results, secs, steps, launches, _, _ = _run_driver(torch, config,
                                                           dev, vis=True)
    finally:
        Trainer.train_epoch, Trainer.evaluate = per_step_loop
    _trace_report(prof, folds=2)  # epoch 2's replayed kernels, traced
    want = {**dict.fromkeys(LAUNCH_KEYS, 0),
            "fp32": TRAIN_LAP_LAUNCHES * steps["train"]
            + CONFIG1_EVAL_LAUNCHES * steps["eval"],
            "pool fp32": TRAIN_POOL_LAUNCHES * steps["train"]}
    if steps["train"] < 1 or launches != want:
        fail(f"default.cfg run launched {launches}, expected {want} "
             f"({steps})")
    _check_run(config, ckpt, results, hier)
    with open(os.path.join(ckpt, "log.txt")) as fp:
        line = [l for l in fp if l.startswith("epochs:")]
    if not line or "CUDA graphs" not in line[0] or "pipelined" not in line[0]:
        fail(f"default.cfg run did not log the graphed epoch: {line}")
    triples = 0
    for fold in (1, 2):
        for d in ("sex_change_S", "sex_change_F"):
            path = os.path.join(ckpt, f"mesh{fold}", d)
            triples += len(os.listdir(path)) if os.path.isdir(path) else 0
    if triples != 3 * TRAIN_MESHES:  # each mesh is tested in one fold
        fail(f"default.cfg run wrote {triples} .obj files, expected "
             f"{3 * TRAIN_MESHES}")
    say(f"  default.cfg (scan_epoch default): {line[0].strip()}; {secs:.1f}s"
        f", {steps} steps, launches {launches}, {triples} .obj files")
    return launches


def phase_scan(torch, dev, models, ops, hier, s20, s80, tmp):
    """Phase 15: the scanned epoch's CUDA graphs against the same steps run
    eagerly at config 1 (high, highest), scaled20k fp32 with the lazy seed
    and scaled80k bf16, then a default.cfg driver run. Returns the reports
    and the graphed train launches per case."""
    say("== phase 15: scanned epoch (staged on the device, reshuffled there;"
        " CUDA graphs of the train and eval steps against the same steps "
        "run eagerly)")
    import gc

    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.data import MeshDataset, list_meshes
    from meshvae_tpu_torch.mesh import TriMesh
    from meshvae_tpu_torch.models import VAEConfig

    def dataset(data_dir, template, limit=None):
        index, labels = list_meshes({"root_dir": data_dir})
        norm_dir = os.path.join(tmp, "scan_norm_" + os.path.basename(data_dir))
        return MeshDataset(index[:limit], {"root_dir": data_dir,
                                           "checkpoint_dir": norm_dir},
                           labels, template.v)

    config1 = config_1(tmp)
    c80 = read_config(os.path.join(ROOT, SCALED_CFG))
    c20 = read_config(os.path.join(ROOT, SCALED20_CFG))
    ds1 = dataset(os.path.join(tmp, "train_data"),
                  TriMesh(hier.vertices[0], hier.faces[0]))
    pools20 = sum(up.t_bsr is not None for up in s20["ops"].up)
    cases = [
        ("config-1 high", models["high"].cfg, ops, config1, ds1, BATCH,
         1e-3, {"train": {"all": {"bf16x3": TRAIN_LAP_LAUNCHES,
                                  "pool fp32": TRAIN_POOL_LAUNCHES},
                          "lazy seed": {}}, "eval": CONFIG1_EVAL_LAUNCHES},
         False),
        ("config-1 highest", models["highest"].cfg, ops,
         dict(config1, matmul_precision="highest"), ds1, BATCH, 1e-4,
         {"train": {"all": {"fp32": TRAIN_LAP_LAUNCHES,
                            "pool fp32": TRAIN_POOL_LAUNCHES},
                    "lazy seed": {}},
          "eval": CONFIG1_EVAL_LAUNCHES}, False),
        ("scaled20k fp32, FUSED_SEED_DOT",
         VAEConfig.from_config(c20, coarse_verts=s20["hier"].levels[-1]),
         s20["ops"], c20, None, SCALED20_BATCH, 1e-4,
         {"train": {"all": {"fp32": SCALED20_FWD + SCALED20_BWD,
                            "pool fp32": pools20},
                    "lazy seed": {"fp32": SCALED20_SEED_DOT}},
          "eval": SCALED20_EVAL}, True),
        ("scaled80k bf16",
         VAEConfig.from_config(c80, coarse_verts=s80["hier"].levels[-1]),
         s80["ops"], c80, None, SCALED_BATCH, 2.0 ** -8,
         {"train": {"all": {"bf16": SCALED_TRAIN_LAUNCHES,
                            "pool bf16": SCALED_POOL_LAUNCHES},
                    "lazy seed": {}}, "eval": SCALED_EVAL_LAUNCHES}, False),
    ]
    reports = []
    for label, cfg, operators, config, ds, batch, bar, want, flag in cases:
        if ds is None:
            scaled = s20 if "20k" in label else s80
            ds = dataset(os.path.join(tmp, "data20k" if "20k" in label
                                      else "data80k"), scaled["tmpl"],
                         limit=batch)
        reports.append(_scan_case(torch, dev, label, cfg, operators, config,
                                  ds, batch, bar, want, flag))
        del ds
        gc.collect()
        torch.cuda.empty_cache()
    default_launches = _scan_driver_run(torch, dev, hier, tmp)
    return reports, default_launches


# --- phase 16: the classifier pipelines --------------------------------------
CLASSIFIER_EPOCHS = 2
CRECON_FOLDS = 5        # crecon's run() runs five whatever `folds` says
JOINT_FOLDS = 2
# calls per step at config 1 (K = 6), as TRAIN_CALLS. crecon: the frozen
# VAE's enc_0 (L0, F 3 -> C 128) and enc_1 (L1, C 256) at B, its dec_2 and
# dec_3 at 2B (C 512), the GCN's cheb_0 (L0, F 6 -> f_pad 8, C 128) and
# cheb_1 (L1, C 256), and only cheb_1's dx backward (the GCN's input is a
# constant). The joint model: the same forward, the backward of every
# conv but enc_0 (cheb_0's dx too), and the P^T of up-pools 0-2 at 2B
# width (C 512, 512, 1024).
_FWD = {"a1": 1, "a2 prev": 4}
_twice = lambda kinds: {k: 2 * v for k, v in kinds.items()}
CRECON_CALLS = {
    "lap": [("enc_0+cheb_0 L0", "L0", 128, _twice(_FWD)),
            ("enc_1+cheb_1 L1", "L1", 256, {**_twice(_FWD), **_BWD}),
            ("2B dec_2 L1", "L1", 512, _FWD),
            ("2B dec_3 L0", "L0", 512, _FWD)]}
JOINT_CALLS = {
    "lap": [("enc_0+cheb_0 L0", "L0", 128, {**_twice(_FWD), **_BWD}),
            ("enc_1+cheb_1 L1", "L1", 256, _twice({**_FWD, **_BWD})),
            ("2B dec_2 L1", "L1", 512, {**_FWD, **_BWD}),
            ("2B dec_3 L0", "L0", 512, {**_FWD, **_BWD})],
    "pool_colmajor": [("up-pool 0 P^T at 2B", "P0T", 512, {"a1": 1}),
                      ("up-pool 1 P^T at 2B", "P1T", 512, {"a1": 1})],
    "pool_grouped": [("up-pool 2 P^T at 2B", "P2T", 1024, {"a1": 1})]}
CRECON_EVAL_LAUNCHES = 30   # the train step's forward
JOINT_EVAL_LAUNCHES = 50    # forward + the counterfactual's decode, encode


# phase 15b: the stamps [S, P] of the benchmark cells' scanned epochs
MARK_CELLS = (("vae80k train", 16, "train"), ("vae80k light", 4, "light"),
              ("vae5k train", 32, "train"), ("vae5k light", 8, "light"))
MARK_SENTINEL = -7
MARKS_TIMED = 100  # marks (and plain writes) per timed graph


def _mark_step(stamps, step, slots):
    """A scanned step's marks alone: every slot of row ``step``, then the
    step index moves on (as train/loop.py's _scan_*_step)."""
    from meshvae_tpu_torch.train import phases

    marks = phases.Marks(stamps, step, slots)

    def run():
        for name in slots:
            marks(name)
        step.add_(1)
    return run


def _graph_ms(torch, fn, n):
    """Device ms per call of fn, captured n times in one CUDA graph."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            fn()
    return time_ms(torch, graph.replay) / n


def phase_marks(torch, dev):
    """Phase 15b (see the module docstring): the phase mark kernel in a
    replayed step graph against the CPU path, and its time."""
    import numpy as np

    from meshvae_tpu_torch.train import phases
    from meshvae_tpu_torch.train.graphs import StepGraph

    say("== phase 15b: phase marks (ops/csrc/phase_mark.cu) replayed in a "
        "step graph at the cells' stamps vs the CPU path")
    wrong = 0
    for label, steps, kind in MARK_CELLS:
        slots = phases.slots(kind)
        shape = (steps, len(slots))
        # the CPU path's written cells after each step
        cpu = torch.full(shape, MARK_SENTINEL, dtype=torch.int64)
        cpu_step = _mark_step(cpu, torch.zeros(1, dtype=torch.long), slots)
        want = []
        for _ in range(steps):
            cpu_step()
            want.append(cpu.numpy() != MARK_SENTINEL)
        stamps = torch.full(shape, MARK_SENTINEL, dtype=torch.int64,
                            device=dev)
        step = torch.zeros(1, dtype=torch.long, device=dev)
        graph = StepGraph(_mark_step(stamps, step, slots),
                          lambda: [stamps, step], name=kind)
        graph()
        graph()  # the warm-up, then the capture and its first replay
        if graph.graph is None:
            fail(f"phase marks [{label}]: the step was not captured")
        stamps.fill_(MARK_SENTINEL)
        step.zero_()
        phases.reset_launches()
        before = stamps.cpu().numpy()
        bad, apart = [], 0
        for i in range(steps):
            graph()
            got = stamps.cpu().numpy()
            cells = int(((got != MARK_SENTINEL) != want[i]).sum())
            row = got[i]
            if (cells or not np.array_equal(got[:i], before[:i])
                    or (row <= 0).any() or (np.diff(row) < 0).any()
                    or (i and row[0] < got[i - 1, -1])):
                bad.append((i, cells))
            apart += cells
            before = got
        wrong += apart
        flat = before.reshape(-1)
        launches = dict(phases.LAUNCHES)
        say(f"  [{label}] stamps {list(shape)}: {steps} replays, each wrote "
            f"its own row and no other cell (cells apart from the CPU path: "
            f"{apart}; steps at fault {bad or 'none'}); stamps from "
            f"{int(flat[0])} ns over {(flat[-1] - flat[0]) * 1e-3:.1f} us, "
            f"never decreasing: {bool((np.diff(flat) >= 0).all())}; "
            f"launches counted {launches}")
        if (bad or not (np.diff(flat) >= 0).all()
                or launches != dict.fromkeys(slots, steps)
                or int(step.item()) != steps):
            fail(f"phase marks [{label}]: replays at fault {bad}, launches "
                 f"{launches} (expected {steps} a slot), step index "
                 f"{int(step.item())}")
    # one mark, and the plain write of the same cell at the device index
    # (no clock), each timed as a graph of MARKS_TIMED
    slots = phases.slots("train")
    stamps = torch.zeros((32, len(slots)), dtype=torch.int64, device=dev)
    step = torch.zeros(1, dtype=torch.long, device=dev)
    marks = phases.Marks(stamps, step, slots)
    column = stamps[:, 1]
    ms = _graph_ms(torch, lambda: marks("forward"), MARKS_TIMED)
    plain_ms = _graph_ms(torch, lambda: column.index_fill_(0, step, 1),
                         MARKS_TIMED)
    say(f"  one mark {ms * 1e3:.2f} us, the plain write of its cell "
        f"{plain_ms * 1e3:.2f} us (device time per call in a graph of "
        f"{MARKS_TIMED}); bound: the launch (one thread, 16 bytes)")
    return {"err": wrong, "ms": ms, "plain_ms": plain_ms}


def _table_counts(calls: dict) -> dict:
    """{(operand, C, kind): calls per step} of a CALLS table."""
    out = {}
    for table in calls.values():
        for _, key, c, kinds in table:
            for kind, n in kinds.items():
                out[(key, c, kind)] = out.get((key, c, kind), 0) + n
    return out


def _launch_table(by_call: dict, names: dict, steps: int) -> dict:
    """LAUNCHES_BY_CALL of `steps` steps as {(operand, C, kind): calls per
    step}, the operand named by its (n_pad, n_pad_cols)."""
    return {(names[(n, m)], c, kind): count / steps
            for (_, n, m, c, kind), count in by_call.items()}


def _classifier_configs(tmp, bf16=False):
    """files/crecon.cfg and files/joint.cfg with overrides for paths,
    folds, epochs and the block-sparse path at high, or at compute_dtype
    bfloat16 with checkpoints of their own; crecon's frozen VAE is phase
    15's default.cfg run() fold-1 checkpoint (config-1 width, trained on
    phase 6's meshes)."""
    from meshvae_tpu_torch.config import read_config

    out = {}
    for name, extra in (
            ("crecon", {"checkpoint_file": os.path.join(
                tmp, "ckpt_default", "checkpoint_1.pt")}),
            ("joint", {"folds": JOINT_FOLDS})):
        config = read_config(os.path.join(ROOT, "files", f"{name}.cfg"))
        ckpt = os.path.join(tmp, f"ckpt_{name}" + ("16" if bf16 else ""))
        config.update({
            "template": os.path.join(ROOT, "template", "template5k.obj"),
            "root_dir": os.path.join(tmp, "train_data"),
            "checkpoint_dir": ckpt, "log_file": os.path.join(ckpt, "log.txt"),
            "hierarchy_cache_dir": os.path.join(tmp, "cache"),
            "epoch": CLASSIFIER_EPOCHS, "cheb_method": "pallas",
            "matmul_precision": "high", **extra})
        if bf16:
            config["compute_dtype"] = "bfloat16"
        out[name] = config
    return out


def _hold_launches(label, launches, steps, per_train, per_eval, pool=0,
                   lap="bf16x3", pool_mode="fp32"):
    """A main-path run's launches (launch_modes) against its per-step
    counts: at high the Laplacian calls are bf16x3 and the P^T
    (pool_transpose) fp32; in bf16 both are bf16."""
    want = dict.fromkeys(LAUNCH_KEYS, 0)
    want[lap] += per_train * steps["train"] + per_eval * steps["eval"]
    want[f"pool {pool_mode}"] += pool * steps["train"]
    say(f"  {label} launches {launches} over {steps} steps (expected "
        f"{want}: {per_train} Laplacian + {pool} P^T per train step, "
        f"{per_eval} per eval step)")
    if steps["train"] < 1 or launches != want:
        fail(f"{label}: launched {launches}, expected {want} ({steps})")


def _graphs_logged(config, label):
    """The run's log line naming its epoch mode; fails unless it names
    the CUDA graphs."""
    with open(config["log_file"]) as fp:
        mode = [l.strip() for l in fp if l.startswith("epochs:")]
    if not mode or "CUDA graphs" not in mode[0]:
        fail(f"{label} run() did not run its steps as CUDA graphs: {mode}")
    return mode[0]


def _steps(torch, make, batch_of, sides):
    """One deterministic train step (no dropout, z = mu) of make(side) on
    each side from the same weights: {side: {"loss": loss, name:
    gradient}}, on the CPU. The side "twin" runs on the card with every
    kernel call through its plain twin, and launches nothing."""
    import contextlib

    out = {}
    for side in sides:
        twin = side == "twin"
        with _twins() if twin else contextlib.nullcontext():
            reset_launches()
            tr = make(side)
            loss = tr.train_step(*batch_of(tr))[0].float().cpu()
        if twin and any(launch_modes().values()):
            fail(f"the twin's step launched {launch_modes()}")
        out[side] = {"loss": loss, **{k: v.grad.cpu() for k, v in
                                      tr.model.named_parameters()}}
    return out


def _held_fp32(label, runs, bar):
    """Card vs CPU at high or highest: loss within 1e-5 relative, every
    gradient within `bar` of its layer's max|g|."""
    card, cpu = runs["card"], runs["cpu"]
    rel = float(abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]))
    grads = {k: g for k, g in cpu.items() if k != "loss"}
    worst = max(float((card[k] - g).abs().max()) / _layer_scale(grads, k)
                for k, g in grads.items())
    say(f"  card vs cpu train step [{label}]: loss {float(card['loss']):.6f}"
        f" rel {rel:.2e} (bar 1e-5); worst gradient delta {worst:.2e} of "
        f"its layer's max|g| (bar {bar:g}) over {len(grads)} tensors")
    if not (rel <= 1e-5 and worst <= bar):
        fail(f"card and CPU train steps disagree: {label}")


def _held_cancelling(name, runs, scale) -> float:
    """The bf16 step where its features cancel (crecon's x - recon behind
    a trained VAE): the GCN then learns from rounding residue, and two bf16
    computations of the step that round in different orders each sit up
    to the bf16 error from fp32, so they may differ by twice it. The bar:
    the card's run, and the witness (the same step on the card with the
    kernel's twin in its place), each no further from the CPU's fp32 than
    twice the CPU's bf16 is, plus one bf16 ulp of the scale; a second card
    run repeats the first within one ulp. The witness's distance to the
    CPU's bf16 beside the card's says whether the kernel adds to the gap.
    Returns the card's margin to its bar over the scale."""
    card, again, twin, a, b = (runs[k] for k in ("card", "again", "twin",
                                                  "cpu", "cpu32"))
    d = {k: float(abs(u - v).max()) for k, (u, v) in {
        "card": (card, b), "twin": (twin, b), "repeat": (card, again),
        "kernel": (card, twin), "card16": (card, a), "twin16": (twin, a),
        "bf16": (a, b)}.items()}
    bar = 2 * d["bf16"] + TOL_BF16 * scale
    say(f"  {name}: from the CPU's bf16, card {d['card16']:.3e} and twin on "
        f"the card {d['twin16']:.3e}; card - twin {d['kernel']:.3e}; from "
        f"its fp32, card {d['card']:.3e}, twin {d['twin']:.3e}, CPU bf16 "
        f"{d['bf16']:.3e} (bar {bar:.3e}); card again {d['repeat']:.3e} "
        f"(scale {scale:.3e})")
    if not (d["card"] <= bar and d["twin"] <= bar):
        fail(f"{name}: a bf16 card run beyond twice the CPU's bf16 error "
             f"plus one ulp ({d['card']:.3e}, {d['twin']:.3e} > {bar:.3e})")
    if not d["repeat"] <= TOL_BF16 * scale:
        fail(f"{name}: a second card run differs by {d['repeat']:.3e}")
    return (d["card"] - bar) / scale


def _classifier_times(torch, label, trainer, staged, args, card,
                      batch=BATCH):
    """Per-step time of a train epoch of SCAN_STEPS: a first epoch warms
    up and captures, one more counts the launches per replayed step; then
    CUDA events in turns eager, graphed, graphed, eager and the profiler's
    device busy time and idle share. Returns (report, launch_modes(),
    launch_calls()) of the counted epoch."""
    shuffle = torch.Generator(device=trainer.device).manual_seed(9)
    run = lambda: trainer.train_epoch_scanned_async(
        staged, *args, shuffle_generator=shuffle)
    trainer.graphs = True
    run()  # warm-up, capture and replays
    torch.cuda.synchronize()
    reset_launches()
    run()
    torch.cuda.synchronize()
    counts = (launch_modes(), launch_calls())
    times = {}
    for graphs in (False, True, True, False):
        trainer.graphs = graphs
        times.setdefault(graphs, []).append(
            _epoch_ms(torch, run, SCAN_STEPS)[0])
    prof = {}
    for graphs in (False, True):
        trainer.graphs = graphs
        prof[graphs] = _epoch_profile(torch, run, SCAN_STEPS)
    trainer.graphs = True
    report = {"case": label}
    for graphs, name in ((False, "eager"), (True, "graphed")):
        busy = prof[graphs]["busy_ms"]
        report[name] = {"step_ms": times[graphs], "busy_ms": busy,
                        "idle": [1 - busy / m for m in times[graphs]],
                        "meshes_per_s": [batch / m * 1e3
                                         for m in times[graphs]]}
    e, g = report["eager"], report["graphed"]
    say(f"  times [{label}] per step of an epoch of {SCAN_STEPS}, A B B A: "
        f"eager {e['step_ms'][0]:.3f} / {e['step_ms'][1]:.3f} ms, graphed "
        f"{g['step_ms'][0]:.3f} / {g['step_ms'][1]:.3f} ms "
        f"({g['meshes_per_s'][0]:.1f} meshes/sec at B={batch}); device busy "
        f"{e['busy_ms']:.3f} / {g['busy_ms']:.3f} ms, idle share "
        f"{e['idle'][0]:.2f} / {g['idle'][0]:.2f} ({card})")
    return report, counts


# the Laplacian calls' and the joint model's P^T modes, by the steps'
# matmul precision ("default": compute_dtype bfloat16)
CLASSIFIER_MODES = {"high": ("bf16x3", "fp32"), "highest": ("fp32", "fp32"),
                    "default": ("bf16", "bf16")}


def _classifier_paths(torch, dev, hier, tmpl, tmp, card, ops_of, names,
                      bf16=False):
    """Phase 16a, b, the card-vs-CPU steps and d at high, or phase 17c at
    compute_dtype bfloat16 (module docstring). ops_of: operators by side
    ("card", "cpu"; in bf16 also "cpu32", fp32), in the computation
    dtype; names: {(n_pad, n_pad_cols): operand} of the Laplacians and
    {(n_in, n_out): operand} of the P^T. Returns the run()s' launches (the
    joint model's by operand, as counted), every bsr_grouped_spmm
    LAUNCHES_BY_CALL key launched, the time reports and the Laplacian and
    P^T launches per replayed epoch of each timed case."""
    import numpy as np

    from meshvae_tpu_torch.data import MeshDataset, list_meshes
    from meshvae_tpu_torch.models import ChebGCN, GCNConfig, MeshVAE, VAEConfig
    from meshvae_tpu_torch.models.joint import build_joint_model
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train import JointTrainer
    from meshvae_tpu_torch.train import crecon_driver
    from meshvae_tpu_torch.train.checkpoint import (checkpoint_path,
                                                    load_checkpoint)
    from meshvae_tpu_torch.train.crecon_driver import CreconTrainer

    configs = _classifier_configs(tmp, bf16)
    c, j = configs["crecon"], configs["joint"]
    lap, pool = CLASSIFIER_MODES["default" if bf16 else "high"]
    tag = " bf16" if bf16 else ""
    crecon_lap = sum(_table_counts(CRECON_CALLS).values())
    joint_lap = sum(v for (key, _, _), v in
                    _table_counts(JOINT_CALLS).items() if key.startswith("L"))
    pools = [key for table in ("pool_colmajor", "pool_grouped")
             for _, key, _, _ in JOINT_CALLS[table]]
    keys = set()

    # --- (a) crecon through crecon_driver.run(): the main path ----------
    results, secs, steps, launches, _, _ = _run_driver(
        torch, c, dev, run=lambda: crecon_driver.run(
            c, do_train=True, do_test=True, device=dev))
    keys |= set(bsr_spmm.LAUNCHES_BY_CALL)
    say(f"crecon{tag} run(): {secs:.1f}s, {CRECON_FOLDS} folds x "
        f"{CLASSIFIER_EPOCHS} epochs on {TRAIN_MESHES} meshes, frozen VAE "
        f"{os.path.relpath(c['checkpoint_file'], tmp)}")
    _hold_launches(f"crecon{tag} run()", launches, steps, crecon_lap,
                   CRECON_EVAL_LAUNCHES, lap=lap)
    crecon_launches = launches[lap]
    mode = _graphs_logged(c, f"crecon{tag}")
    if len(results) != CRECON_FOLDS or not all(
            np.isfinite(r["test_loss"]) and 0.0 <= r["test_acc"] <= 1.0
            for r in results):
        fail(f"crecon{tag} test results {results}")
    vae = MeshVAE(VAEConfig.from_config(c, coarse_verts=hier.levels[-1]))
    vae.load_state_dict(load_checkpoint(c["checkpoint_file"])["model"])
    gcn_cfg = GCNConfig.from_config(c, coarse_verts=hier.levels[-1])
    for n in range(1, CRECON_FOLDS + 1):
        ChebGCN(gcn_cfg).load_state_dict(load_checkpoint(checkpoint_path(
            c["checkpoint_dir"], n))["model"])
    say(f"  {mode}; test " + "; ".join(
        f"fold {r['fold']} loss {r['test_loss']:.4f} acc {r['test_acc']:.3f}"
        for r in results) + f"; checkpoint_1-{CRECON_FOLDS}.pt reload")

    # --- (b) the joint model through train/driver.run() -----------------
    results, secs, steps, launches, _, by_shape = _run_driver(
        torch, j, dev, vis=True)
    keys |= set(bsr_spmm.LAUNCHES_BY_CALL)
    _hold_launches(f"joint{tag} run()", launches, steps, joint_lap,
                   JOINT_EVAL_LAUNCHES, pool=len(pools), lap=lap,
                   pool_mode=pool)
    by_operand = {}
    for (_, n, m), v in by_shape.items():
        if (n, m) not in names:
            fail(f"joint{tag} run() launched on an unknown operator {(n, m)}")
        by_operand[names[(n, m)]] = by_operand.get(names[(n, m)], 0) + v
    joint_launches = {
        "lap": sum(v for k, v in by_operand.items() if k.startswith("L")),
        "pool": {k: v for k, v in by_operand.items() if k.startswith("P")}}
    if joint_launches["pool"] != dict.fromkeys(pools, steps["train"]):
        fail(f"joint{tag} run(): P^T launches {joint_launches['pool']}, "
             f"expected each once per train step ({steps['train']})")
    say(f"  joint{tag} launches by operator {by_operand}")
    jmode = _graphs_logged(j, f"joint{tag}")
    for fold in range(1, JOINT_FOLDS + 1):
        with open(os.path.join(j["checkpoint_dir"],
                               f"history{fold}.json")) as fp:
            hist = json.load(fp)
        rates = [(h["validation"].get("sup_accuracy"),
                  h["validation"].get("adv_accuracy")) for h in hist]
        if [h["epoch"] for h in hist] != [1, 2] or not all(
                a is not None and b is not None and 0 <= a <= 1
                and 0 <= b <= 1 for a, b in rates):
            fail(f"joint{tag} history{fold}.json lacks the extra scalars: "
                 f"{rates}")
    for r in results:
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"joint{tag} test averages {r}")
    triples = sum(len(os.listdir(path)) for path in (
        os.path.join(j["checkpoint_dir"], f"mesh{fold}", d)
        for fold in range(1, JOINT_FOLDS + 1)
        for d in ("sex_change_S", "sex_change_F")) if os.path.isdir(path))
    if triples != 3 * TRAIN_MESHES:  # -v: each mesh is tested in one fold
        fail(f"joint{tag} run() wrote {triples} .obj files, expected "
             f"{3 * TRAIN_MESHES}")
    say(f"  {jmode}; joint{tag} test: " + "; ".join(
        f"fold {r['fold']} loss {r['loss']:.1f} acc {r['accuracy']:.3f} sup "
        f"{r['sup_accuracy']:.3f} adv {r['adv_accuracy']:.3f} sex change "
        f"{r['sex_change_success_rate']:.3f}" for r in results)
        + f"; history sup/adv accuracy per epoch {rates}")

    # --- card vs CPU: one deterministic train step each ------------------
    index, labels = list_meshes({"root_dir": c["root_dir"]})
    ds = MeshDataset(index, {"root_dir": c["root_dir"], "checkpoint_dir":
                             os.path.join(tmp, f"norm_{lap}")},
                     labels, tmpl.v)
    fixed = _scan_batches(ds, BATCH, seed=16)[0]
    vae_states = {"trained": vae.state_dict(), "seeded": MeshVAE(
        vae.cfg, generator=torch.Generator().manual_seed(77)).state_dict()}
    gcn_state = ChebGCN(gcn_cfg, generator=torch.Generator().manual_seed(
        16)).state_dict()
    joint_state = build_joint_model(
        j, hier.levels[-1], generator=torch.Generator().manual_seed(
            17)).state_dict()

    def trainer(name, side, precision, vae_state="trained"):
        config = dict(c if name == "crecon" else j,
                      matmul_precision=precision)
        if side == "cpu32":
            config.update(compute_dtype="float32",
                          matmul_precision="highest")
        device = "cpu" if side.startswith("cpu") else dev
        operators = ops_of[side if device == "cpu" else "card"]
        if name == "joint":
            m = build_joint_model(config, hier.levels[-1])
            m.load_state_dict(joint_state)
            return JointTrainer(m, operators, config, device=device)
        v = MeshVAE(VAEConfig.from_config(config,
                                          coarse_verts=hier.levels[-1]))
        v.load_state_dict(vae_states[vae_state])
        g = ChebGCN(GCNConfig.from_config(config,
                                          coarse_verts=hier.levels[-1]))
        g.load_state_dict(gcn_state)
        return CreconTrainer(g, v, operators, config, device=device)

    def batch_of(name):
        if name == "crecon":
            return lambda tr: (tr.to_device(fixed),)
        return lambda tr: (tr.to_device(fixed), None,
                           *tr.norm_to_device(ds.mean, ds.std))

    if not bf16:
        for precision, bar in (("high", 1e-3), ("highest", 1e-4)):
            for name in ("crecon", "joint"):
                _held_fp32(f"{name} {precision}", _steps(
                    torch, lambda side: trainer(name, side, precision),
                    batch_of(name), ("card", "cpu")), bar)
    else:
        # phase 8's bar on seeded weights; behind the trained VAE, crecon's
        # features cancel and the bar is the witness's (_held_cancelling)
        for label, name, vae_state, sides in (
                ("crecon, seeded VAE", "crecon", "seeded",
                 ("card", "cpu", "cpu32")),
                ("joint", "joint", "seeded", ("card", "cpu", "cpu32")),
                ("crecon, trained VAE", "crecon", "trained",
                 ("card", "again", "twin", "cpu", "cpu32"))):
            runs = _steps(torch, lambda side: trainer(name, side, "default",
                                                      vae_state),
                          batch_of(name), sides)
            margins = []
            for k, ref in runs["cpu32"].items():
                scale = (float(abs(ref)) if k == "loss" else _layer_scale(
                    {q: g for q, g in runs["cpu32"].items() if q != "loss"},
                    k))
                got = {side: r[k] for side, r in runs.items()}
                margins.append(
                    _held_cancelling(f"{label} {k}", got, scale)
                    if "twin" in runs else
                    _held_bf16(f"{label} {k}", got["card"], got["cpu"],
                               ref, scale))
            say(f"  card vs CPU [{label} bf16]: {len(margins)} quantities "
                f"held, worst margin {max(margins):.3e} of the scale")

    # --- (d) times: graphed and eager train steps ------------------------
    cases = ([("default", BATCH), ("default", CONFIG4_BATCH)] if bf16 else
             [("high", BATCH), ("highest", BATCH)])
    reports, per_replay = [], {}
    for precision, batch in cases:
        host = _scan_batches(ds, batch, seed=16)
        lap_mode, pool_mode = CLASSIFIER_MODES[precision]
        for name, calls, n_lap, n_pool in (
                ("crecon", CRECON_CALLS, crecon_lap, 0),
                ("joint", JOINT_CALLS, joint_lap, len(pools))):
            tr = trainer(name, "card", precision)
            staged = tr.stage_batches(host)
            args = ((None, None, None) if name == "crecon" else
                    (torch.Generator(device=dev).manual_seed(3),
                     *tr.norm_to_device(ds.mean, ds.std)))
            label = (f"{name} bf16 B={batch}" if bf16 else
                     f"{name} {precision}")
            report, (counts, by_call) = _classifier_times(
                torch, label, tr, staged, args, card, batch=batch)
            keys |= {k for k in by_call if not k[0].startswith("pool")}
            want = dict.fromkeys(LAUNCH_KEYS, 0)
            want[lap_mode] += n_lap * SCAN_STEPS
            want[f"pool {pool_mode}"] += n_pool * SCAN_STEPS
            if counts != want:
                fail(f"{label}: launches per replayed epoch {counts}, "
                     f"expected {want}")
            if batch == BATCH and _launch_table(
                    by_call, names, SCAN_STEPS) != _table_counts(calls):
                fail(f"{label}: calls per replayed step "
                     f"{_launch_table(by_call, names, SCAN_STEPS)}, "
                     f"expected {_table_counts(calls)}")
            per_replay[label] = dict.fromkeys(("lap", "pool"), 0)
            for (_, n, m, _, _), v in by_call.items():
                per_replay[label]["lap" if names.get((n, m), "").startswith(
                    "L") else "pool"] += v
            report["launches_per_step"] = {k: v / SCAN_STEPS
                                           for k, v in counts.items() if v}
            reports.append(report)
            del tr, staged
    say("  calls per replayed step at B=16 equal CRECON_CALLS and "
        "JOINT_CALLS; Laplacian and P^T launches per replayed epoch "
        + json.dumps(per_replay))
    return {"crecon": crecon_launches, "joint": joint_launches,
            "keys": keys, "reports": reports, "per_replay": per_replay}


def phase_classifiers(torch, dev, ops, hier, tmpl, tmp, covered, card):
    """Phase 16: crecon and the joint model at config-1 width on the
    block-sparse path at high (module docstring). Returns the launches,
    per-step kernel sums and worst kernel-vs-twin errors of its
    kernel-line entries."""
    say("== phase 16: classifiers (crecon and the joint VAE + GCN at "
        "config-1 width, cheb_method pallas)")
    from meshvae_tpu_torch.models import build_operators

    operands = {"L0": ops.lap[0].bsr, "L1": ops.lap[1].bsr}
    names = {(b.n_pad, b.n_pad_cols): k for k, b in operands.items()}
    names.update({(ops.up[i].n_in, ops.up[i].n_out): f"P{i}T"
                  for i in (0, 1, 2)})
    paths = _classifier_paths(
        torch, dev, hier, tmpl, tmp, card,
        {"card": ops, "cpu": build_operators(hier, "cpu",
                                             cheb_method="pallas")}, names)
    reports = paths["reports"]

    # --- (c) the kernel against its twin at the new (operator, C, kind):
    # after d, whose epochs at highest add the fp32 shapes (the P^T, which
    # pool_transpose runs, are held at their shapes in the timings below)
    gen = torch.Generator(device=dev).manual_seed(16)
    new = sorted(paths["keys"] - covered)
    worst = {"bf16x3": 0.0, "fp32": 0.0}
    say(f"  kernel vs twin at the {len(new)} (mode, operator, C, call kind) "
        f"that phases 16a, b and d launched and phase 3 did not cover:")
    for mode, n, m, cc, kind in new:
        bsr = operands[names[(n, m)]]
        x = torch.randn(bsr.n_pad_cols, cc, device=dev, generator=gen)
        err, _ = _hold(torch, bsr, x, mode, kind,
                       _seeds(torch, bsr, cc, gen, dev), TOL_KERNEL,
                       f"{names[(n, m)]} C={cc} {mode} {kind}")
        worst[mode] = max(worst[mode], err)

    rows = []
    per_step = {}
    say("per-call times at the classifiers' shapes (median of %d):" % RUNS)
    timing_operands = _operands(torch, ops, hier, dev)
    for name, calls in (("crecon", CRECON_CALLS), ("joint", JOINT_CALLS)):
        for part, table in calls.items():
            modes = MODES if part == "lap" else ("fp32",)
            for m, acc in _per_step(torch, table, timing_operands, modes, gen,
                                    dev, rows).items():
                per_step[f"{name}_{part}" + (f"_{m}" if part == "lap"
                                             else "")] = acc
    for key, acc in per_step.items():
        say(f"per step {key}: kernel {acc['ms']:.3f} ms, twin "
            f"{acc['plain_ms']:.3f} ms, torch.sparse {acc['library_ms']:.3f}"
            f" ms, bound {acc['bound_ms']:.3f} ms ({_bound_by(acc)}; "
            + _acc_tail(acc))
    for r in reports:
        mode = "bf16x3" if r["case"].endswith(" high") else "fp32"
        name = r["case"].split()[0]
        k_ms = per_step[f"{name}_lap_{mode}"]["ms"] + sum(
            per_step[f"{name}_{p}"]["ms"] for p in ("pool_colmajor",
                                                    "pool_grouped")
            if f"{name}_{p}" in per_step)
        r["kernel_ms_per_step"] = k_ms
        say(f"  {r['case']}: kernel sum {k_ms:.3f} ms of the graphed step's "
            f"{r['graphed']['step_ms'][0]:.3f} ms "
            f"({k_ms / r['graphed']['step_ms'][0]:.2f})")
    say("classifier_times " + json.dumps(reports))
    return dict(paths, per_step=per_step, worst=worst)


# --- phase 17: the bf16 paths and the joint model through inference -------
CONFIG4_BATCH = 128
CONFIG4_MESHES = 256    # two batches of 128
# BASELINE config 4 per batch at B = 128: the serving step's convs at 8x
# the columns (the encoder's F 3 pads to C 384 only; the 2B decoder)
CONFIG4_CALLS = [("enc L0", "L0", 384, _FWD), ("enc L1", "L1", 2048, _FWD),
                 ("dec L1", "L1", 4096, _FWD), ("dec L0", "L0", 4096, _FWD)]
# an 80k inference batch: the four block-sparse encoder convs at B and the
# four decoder convs at 2B, 9 calls each (K = 10)
INFER80_LAUNCHES = 72


def _settled(logits):
    """Rows of [B, 2] logits whose two values differ by more than two bf16
    ulps of their magnitude: another bf16 order of the same sums keeps
    their argmax."""
    import numpy as np

    lg = np.asarray(logits, np.float64)
    mag = np.maximum(np.abs(lg).max(axis=-1), 1e-30)
    return np.abs(lg[:, 0] - lg[:, 1]) > 2 * 2.0 ** (np.floor(np.log2(mag))
                                                     - 7)


def _engine_runs(torch, cases, batch_cpu, mean, std):
    """InferenceEngine.step of each (side, model, ops, device) on one host
    batch, with the classifier's logits; outputs on the CPU in float32."""
    from meshvae_tpu_torch.infer.driver import InferenceEngine
    from meshvae_tpu_torch.models.vae import dense

    out = {}
    for side, model, ops, device in cases:
        batch = {k: v.to(device) for k, v in batch_cpu.items()}
        m, s = mean.to(device), std.to(device)
        got = InferenceEngine(model, ops).step(batch, m, s)
        with torch.no_grad():
            h = model.encode(batch["x"], ops)
            got["logits"] = dense(model.classifier_layer, h, model.cfg.dtype)
        out[side] = {k: v.float().cpu() for k, v in got.items()}
    return out


def _held_rows(label, runs, keys, worst):
    """Card vs CPU in bf16 on the rows whose prediction is settled (the
    CPU's bf16 logits; the excused rows printed, at most a quarter): pred
    equal there, then phase 8's bar per key over the rows where the CPU's
    bf16 and fp32 predictions agree."""
    import torch

    c, a, b = runs["card"], runs["cpu16"], runs["cpu32"]
    keep = _settled(a["logits"].numpy())
    same = torch.from_numpy(keep & (a["pred"] == b["pred"]).numpy())
    keep = torch.from_numpy(keep)
    say(f"  {label}: {int((~keep).sum())} of {len(keep)} rows excused "
        f"(CPU bf16 logits within two ulps), {int(same.sum())} held")
    if (~keep).sum() > len(keep) // 4:
        fail(f"{label}: more than a quarter of the rows are excused")
    if not bool((c["pred"][keep] == a["pred"][keep]).all()):
        fail(f"{label}: pred differs between the card and the CPU")
    for k in keys:
        worst.append(_held_bf16(f"{label} {k}", c[k][same], a[k][same],
                                b[k][same],
                                float(b[k][same].abs().max())))


def _bf16_sums(torch, tables, operands, dev, rows):
    """Per-step sums of the bf16 kernel, twin, torch.sparse and bounds over
    call tables {name: [(label, operand, C, kinds)]}."""
    gen = torch.Generator(device=dev).manual_seed(17)
    sums = {}
    for name, calls in tables.items():
        acc = dict.fromkeys(ACC_KEYS, 0.0)
        say(f" {name}:")
        for label, key, c, kinds in calls:
            if isinstance(operands[key], PoolT):
                _pool_calls(torch, acc, operands[key], label, c, kinds, gen,
                            dev, rows)
                continue
            bsr, csr = operands[key]
            for kind, count in kinds.items():
                got = _time_kind_bf16(torch, bsr, csr, c, kind, gen, dev)
                for k in ACC_KEYS:
                    acc[k] += count * got[k]
                rows.append(dict(got["row"], shape=label, step=name,
                                 per_step=count))
        sums[name] = acc
        say(f"per step {name}: kernel {acc['ms']:.3f} ms, twin "
            f"{acc['plain_ms']:.3f} ms, torch.sparse {acc['library_ms']:.3f}"
            f" ms, bound {acc['bound_ms']:.3f} ms ({_bound_by(acc)}; "
            + _acc_tail(acc))
    return sums


def _infer_cli(torch, argv):
    """python -m meshvae_tpu_torch.infer's main(argv), quiet; returns (CLI
    seconds, run_inference's, the device pass's)."""
    import contextlib
    import io

    from meshvae_tpu_torch.infer import driver as infer_driver
    from meshvae_tpu_torch.infer.__main__ import main as infer_main

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

    infer_driver.run_inference = timer("run", real["run"])
    infer_driver.InferenceEngine.run_dataset = timer("device", real["device"])
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            rc = infer_main(argv)
            secs = time.perf_counter() - t0
    finally:
        infer_driver.run_inference = real["run"]
        infer_driver.InferenceEngine.run_dataset = real["device"]
    if rc != 0:
        fail(f"python -m meshvae_tpu_torch.infer {' '.join(argv)}: rc {rc}")
    return secs, timed["run"], timed["device"]


def _infer_outputs(out, names=None):
    """(pred.json, inference.json, {.obj name: vertices}) of a run, the
    meshes only for `names` (all when None)."""
    from meshvae_tpu_torch.mesh import load_obj

    with open(os.path.join(out, "pred.json")) as fp:
        pred = json.load(fp)
    with open(os.path.join(out, "inference.json")) as fp:
        inf = json.load(fp)
    mdir = os.path.join(out, "sex_change")
    objs = {}
    if os.path.isdir(mdir):
        stems = None if names is None else {n.split(".")[0] for n in names}
        objs = {f: load_obj(os.path.join(mdir, f)).v
                for f in sorted(os.listdir(mdir))
                if stems is None or f.split(".")[0].replace("_recon", "")
                .replace("_gt", "") in stems}
    return pred, inf, objs


def _infer_cfg(path, config, extra=()):
    """A config file of config_1's model keys (and `extra` keys) for the
    inference CLI."""
    with open(path, "w") as fp:
        fp.write("[All]\n")
        for k in ("template", "hierarchy_cache_dir", "downsampling_factors",
                  "num_conv_filters", "polygon_order", "num_hidden",
                  "num_style", "batch_size", "cheb_method", "checkpoint_dir",
                  *extra):
            v = config[k]
            fp.write(f"{k} = "
                     f"{', '.join(map(str, v)) if isinstance(v, list) else v}"
                     "\n")


def _p17_serve(torch, dev, ctx):
    """17a: a bf16 MeshServer answering phase 4's three request lines (the
    main path), card vs CPU on one step, the serving step's time."""
    import io

    import numpy as np

    from meshvae_tpu_torch.infer.serve import MeshServer
    from meshvae_tpu_torch.ops import bsr_spmm

    say("-- 17a: bf16 serving (config 1, B=16)")
    many = [os.path.join(ctx["many_dir"], f)
            for f in os.listdir(ctx["many_dir"])]
    server = MeshServer(ctx["model16"], ctx["ops16"], *ctx["norm"],
                        template=ctx["tmpl"].v, faces=ctx["tmpl"].f,
                        batch_size=BATCH,
                        output_path=os.path.join(ctx["tmp"], "out_bf16"),
                        save_meshes=True, device=dev)
    try:
        say(f"warmup[bf16] {server.warmup():.2f}s")
        request = (f"{ctx['single']}\n{ctx['many_dir']}\n"
                   f"{os.path.join(ctx['tmp'], 'missing.obj')}\n")
        torch.cuda.synchronize()
        # --- the main path: counts reset just before, read just after ----
        reset_launches()
        fout = io.StringIO()
        server.serve_forever(io.StringIO(request), fout)
        launches = bsr_spmm.launches()
        by_call = dict(bsr_spmm.LAUNCHES_BY_CALL)
        # -----------------------------------------------------------------
        lines = [json.loads(l) for l in fout.getvalue().splitlines()]
        _check_lines(lines, ctx["single"], many)
        say(f"serve[bf16]: {len(lines)} lines; request seconds "
            f"{[l['sec'] for l in lines if 'done' in l]}; first answer "
            f"{lines[0]}")
        want = {m: 3 * LAUNCHES_PER_STEP if m == "bf16" else 0
                for m in bsr_spmm.MODES}
        say(f"main-path launches {launches} (expected {want}: "
            f"{LAUNCHES_PER_STEP} bf16 per serving step)")
        if launches != want:
            fail(f"bf16 serving launched {launches}, expected {want}")
        table = _launch_table(by_call, ctx["names"], 3)
        if table != _table_counts({"lap": SERVE_CALLS}):
            fail(f"bf16 serving: calls per step {table}")

        host = server.preprocess(sorted(many)[:BATCH])
        batch = {"x": torch.from_numpy(host["x"].astype(np.float32)),
                 **{k: torch.from_numpy(host[k])
                    for k in ("r", "s", "m", "original")}}
        mean, std = (torch.from_numpy(server.mean),
                     torch.from_numpy(server.std))
        runs = _engine_runs(torch, [
            ("card", ctx["model16"], ctx["ops16"], dev),
            ("cpu16", ctx["cpu16"], ctx["ops16_cpu"], "cpu"),
            ("cpu32", ctx["cpu32"], ctx["ops32_cpu"], "cpu")],
            batch, mean, std)
        if not all(bool(torch.isfinite(v).all())
                   for v in runs["card"].values()):
            fail("non-finite bf16 serving outputs on the card")
        _held_rows("serve step", runs, ("recon_orig", "oppo_orig",
                                        "err_mean", "err_max"),
                   ctx["worst_held"])

        dev_batch = {"x": torch.from_numpy(host["x"]).to(dev),
                     **{k: torch.from_numpy(host[k]).to(dev)
                        for k in ("r", "s", "m")}}
        ms = time_ms(torch, lambda: server.serve_step(dev_batch),
                     runs=2 * RUNS, backlog=False)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        server.serve_step(dev_batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        say(f"serving step [bf16]: {ms:.3f} ms, {BATCH / ms * 1e3:.1f} "
            f"meshes/sec at B={BATCH} as served; peak memory "
            f"{peak / 2**20:.1f} MiB, of which the step's own "
            f"{(peak - base) / 2**20:.1f} MiB ({ctx['card']})")
        busy = _profile(torch, lambda: server.serve_step(dev_batch),
                        "serve bf16", ms)
    finally:
        server.close()
    return {"launches": launches, "keys": set(by_call), "ms": ms,
            "busy": busy}


def _p17_config4(torch, dev, ctx):
    """17b: BASELINE config 4 (bf16, B=128) through the inference CLI on
    256 meshes, one batch card vs CPU, meshes/sec with and without the
    triples; then a scaled80k bf16 inference run on phase 7's checkpoint."""
    import numpy as np

    from meshvae_tpu_torch.data import (MeshDataset, generate_synthetic_dataset,
                                        list_meshes)
    from meshvae_tpu_torch.models.vae import dense
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train.checkpoint import save_checkpoint

    say(f"-- 17b: BASELINE config 4 (python -m meshvae_tpu_torch.infer, bf16,"
        f" B={CONFIG4_BATCH}, {CONFIG4_MESHES} synthetic meshes)")
    tmp = ctx["tmp"]
    root = os.path.join(tmp, "config4")
    data_dir = os.path.join(root, "data")
    t0 = time.perf_counter()
    generate_synthetic_dataset(ctx["tmpl"], data_dir,
                               n_samples=CONFIG4_MESHES, seed=17)
    say(f"{CONFIG4_MESHES} synthetic meshes in "
        f"{time.perf_counter() - t0:.1f}s")
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    save_checkpoint(os.path.join(ckpt, "checkpoint_1.pt"), ctx["weights"],
                    {"state": {}, "param_groups": []}, 1, 0.0, 0.0)
    np.savez(os.path.join(ckpt, "norm.npz"), mean=ctx["norm"][0],
             std=ctx["norm"][1])
    cfg_path = os.path.join(root, "infer.cfg")
    _infer_cfg(cfg_path, dict(config_1(tmp), checkpoint_dir=ckpt))
    # one batch for the CPU: the first 128 names, as the loader batches them
    names = sorted(f for f in os.listdir(data_dir) if f.endswith(".obj"))
    one_dir = os.path.join(root, "one_batch")
    os.makedirs(one_dir)
    for f in names[:CONFIG4_BATCH]:
        os.symlink(os.path.join(data_dir, f), os.path.join(one_dir, f))
    bf16 = ["-p", "compute_dtype", "bfloat16", "-p", "batch_size",
            str(CONFIG4_BATCH)]

    def argv(data, out, device, *flags):
        return ["-c", cfg_path, "-d", data, "-o", os.path.join(root, out),
                "-n", "1", "--device", device, *flags]

    torch.cuda.synchronize()
    # --- the main path: counts reset just before, read just after --------
    reset_launches()
    secs, run_secs, dev_secs = _infer_cli(torch, argv(data_dir, "card", "cuda",
                                                      *bf16))
    launches = bsr_spmm.launches()
    by_call = dict(bsr_spmm.LAUNCHES_BY_CALL)
    # ---------------------------------------------------------------------
    batches = CONFIG4_MESHES // CONFIG4_BATCH
    want = {m: LAUNCHES_PER_STEP * batches if m == "bf16" else 0
            for m in bsr_spmm.MODES}
    say(f"config 4 [card]: {secs:.2f}s CLI, {run_secs:.2f}s run_inference "
        f"({CONFIG4_MESHES / run_secs:.1f} meshes/sec with the .obj "
        f"triples), device pass {dev_secs:.3f}s; launches {launches} "
        f"(expected {want})")
    if launches != want:
        fail(f"config 4 launched {launches}, expected {want}")
    table = _launch_table(by_call, ctx["names"], batches)
    if table != _table_counts({"lap": CONFIG4_CALLS}):
        fail(f"config 4: calls per batch {table}")
    pred, inf, objs = _infer_outputs(os.path.join(root, "card"),
                                     names[:CONFIG4_BATCH])
    if len(pred) != CONFIG4_MESHES or not all(
            np.isfinite(v["reconstruction_error"]["max"])
            for v in inf.values()):
        fail(f"config 4: {len(pred)} answers, or non-finite errors")

    # one batch on the CPU, bf16 and the fp32 yardstick
    _infer_cli(torch, argv(one_dir, "cpu16", "cpu", *bf16))
    _infer_cli(torch, argv(one_dir, "cpu32", "cpu", "-p", "batch_size",
                           str(CONFIG4_BATCH), "-p", "matmul_precision",
                           "highest"))
    outs = {"card": (pred, inf, objs)}
    for side in ("cpu16", "cpu32"):
        outs[side] = _infer_outputs(os.path.join(root, side))
    dcfg = {"root_dir": one_dir, "checkpoint_dir": ckpt}
    index, labels = list_meshes(dcfg)
    ds = MeshDataset(index, dcfg, labels, ctx["tmpl"].v, dtype="test")
    with torch.no_grad():
        h = ctx["cpu16"].encode(torch.from_numpy(ds.x), ctx["ops16_cpu"])
        logits = dense(ctx["cpu16"].classifier_layer, h, torch.bfloat16)
    stems = [f.split("/").pop() for f in ds.filenames]
    runs = {}
    for side, (p, i, o) in outs.items():
        by_stem = {k.split("/").pop(): v for k, v in p.items()}
        runs[side] = {
            "pred": torch.tensor([int(by_stem[s]) for s in stems]),
            "logits": logits.float(),
            "err_mean": torch.tensor([i[s]["reconstruction_error"]["mean"]
                                      for s in stems]),
            "err_max": torch.tensor([i[s]["reconstruction_error"]["max"]
                                     for s in stems]),
            "recon_orig": torch.from_numpy(np.stack([
                o[s.split(".")[0] + "_recon.obj"] for s in stems])),
            "oppo_orig": torch.from_numpy(np.stack([
                o[s.split(".")[0] + ".obj"] for s in stems]))}
    _held_rows("config-4 batch", runs, ("recon_orig", "oppo_orig",
                                        "err_mean", "err_max"),
               ctx["worst_held"])

    secs_nm, run_nm, dev_nm = _infer_cli(torch, argv(
        data_dir, "card_nomesh", "cuda", *bf16, "--no-meshes"))
    say(f"config 4 [card, --no-meshes]: {CONFIG4_MESHES / run_nm:.1f} "
        f"meshes/sec through run_inference ({run_nm:.3f}s); "
        f"{CONFIG4_MESHES / dev_nm:.1f} through the device pass alone "
        f"({dev_nm:.4f}s, {batches} steps); with the triples "
        f"{CONFIG4_MESHES / run_secs:.1f} ({run_secs:.3f}s); "
        f"{CONFIG4_MESHES / secs_nm:.1f} through the whole CLI ({ctx['card']})")

    # scaled80k bf16 batch inference on phase 7's fold-1 checkpoint
    s80 = ctx["s80"]
    data80 = os.path.join(tmp, "data80k")
    argv80 = ["-c", os.path.join(ROOT, SCALED_CFG), "-d", data80, "-o",
              os.path.join(root, "out80"), "-n", "1", "--device", "cuda",
              "--no-meshes", "-p", "template", s80["path"], "-p",
              "hierarchy_cache_dir", os.path.join(tmp, "cache80"), "-p",
              "checkpoint_dir", os.path.join(tmp, "ckpt80k")]
    torch.cuda.synchronize()
    # --- the main path: counts reset just before, read just after --------
    reset_launches()
    secs80, run80, dev80 = _infer_cli(torch, argv80)
    launches80 = bsr_spmm.launches()
    by_call80 = dict(bsr_spmm.LAUNCHES_BY_CALL)
    # ---------------------------------------------------------------------
    batches80 = -(-SCALED_MESHES // SCALED_BATCH)
    want80 = {m: INFER80_LAUNCHES * batches80 if m == "bf16" else 0
              for m in bsr_spmm.MODES}
    pred80, inf80, _ = _infer_outputs(os.path.join(root, "out80"))
    say(f"scaled80k bf16 inference (B={SCALED_BATCH}, {SCALED_MESHES} "
        f"meshes, --no-meshes): {secs80:.2f}s CLI, "
        f"{SCALED_MESHES / run80:.1f} meshes/sec through run_inference, "
        f"{SCALED_MESHES / dev80:.1f} through the device pass; launches "
        f"{launches80} (expected {want80}: {INFER80_LAUNCHES} per batch)")
    if launches80 != want80:
        fail(f"scaled80k inference launched {launches80}, expected {want80}")
    if len(pred80) != SCALED_MESHES or not all(
            np.isfinite(v["reconstruction_error"]["mean"])
            for v in inf80.values()):
        fail("scaled80k inference: missing answers or non-finite errors")
    return {"launches": launches, "launches80": launches80,
            "keys": set(by_call) | set(by_call80)}


def _p17_classifiers(torch, dev, ctx):
    """17c: phase 16's classifier paths at compute_dtype bfloat16, timed
    at B=16 and B=128."""
    say("-- 17c: crecon and the joint model in bf16 (config-1 width, B=16)")
    out = _classifier_paths(
        torch, dev, ctx["hier"], ctx["tmpl"], ctx["tmp"], ctx["card"],
        {"card": ctx["ops16"], "cpu": ctx["ops16_cpu"],
         "cpu32": ctx["ops32_cpu"]}, ctx["names"], bf16=True)
    say("classifier_times_bf16 " + json.dumps(out["reports"]))
    return out


def _p17_joint_infer(torch, dev, ctx):
    """17d: phase 16b's joint checkpoint through the inference CLI and a
    MeshServer at high, card vs CPU at phase 12's fp32 bars."""
    import io

    import numpy as np

    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.data import MeshDataset, list_meshes
    from meshvae_tpu_torch.infer.serve import MeshServer
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train.checkpoint import load_checkpoint
    from meshvae_tpu_torch.train.driver import build_model_and_ops

    say("-- 17d: the joint model through batch inference and serving (phase "
        "16b's checkpoint, high)")
    tmp = ctx["tmp"]
    root = os.path.join(tmp, "joint_infer")
    os.makedirs(root)
    data_dir = os.path.join(tmp, "infer", "data")   # phase 12's meshes
    ckpt = os.path.join(tmp, "ckpt_joint")
    joint = read_config(os.path.join(ROOT, "files", "joint.cfg"))
    config = dict(config_1(tmp), checkpoint_dir=ckpt, type="joint_VAE",
                  latent_split=joint["latent_split"])
    cfg_path = os.path.join(root, "infer.cfg")
    _infer_cfg(cfg_path, config, ("type", "latent_split",
                                  "matmul_precision"))
    argv = lambda out, device: ["-c", cfg_path, "-d", data_dir, "-o",
                                os.path.join(root, out), "-n", "1",
                                "--device", device]
    torch.cuda.synchronize()
    # --- the main path: counts reset just before, read just after --------
    reset_launches()
    secs, _, _ = _infer_cli(torch, argv("card", "cuda"))
    launches = bsr_spmm.launches()
    keys = set(bsr_spmm.LAUNCHES_BY_CALL)
    # ---------------------------------------------------------------------
    batches = -(-INFER_MESHES // BATCH)
    want = {m: LAUNCHES_PER_STEP * batches if m == "bf16x3" else 0
            for m in bsr_spmm.MODES}
    if launches != want:
        fail(f"joint inference launched {launches}, expected {want}")
    cpu_secs, _, _ = _infer_cli(torch, argv("cpu", "cpu"))
    (pred, inf, objs), (pred_c, inf_c, objs_c) = (
        _infer_outputs(os.path.join(root, "card")),
        _infer_outputs(os.path.join(root, "cpu")))
    dcfg = {"root_dir": data_dir, "checkpoint_dir": ckpt}
    index, labels = list_meshes(dcfg)
    scale = float(np.abs(MeshDataset(index, dcfg, labels, ctx["tmpl"].v,
                                     dtype="test").original).max())
    bar = TOL_STEP * scale
    if len(pred) != INFER_MESHES or pred != pred_c:
        fail("joint inference: pred.json differs between card and CPU")
    err = max(abs(inf[n]["reconstruction_error"][k]
                  - inf_c[n]["reconstruction_error"][k])
              for n in inf for k in ("mean", "max"))
    if list(objs) != list(objs_c) or len(objs) != 3 * INFER_MESHES:
        fail("joint inference: the sex_change/ triples differ")
    mesh_err = max(float(np.abs(objs[f] - objs_c[f]).max()) for f in objs)
    say(f"joint inference: card {secs:.2f}s, CPU {cpu_secs:.2f}s; pred "
        f"equal; errors within {err:.3e}, .obj within {mesh_err:.3e} (bar "
        f"{bar:.3e}); launches {launches}, {LAUNCHES_PER_STEP} per batch")
    if not (err <= bar and mesh_err <= bar):
        fail("joint inference: card vs CPU beyond 1e-4 of the mesh scale")

    with np.load(os.path.join(ckpt, "norm.npz")) as z:
        norm = (z["mean"].astype(np.float32), z["std"].astype(np.float32))
    state = load_checkpoint(os.path.join(ckpt, "checkpoint_1.pt"))["model"]
    answers = {}
    for device in (dev, "cpu"):
        model, ops, _, template = build_model_and_ops(config, device)
        model.load_state_dict(state)
        server = MeshServer(model, ops, *norm, template=template.v,
                            faces=template.f, batch_size=BATCH,
                            wire_dtype=np.float32, device=device)
        fout = io.StringIO()
        try:
            server.serve_forever(io.StringIO(data_dir + "\n"), fout)
        finally:
            server.close()
        lines = [json.loads(l) for l in fout.getvalue().splitlines()]
        if lines[-1].get("done") != INFER_MESHES:
            fail(f"joint MeshServer answered {lines[-1]}")
        answers[str(device)] = {l["file"]: l for l in lines[:-1]}
    card_ans, cpu_ans = answers[str(dev)], answers["cpu"]
    worst = max(abs(card_ans[n]["reconstruction_error"][k]
                    - cpu_ans[n]["reconstruction_error"][k])
                for n in cpu_ans for k in ("mean", "max"))
    if sorted(card_ans) != sorted(cpu_ans) or any(
            card_ans[n]["sex"] != cpu_ans[n]["sex"] for n in cpu_ans) or (
            not worst <= bar):
        fail(f"joint MeshServer: card and CPU answers differ (errors "
             f"{worst:.3e}, bar {bar:.3e})")
    say(f"joint MeshServer: {INFER_MESHES} answers, sex equal, errors "
        f"within {worst:.3e} of the CPU's (bar {bar:.3e})")
    return {"launches": launches, "keys": keys}


def bf16_models(torch, dev, models, hier) -> dict:
    """Phase 4's seeded weights at compute_dtype bfloat16 on the card
    (model16, ops16) and on the CPU (cpu16, ops16_cpu), and at fp32
    highest on the CPU (cpu32, ops32_cpu), the yardstick of phase 8's
    bar."""
    from meshvae_tpu_torch.models import MeshVAE, build_operators

    bf = torch.bfloat16
    cfg16 = dataclasses.replace(models["high"].cfg, compute_dtype="bfloat16",
                                precision="default")
    cfg32 = dataclasses.replace(cfg16, compute_dtype="float32",
                                precision="highest")
    weights = {k: v.cpu() for k, v in models["high"].state_dict().items()}

    def model(cfg, device):
        m = MeshVAE(cfg)
        m.load_state_dict(weights)
        return m.to(device).eval()

    return dict(
        weights=weights, model16=model(cfg16, dev),
        cpu16=model(cfg16, "cpu"), cpu32=model(cfg32, "cpu"),
        ops16=build_operators(hier, dev, cheb_method="pallas", dtype=bf),
        ops16_cpu=build_operators(hier, "cpu", cheb_method="pallas",
                                  dtype=bf),
        ops32_cpu=build_operators(hier, "cpu", cheb_method="pallas"))


def phase_bf16_paths(torch, dev, models, ops, hier, tmpl, single, many_dir,
                     norm, s80, tmp, covered, card):
    """Phase 17 (module docstring): bf16 serving, BASELINE config 4 and a
    scaled80k inference run, crecon and the joint model in bf16, the joint
    model through inference; then the kernel against its twin at every new
    call and the per-step sums of the bf16 kernel. Returns what the
    kernel line needs."""
    say("== phase 17: bf16 serving and batch inference (config 4), the "
        "bf16 classifiers, the joint model through inference")
    bf = torch.bfloat16
    ctx = dict(tmp=tmp, hier=hier, tmpl=tmpl, single=single,
               many_dir=many_dir, norm=norm, s80=s80, card=card,
               worst_held=[], **bf16_models(torch, dev, models, hier))
    ops16 = ctx["ops16"]
    operands16 = {"L0": ops16.lap[0].bsr, "L1": ops16.lap[1].bsr,
                  **{f"P{i}T": ops16.up[i].t_bsr for i in (0, 1, 2)}}
    ctx["names"] = {(b.n_pad, b.n_pad_cols): k for k, b in operands16.items()}
    ctx["names"].update({(ops16.up[i].n_in, ops16.up[i].n_out): f"P{i}T"
                         for i in (0, 1, 2)})
    seconds = {}
    out = {}
    for part, fn in (("a", _p17_serve), ("b", _p17_config4),
                     ("c", _p17_classifiers), ("d", _p17_joint_infer)):
        t0 = time.perf_counter()
        out[part] = fn(torch, dev, ctx)
        seconds[part] = round(time.perf_counter() - t0, 1)
    say(f"card vs CPU in bf16 (phase 8's bar) on {len(ctx['worst_held'])} "
        f"inference quantities; worst margin "
        f"{max(ctx['worst_held'], default=0.0):.3e}")

    # --- e. the kernel against its twin at every new call ------------------
    t0 = time.perf_counter()
    by_shape = {"bf16": {(b.n_pad, b.n_pad_cols): b
                         for b in list(operands16.values())
                         + list(_operands80(s80["ops"]).values())},
                "fp32": {(b.n_pad, b.n_pad_cols): b for b in (
                    ops.lap[0].bsr, ops.lap[1].bsr,
                    *(ops.up[i].t_bsr for i in (0, 1, 2)))}}
    launched = set().union(*(o["keys"] for o in out.values()))
    new = sorted(launched - covered)
    gen = torch.Generator(device=dev).manual_seed(171)
    worst = {"lap": 0.0, "pool": 0.0, "fp32": 0.0}
    say(f"-- 17e: kernel vs twin at the {len(new)} (mode, operator, C, call "
        f"kind) that phase 17 launched and phases 3 and 16 did not:")
    for mode, n, m, c, kind in new:
        bsr = by_shape["bf16" if mode == "bf16" else "fp32"][(n, m)]
        dtype = bf if mode == "bf16" else torch.float32
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen).to(dtype)
        err, _ = _hold(torch, bsr, x, mode, kind,
                       _seeds(torch, bsr, c, gen, dev, dtype),
                       TOL_BF16 if mode == "bf16" else TOL_KERNEL,
                       f"{(n, m)} C={c} {mode} {kind}")
        group = ("fp32" if mode != "bf16" else
                 "pool" if bsr.n_pad != bsr.n_pad_cols else "lap")
        worst[group] = max(worst[group], err)
    rows = []
    csrs = _with_bf16(torch, {k: op[1] for k, op in _operands(
        torch, ops, hier, dev).items() if k in ("L0", "L1")}, dev)
    operands = {k: (operands16[k], csrs[k]) for k in ("L0", "L1")}
    operands.update({f"P{i}T": PoolT(ops16.up[i], POOL_F[i])
                     for i in (0, 1, 2)})
    say("per-call bf16 times at phase 17's shapes (median of %d):" % RUNS)
    sums = _bf16_sums(torch, {
        "serve_bf16": SERVE_CALLS, "config4_batch": CONFIG4_CALLS,
        "crecon_bf16_lap": CRECON_CALLS["lap"],
        "joint_bf16_lap": JOINT_CALLS["lap"],
        "joint_bf16_pool_colmajor": JOINT_CALLS["pool_colmajor"],
        "joint_bf16_pool_grouped": JOINT_CALLS["pool_grouped"]},
        operands, dev, rows)
    say("shape_rows_bf16 " + json.dumps(rows))
    seconds["e"] = round(time.perf_counter() - t0, 1)
    say(f"phase 17 seconds {json.dumps(seconds)}")
    return {"out": out, "sums": sums, "worst": worst, "ctx": ctx}


# --- phase 18: reference migration ------------------------------------------
REF_MESHES = 32          # the inference CLI's synthetic meshes (2 batches)
# 18e's steps at highest, (cheb_method, pool_method); the default pallas +
# gather is timed beside them
REF_METHODS = (("ell", "gather"), ("pallas", "dense"), ("ell", "dense"))
REF_TIMED = REF_METHODS + (("pallas", "gather"),)


def _reference_name(name: str, gcn: bool) -> str:
    """The reference implementation's name of a port parameter: cheb.{i}
    for the encoder's convs (the GCN's cheb_{i}), cheb_dec.{i} for the
    decoder's; the linear heads keep theirs."""
    layer, kind = name.rsplit(".", 1)
    prefixes = ((("cheb_", "cheb"),) if gcn
                else (("cheb_enc_", "cheb"), ("cheb_dec_", "cheb_dec")))
    for prefix, ref in prefixes:
        if layer.startswith(prefix) and layer[len(prefix):].isdigit():
            return f"{ref}.{layer[len(prefix):]}.{kind}"
    return name


def _reference_checkpoint(torch, target: dict, gcn: bool, seed: int,
                          path: str) -> dict:
    """A reference-layout checkpoint {'state_dict': ...} of `target`'s
    shapes from a seeded torch.Generator, saved at `path`: Chebyshev
    weights and biases ~ N(0, 0.1), Linear weights ([out, in], the
    reference's layout) and biases ~ U(+-1/sqrt(in)); with the reference's
    dead dec_lin_1 head and a buffer, which the importer skips."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, value in target.items():
        if name.startswith("cheb"):
            v = 0.1 * torch.randn(value.shape, generator=gen)
        else:
            fan_in = target[name.rsplit(".", 1)[0] + ".weight"].shape[1]
            v = (2 * torch.rand(value.shape, generator=gen) - 1) / math.sqrt(
                fan_in)
        sd[_reference_name(name, gcn)] = v
    sd["dec_lin_1.weight"] = torch.randn(3, 3, generator=gen)
    sd["dec_lin_1.bias"] = torch.randn(3, generator=gen)
    sd["cheb.0.num_batches_tracked"] = torch.tensor(3)
    torch.save({"state_dict": sd, "epoch_num": 7}, path)
    return sd


def _quiet(fn, *args):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = fn(*args)
    return rc, out.getvalue()


def _card_vs_cpu_step(torch, label, make, batch, mean, std, bar):
    """One deterministic train step (no dropout, z = mu) of make(device) on
    the card, the launch counts reset just before and read just after,
    and on the CPU: loss within 1e-5 relative, every gradient within `bar`
    of its layer's max|g|; a second card step from the same weights shows
    the card's own run-to-run spread (printed, not held). Returns
    (launch_modes(), launch_shapes(), bsr_grouped_spmm's LAUNCHES_BY_CALL
    keys, worst)."""
    from meshvae_tpu_torch.ops import bsr_spmm

    out = {}
    for side, device in (("card", "cuda"), ("cpu", "cpu"), ("again", "cuda")):
        tr = make(device)
        dev_batch = tr.to_device(batch)
        norm = tr.norm_to_device(mean, std)
        if side == "card":
            torch.cuda.synchronize()
            reset_launches()
        loss = tr.train_step(dev_batch, None, *norm)[0].item()
        if side == "card":
            torch.cuda.synchronize()
            counts = (launch_modes(), launch_shapes(),
                      set(bsr_spmm.LAUNCHES_BY_CALL))
        out[side] = (loss, {k: v.grad.cpu()
                            for k, v in tr.model.named_parameters()})
    rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grads = out["cpu"][1]

    def deltas(side, other="cpu"):
        """(max |delta| / the layer's max|g|, name), largest first."""
        return sorted(((out[side][1][k] - g).abs().max().item()
                       / _layer_scale(grads, k), k)
                      for k, g in out[other][1].items())[::-1]

    worst = deltas("card")
    say(f"  {label}: loss {out['card'][0]:.6g}, card vs CPU rel "
        f"{rel:.2e} (bar 1e-5); worst gradient deltas of the layer's max|g| "
        f"(bar {bar:g}): "
        + ", ".join(f"{k} {d:.2e}" for d, k in worst[:3])
        + "; a second card step against the first: "
        + ", ".join(f"{k} {d:.2e}" for d, k in deltas("again", "card")[:2])
        + f"; launches {counts[0]}")
    if not (rel <= 1e-5 and worst[0][0] <= bar):
        fail(f"{label}: card and CPU train steps disagree")
    return (*counts, worst[0][0])


def _ref_import(torch, root, cfg_path, hier, gcn_cfg):
    """18c's imports: the reference VAE and GCN checkpoints through
    ``python -m meshvae_tpu_torch.train.torch_import`` on the card.
    Returns (the VAE's params file, its state_dict, the GCN's state)."""
    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.models import ChebGCN, MeshVAE, VAEConfig
    from meshvae_tpu_torch.train import torch_import
    from meshvae_tpu_torch.train.checkpoint import (load_model_state,
                                                    load_params)

    config = read_config(cfg_path)
    vae = MeshVAE(VAEConfig.from_config(config, hier.levels[-1]))
    paths = {}
    for kind, target, gcn in (("cheb_VAE", vae.state_dict(), False),
                              ("cheb_GCN", ChebGCN(gcn_cfg).state_dict(),
                               True)):
        ref = os.path.join(root, f"reference_{kind}.pt")
        sd = _reference_checkpoint(torch, target, gcn, 18 + gcn, ref)
        out = (os.path.join(root, "ckpt", "checkpoint_1.pt")
               if kind == "cheb_VAE" else os.path.join(root, "gcn.pt"))
        t0 = time.perf_counter()
        rc, text = _quiet(torch_import.main,
                          [ref, out, "-c", cfg_path, "--type", kind])
        got = load_params(out)
        bad = [k for k, v in got.items()
               if not torch.equal(v, sd[_reference_name(k, gcn)])]
        say(f"  torch_import --type {kind}: rc {rc} in "
            f"{time.perf_counter() - t0:.2f}s, {len(got)} tensors, "
            f"{'forced hierarchy_mode=reference' if 'reference' in text else 'hierarchy_mode from the config'}"
            f"; mismatched {bad}")
        if rc != 0 or bad or set(got) != set(target) or (
                "hierarchy_mode=reference" not in text):
            fail(f"torch_import {kind}: rc {rc}, mismatched {bad}, "
                 f"output {text!r}")
        paths[kind] = out
    return paths["cheb_VAE"], load_model_state(paths["cheb_VAE"]), \
        load_params(paths["cheb_GCN"])


def _ref_serving(torch, dev, root, cfg_path, data_dir, scale, tmpl,
                 many_dir, config, weights, ops_card, ops_cpu, seen):
    """18c's serving: the inference CLI over REF_MESHES meshes card vs
    --device cpu (phase 12's bars), then a MeshServer at high and at
    highest answering many_dir (20 meshes, two steps), card vs CPU on one
    step (phase 4's bars). Returns the main-path launches; adds their
    LAUNCHES_BY_CALL keys to `seen`."""
    import io

    import numpy as np

    from meshvae_tpu_torch.infer.driver import InferenceEngine
    from meshvae_tpu_torch.infer.serve import MeshServer
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig
    from meshvae_tpu_torch.ops import bsr_spmm

    launches = {}
    outs = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(root, f"infer_{device}")
        torch.cuda.synchronize()
        reset_launches()
        secs, _, _ = _infer_cli(torch, [
            "-c", cfg_path, "-d", data_dir, "-o", out, "-n", "1", "-p",
            "matmul_precision", "high", "--device", device])
        if device == "cuda":
            launches["infer"] = bsr_spmm.launches()
            seen |= set(bsr_spmm.LAUNCHES_BY_CALL)
        outs[device] = _infer_outputs(out)
        say(f"  inference CLI [{device}]: {secs:.2f}s")
    (pred, inf, objs), (pred_c, inf_c, objs_c) = outs["cuda"], outs["cpu"]
    with np.load(os.path.join(root, "ckpt", "norm.npz")) as z:
        mean, std = z["mean"].astype(np.float32), z["std"].astype(np.float32)
    err = max(abs(inf[n]["reconstruction_error"][k]
                  - inf_c[n]["reconstruction_error"][k])
              for n in inf for k in ("mean", "max"))
    mesh_err = max(float(np.abs(objs[f] - objs_c[f]).max()) for f in objs)
    batches = -(-REF_MESHES // BATCH)
    want = {m: (LAUNCHES_PER_STEP * batches if m == "bf16x3" else 0)
            for m in bsr_spmm.MODES}
    say(f"  inference CLI card vs CPU: pred equal {pred == pred_c} "
        f"({len(pred)} meshes), errors within {err:.3e}, .obj within "
        f"{mesh_err:.3e} (bar {TOL_STEP * scale:.3e}); launches "
        f"{launches['infer']} (expected {want})")
    if (len(pred) != REF_MESHES or pred != pred_c
            or len(objs) != 3 * REF_MESHES or list(objs) != list(objs_c)):
        fail("reference inference: card and CPU outputs differ")
    if not (err <= TOL_STEP * scale and mesh_err <= TOL_STEP * scale):
        fail("reference inference: card vs CPU beyond the bar")
    if launches["infer"] != want:
        fail(f"reference inference launched {launches['infer']}")

    many = sorted(os.path.join(many_dir, f) for f in os.listdir(many_dir))
    for p, mode in (("high", "bf16x3"), ("highest", "fp32")):
        cfg = VAEConfig.from_config(dict(config, matmul_precision=p),
                                    ops_card.num_nodes[-1])
        models = {}
        for device in ("cuda", "cpu"):
            m = MeshVAE(cfg)
            m.load_state_dict(weights)
            models[device] = m.to(device).eval()
        server = MeshServer(models["cuda"], ops_card, mean, std,
                            template=tmpl.v, faces=tmpl.f, batch_size=BATCH,
                            output_path=os.path.join(root, f"serve_{p}"),
                            device=dev)
        try:
            server.warmup()
            fout = io.StringIO()
            torch.cuda.synchronize()
            reset_launches()
            server.serve_forever(io.StringIO(f"{many_dir}\n"), fout)
            torch.cuda.synchronize()
            launches[f"serve_{p}"] = bsr_spmm.launches()
            seen |= set(bsr_spmm.LAUNCHES_BY_CALL)
            lines = [json.loads(l) for l in fout.getvalue().splitlines()]
            host = server.preprocess(many[:BATCH])
        finally:
            server.close()
        want = {m: (2 * LAUNCHES_PER_STEP if m == mode else 0)
                for m in bsr_spmm.MODES}
        if [l.get("done") for l in lines if "done" in l] != [20] or \
                launches[f"serve_{p}"] != want:
            fail(f"reference MeshServer[{p}]: {len(lines)} lines, launches "
                 f"{launches[f'serve_{p}']} (expected {want})")
        batch = {"x": torch.from_numpy(host["x"].astype(np.float32)),
                 **{k: torch.from_numpy(host[k])
                    for k in ("r", "s", "m", "original")}}
        got = InferenceEngine(models["cuda"], ops_card).step(
            {k: v.to(dev) for k, v in batch.items()},
            torch.from_numpy(mean).to(dev), torch.from_numpy(std).to(dev))
        ref = InferenceEngine(models["cpu"], ops_cpu).step(
            batch, torch.from_numpy(mean), torch.from_numpy(std))
        bar = TOL_STEP * float(np.abs(host["original"]).max())
        pred_eq = bool((got["pred"].cpu() == ref["pred"]).all())
        d = {k: (got[k].cpu() - ref[k]).abs().max().item()
             for k in ("recon_orig", "err_mean")}
        say(f"  MeshServer[{p}]: {len(lines)} lines, launches "
            f"{launches[f'serve_{p}']} ({LAUNCHES_PER_STEP} per step); card "
            f"vs CPU pred equal {pred_eq}, recon_orig {d['recon_orig']:.3e}, "
            f"err_mean {d['err_mean']:.3e} (bar {bar:.3e})")
        if not (pred_eq and max(d.values()) <= bar):
            fail(f"reference MeshServer[{p}]: card and CPU disagree")
    return launches


def _ref_crecon(torch, config, weights, gcn_state, gcn_cfg, ops_card,
                ops_cpu, batch, seen):
    """18c's crecon eval step: the imported GCN behind the imported VAE on
    the card and on the CPU at high: loss within 1e-5 relative, logits
    within 1e-4 of their max (phase 16's bars); adds the card's
    LAUNCHES_BY_CALL keys to `seen`."""
    from meshvae_tpu_torch.models import ChebGCN, MeshVAE, VAEConfig
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train.crecon_driver import (CreconTrainer,
                                                       estimate_diff)

    vcfg = VAEConfig.from_config(config, ops_card.num_nodes[-1])
    outs = {}
    for device, ops in (("cuda", ops_card), ("cpu", ops_cpu)):
        vae, gcn = MeshVAE(vcfg), ChebGCN(gcn_cfg)
        vae.load_state_dict(weights)
        gcn.load_state_dict(gcn_state)
        tr = CreconTrainer(gcn, vae, ops, config, device=device)
        b = tr.to_device(batch)
        reset_launches()
        scalars = tr.eval_step(b)["scalars"].cpu()
        seen |= set(bsr_spmm.LAUNCHES_BY_CALL)
        with torch.no_grad():
            diff, _, _ = estimate_diff(tr.vae, b["x"], b["label"], ops,
                                       train=False)
            logits = tr.model(diff, ops).cpu()
        outs[device] = (scalars, logits)
    (s_card, l_card), (s_cpu, l_cpu) = outs["cuda"], outs["cpu"]
    rel = abs(s_card[0] - s_cpu[0]).item() / abs(s_cpu[0]).item()
    d = (l_card - l_cpu).abs().max().item() / l_cpu.abs().max().item()
    say(f"  crecon eval step (imported GCN behind the imported VAE, high): "
        f"loss {s_card[0].item():.6g} vs CPU rel {rel:.2e} (bar 1e-5), "
        f"correct {int(s_card[1])} / {int(s_cpu[1])}, logits {d:.2e} of "
        f"max|logit| (bar 1e-4)")
    if not (rel <= 1e-5 and d <= 1e-4):
        fail("reference crecon eval step: card and CPU disagree")


def _ell_memory(torch, dev, label, cfg_file, scaled, dtype, card):
    """18f at one scaled configuration: the formula's bytes
    (validate.ell_step_bytes); where they fit the card, one ELL train step
    at the config's batch with its peak memory beside the formula, and
    the same step on the block-sparse path (phase 7 / 9's operators) for
    the ELL path's extra; both steps' host-paced times."""
    import numpy as np

    from meshvae_tpu_torch import validate
    from meshvae_tpu_torch.config import read_config
    from meshvae_tpu_torch.models import MeshVAE, VAEConfig, build_operators
    from meshvae_tpu_torch.train import Trainer

    config = read_config(os.path.join(ROOT, cfg_file))
    hier = scaled["hier"]
    n, d = validate.level0_shape(hier.adjacency[0])
    b = int(config["batch_size"])
    itemsize = 2 if dtype == torch.bfloat16 else 4
    pred = validate.ell_step_bytes(b, n, d, validate.level0_convs(config),
                                   itemsize)
    total = torch.cuda.get_device_properties(dev).total_memory
    say(f"  {label}: B={b}, N={n}, D={d}, {dtype}; formula: gather "
        f"{pred['gather'] / 2**20:.1f} MiB, transient "
        f"{pred['transient'] / 2**20:.1f}, kept {pred['kept'] / 2**20:.1f}, "
        f"total {pred['total'] / 2**20:.1f} MiB of the card's "
        f"{total / 2**30:.1f} GiB")
    if pred["total"] > total:
        say(f"  {label}: the formula says it does not fit; not run")
        return {"predicted": pred, "measured": None}
    cfg = VAEConfig.from_config(config, hier.levels[-1])
    weights = MeshVAE(cfg, generator=torch.Generator().manual_seed(5)
                      ).state_dict()
    gen = torch.Generator().manual_seed(6)
    batch = {"x": torch.randn(b, n, 3, generator=gen),
             "label": torch.randint(0, 2, (b,), generator=gen),
             "r": torch.eye(3).expand(b, 3, 3).contiguous(),
             "s": torch.ones(b), "m": torch.zeros(b, 1, 3),
             "mask": torch.ones(b)}
    mean = np.zeros((n, 3), np.float32)
    std = np.ones((n, 3), np.float32)
    out = {"predicted": pred}
    for method, ops in (("ell", build_operators(hier, dev, cheb_method="ell",
                                                dtype=dtype)),
                        ("pallas", scaled["ops"])):
        model = MeshVAE(cfg)
        model.load_state_dict(weights)
        tr = Trainer(model, ops, config, device=dev)
        dev_batch, norm = tr.to_device(batch), tr.norm_to_device(mean, std)
        step_gen = torch.Generator(device=dev).manual_seed(7)
        step = lambda: tr.train_step(dev_batch, step_gen, *norm)
        step()  # Adam's state and the autograd buffers exist from here
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_ms(torch, step, runs=10, warmup=1, backlog=False)
        out[method] = {"peak": peak, "ms": ms}
        say(f"  {label} [{method}]: train step {ms:.3f} ms host-paced "
            f"({b / ms * 1e3:.1f} meshes/sec), the step's own peak "
            f"{peak / 2**20:.1f} MiB ({card})")
        if method == "ell":
            _profile(torch, step, f"{label} [ell]", ms, n=3, batch=b)
        del tr, model, ops
    extra = out["ell"]["peak"] - out["pallas"]["peak"]
    say(f"  {label}: ELL peak {out['ell']['peak'] / 2**20:.1f} MiB against "
        f"the formula's {pred['total'] / 2**20:.1f} MiB (ratio "
        f"{out['ell']['peak'] / pred['total']:.2f}); over the block-sparse "
        f"step's {out['pallas']['peak'] / 2**20:.1f} MiB: "
        f"{extra / 2**20:.1f} MiB, against the formula's transient "
        f"{pred['transient'] / 2**20:.1f} MiB")
    out["measured"] = out["ell"]["peak"]
    return out


def phase_reference(torch, dev, tmpl, many_dir, s20, s80, tmp, card):
    """Phase 18 (module docstring): the reference-migration path. Returns
    what the kernel line needs."""
    say("== phase 18: reference migration (hierarchy_mode reference, the "
        "reference-checkpoint importer, cheb_method ell, pool_method dense)")
    import numpy as np

    from meshvae_tpu_torch import validate
    from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                        generate_synthetic_dataset,
                                        list_meshes)
    from meshvae_tpu_torch.mesh import load_or_build_hierarchy
    from meshvae_tpu_torch.models import (GCNConfig, MeshVAE, VAEConfig,
                                          build_operators)
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.train import Trainer

    seconds = {}
    t_phase = t0 = time.perf_counter()
    root = os.path.join(tmp, "reference")
    config = dict(config_1(tmp), hierarchy_mode="reference")
    cache = config["hierarchy_cache_dir"]

    # --- a. the reference hierarchy beside the fast one in the cache ------
    fast = load_or_build_hierarchy(tmpl, [4, 4, 4, 4], cache_dir=cache)
    before = sorted(os.listdir(cache))
    t1 = time.perf_counter()
    hier = load_or_build_hierarchy(tmpl, [4, 4, 4, 4], cache_dir=cache,
                                   mode="reference")
    build_s = time.perf_counter() - t1
    d_diff = [int((a != b).nnz) for a, b in zip(fast.downsample,
                                                hier.downsample)]
    u_rows = [float(np.abs(np.asarray(u.sum(axis=1)).ravel() - 1).max())
              for u in hier.upsample]
    say(f"18a: reference hierarchy {hier.levels} built in {build_s:.2f}s on "
        f"the host beside the cached fast one ({before} -> "
        f"{sorted(os.listdir(cache))}); D differs from fast in {d_diff} "
        f"entries; U rows off 1 by up to {[f'{v:.2e}' for v in u_rows]}")
    if (hier.levels != [4998, 1250, 313, 79, 20] or not any(d_diff)
            or len(os.listdir(cache)) != len(before) + 1):
        fail("18a: the reference hierarchy came back as the fast one, or "
             "at other levels")
    ops = build_operators(hier, dev, cheb_method="pallas")
    ops_cpu = build_operators(hier, "cpu", cheb_method="pallas")
    named = {f"L{i}": op.bsr for i, op in enumerate(ops.lap)
             if op.bsr is not None}
    named.update({f"P{i}T": up.t_bsr for i, up in enumerate(ops.up)
                  if up.t_bsr is not None})
    for name, bsr in named.items():
        say(f"  {name}: n_pad {bsr.n_pad} x {bsr.n_pad_cols}, "
            f"{bsr.num_blocks} blocks, G {bsr.g_width} (fp32 blocks; modes "
            f"fp32 and bf16x3)")
    if sorted(named) != ["L0", "L1", "P0T", "P1T", "P2T"]:
        fail(f"18a: reference operators {sorted(named)}")
    seconds["a"] = time.perf_counter() - t0

    # --- c. imports, inference, serving and crecon on the card ------------
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "ckpt"))
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(tmpl, data_dir, n_samples=REF_MESHES, seed=18)
    dcfg = {"root_dir": data_dir, "checkpoint_dir": os.path.join(root, "ckpt")}
    index, labels = list_meshes(dcfg)
    ds = MeshDataset(index, dcfg, labels, tmpl.v)  # writes ckpt/norm.npz
    import_cfg = os.path.join(root, "import.cfg")
    _infer_cfg(import_cfg, dict(config, checkpoint_dir="ckpt/"))
    infer_cfg = os.path.join(root, "infer.cfg")
    _infer_cfg(infer_cfg, dict(config, checkpoint_dir="ckpt/"),
               extra=("hierarchy_mode",))
    gcn_cfg = GCNConfig.from_config(config, hier.levels[-1], 6)
    seen = set()  # the LAUNCHES_BY_CALL keys of 18c-e's card runs
    say("18c: import, inference and serving of reference weights")
    _, weights, gcn_state = _ref_import(torch, root, import_cfg, hier,
                                        gcn_cfg)
    launches = _ref_serving(torch, dev, root, infer_cfg, data_dir,
                            float(np.abs(ds.original).max()), tmpl,
                            many_dir, config, weights, ops, ops_cpu, seen)
    batch = next(iter(BatchIterator(ds, BATCH)))
    _ref_crecon(torch, config, weights, gcn_state, gcn_cfg, ops, ops_cpu,
                batch, seen)
    seconds["c"] = time.perf_counter() - t0

    # --- d. fine-tuning from the imported weights -------------------------
    t0 = time.perf_counter()
    say("18d: fine-tuning from the imported weights (high)")
    vcfg = VAEConfig.from_config(config, hier.levels[-1])

    def trainer(cfg, operators, device):
        model = MeshVAE(cfg)
        model.load_state_dict(weights)
        return Trainer(model, operators, config, device=device)

    pool_keys = [("pool fp32", up.n_in, up.n_out) for up in ops.up
                 if up.t_ptr is not None]
    d_counts, d_shapes, keys, _ = _card_vs_cpu_step(
        torch, "train step [high]",
        lambda device: trainer(vcfg, ops if device == "cuda" else ops_cpu,
                               device),
        batch, ds.mean, ds.std, 1e-3)
    seen |= keys
    want = {**dict.fromkeys(LAUNCH_KEYS, 0), "bf16x3": TRAIN_LAP_LAUNCHES,
            "pool fp32": len(pool_keys)}
    if d_counts != want or any(d_shapes.get(k) != 1 for k in pool_keys):
        fail(f"18d: launches {d_counts} {d_shapes}, expected {want} and "
             f"each P^T once")
    seconds["d"] = time.perf_counter() - t0

    # --- e. cheb_method ell and pool_method dense at highest --------------
    # on phase 6's seeded weights: with the imported ones (a loss of ~3e4)
    # a decoder activation sits within rounding of a ReLU's kink, where a
    # perturbation of x by 1e-7 of itself moves dec_lin_2.bias's gradient
    # by 5.4e-4 of its layer's max|g| on the CPU alone, in every method
    t0 = time.perf_counter()
    say("18e: cheb_method ell and pool_method dense (highest, phase 6's "
        "seeded weights)")
    seeded = MeshVAE(vcfg, generator=torch.Generator().manual_seed(1234)
                     ).state_dict()

    def seeded_trainer(cfg, operators, device):
        model = MeshVAE(cfg)
        model.load_state_dict(seeded)
        return Trainer(model, operators, config, device=device)

    staged_ds = BatchIterator(ds, BATCH, shuffle=True, seed=0)
    methods = {}
    for cheb_method, pool_method in REF_TIMED:
        label = f"{cheb_method} + {pool_method} pool"
        cfg = dataclasses.replace(vcfg, precision="highest",
                                  pool_method=pool_method)
        op_of = {d: build_operators(hier, d, cheb_method=cheb_method,
                                    pool_method=pool_method)
                 for d in ("cuda", "cpu")}
        rec = {}
        if (cheb_method, pool_method) in REF_METHODS:
            counts, shapes, keys, worst = _card_vs_cpu_step(
                torch, f"train step [{label}]",
                lambda device: seeded_trainer(cfg, op_of[device], device),
                batch, ds.mean, ds.std, 1e-4)
            seen |= keys
            lap = counts["fp32"]
            pool = sum(shapes.get(k, 0) for k in pool_keys)
            want = ((0 if cheb_method == "ell" else TRAIN_LAP_LAUNCHES),
                    (0 if pool_method == "dense" else len(pool_keys)))
            if (lap, pool) != want or counts["bf16x3"] or counts["bf16"]:
                fail(f"18e {label}: {lap} Laplacian and {pool} P^T "
                     f"launches, expected {want}")
            rec.update(launches=counts, lap=lap, pool=pool, worst=worst)
        tr = seeded_trainer(cfg, op_of["cuda"], dev)
        staged = tr.stage_batches(staged_ds)
        steps = staged["mask"].shape[0]
        shuffle = torch.Generator(device=dev).manual_seed(9)
        step_gen = torch.Generator(device=dev).manual_seed(10)
        run = lambda: tr.train_epoch_scanned_async(
            staged, step_gen, ds.mean, ds.std, shuffle_generator=shuffle)
        times = {}
        for graphs in (False, True, True, False):
            tr.graphs = graphs
            run()  # warm-up (and the capture)
            times.setdefault(graphs, []).append(
                _epoch_ms(torch, run, steps, epochs=RUNS)[0])
        tr.graphs = False
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(tr.to_device(batch), step_gen,
                      *tr.norm_to_device(ds.mean, ds.std))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        rec.update(eager_ms=times[False], graphed_ms=times[True], peak=peak)
        say(f"  {label}: per step of a scanned epoch of {steps} (CUDA "
            f"events, median of {RUNS} epochs, eager / graphed in turns A B "
            f"B A): eager "
            f"{times[False][0]:.3f} / {times[False][1]:.3f} ms, graphed "
            f"{times[True][0]:.3f} / {times[True][1]:.3f} ms "
            f"({BATCH / times[True][0] * 1e3:.1f} meshes/sec at B={BATCH}); "
            f"the eager step's own peak {peak / 2**20:.1f} MiB ({card})")
        methods[(cheb_method, pool_method)] = rec
        del tr, staged, op_of
    seconds["e"] = time.perf_counter() - t0

    # --- f. the ELL memory formula against the card ----------------------
    t0 = time.perf_counter()
    say("18f: the ELL path's memory (validate.ell_step_bytes) at scale")
    memory = {
        "scaled20k": _ell_memory(torch, dev, "scaled20k fp32",
                                 SCALED20_CFG, s20, torch.float32, card),
        "scaled80k": _ell_memory(torch, dev, "scaled80k bf16", SCALED_CFG,
                                 s80, torch.bfloat16, card)}
    from meshvae_tpu_torch.config import read_config

    big = dict(read_config(os.path.join(ROOT, SCALED_CFG)),
               cheb_method="ell", compute_dtype="float32", batch_size=2048)
    allocated = torch.cuda.memory_allocated()
    try:
        validate.validate_config(
            big, dev, level0=validate.level0_shape(s80["hier"].adjacency[0]))
    except validate.ConfigError as exc:
        say(f"  refused without running (scaled80k, fp32, B=2048): {exc}")
    else:
        fail("18f: validate_config admitted an ELL config the formula says "
             "cannot fit")
    if torch.cuda.memory_allocated() != allocated:
        fail("18f: the refusal touched device memory")
    seconds["f"] = time.perf_counter() - t0

    # --- b. the kernel against its twin at every call phase 18 launched ---
    t0 = time.perf_counter()
    say("18b: bsr_grouped_spmm vs its twin on the reference operators, at "
        "every (mode, operator, C, call kind) that 18c-e launched")
    calls = sorted(seen)
    by_shape = {(b.n_pad, b.n_pad_cols): b for b in named.values()}
    gen = torch.Generator(device=dev).manual_seed(181)
    worst = {"fp32": 0.0, "bf16x3": 0.0, "pool": 0.0}
    for mode, n, m, c, kind in calls:
        bsr = by_shape[(n, m)]
        x = torch.randn(bsr.n_pad_cols, c, device=dev, generator=gen)
        err, _ = _hold(torch, bsr, x, mode, kind,
                       _seeds(torch, bsr, c, gen, dev), TOL_KERNEL,
                       f"reference {(n, m)} C={c} {mode} {kind}")
        group = "pool" if n != m else mode
        worst[group] = max(worst[group], err)
    say(f"  {len(calls)} calls held; worst abs error {worst}")
    if len(calls) < 10:
        fail(f"18b: only {len(calls)} calls to hold")

    # the per-step sums of the kernel line, on the reference operators
    gen = torch.Generator(device=dev).manual_seed(182)
    operands = _operands(torch, ops, hier, dev)
    rows = []
    say("per-call times on the reference operators (median of %d):" % RUNS)
    sums = {f"serve_{m}": acc for m, acc in _per_step(
        torch, SERVE_CALLS, operands, MODES, gen, dev, rows).items()}
    for name, calls_ in TRAIN_CALLS.items():
        modes = MODES if name == "lap" else ("fp32",)
        for m, acc in _per_step(torch, calls_, operands, modes, gen, dev,
                                rows).items():
            sums[f"train_{name}_{m}" if name == "lap"
                 else f"train_{name}"] = acc
    sums["train_pool"] = {k: sums["train_pool_colmajor"][k]
                          + sums["train_pool_grouped"][k]
                          for k in ACC_KEYS + ("old_ms",)}
    worst["pool"] = max(sums["train_pool_colmajor"]["err_abs"],
                        sums["train_pool_grouped"]["err_abs"])
    say("shape_rows_reference " + json.dumps(rows))
    for name, acc in sums.items():
        say(f"per step {name} (reference operators): kernel {acc['ms']:.3f}"
            f" ms, twin {acc['plain_ms']:.3f} ms, torch.sparse "
            f"{acc['library_ms']:.3f} ms, bound {acc['bound_ms']:.3f} ms "
            f"({_bound_by(acc)}; " + _acc_tail(acc))
    seconds["b"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_phase
    say(f"phase 18 seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    return {"launches": launches, "train": d_counts, "shapes": d_shapes,
            "pool_keys": pool_keys, "methods": methods, "memory": memory,
            "worst": worst, "sums": sums}


# --- phase 19: serving export -----------------------------------------------
KERNEL_NAME = "bsr_grouped_spmm_kernel"  # ops/csrc/bsr_spmm.cu, <MODE, DOT>


def _kernel_launches(torch, fn):
    """One call of fn in a torch.profiler window: (launches, device ms,
    names) of the kernels whose name holds KERNEL_NAME."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count, us, names = 0, 0.0, set()
    for evt in prof.key_averages():
        if (KERNEL_NAME not in evt.key
                or "CUDA" not in str(getattr(evt, "device_type", ""))):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        count += evt.count
        us += dev_us
        names.add(evt.key)
    return count, us / 1e3, names


def _launch_calls(fn):
    """The modes of the kernel launches that fn makes through the
    registered operator's CUDA implementation (bsr_spmm._launch), exactly;
    the eager wrapper's counters do not see them."""
    from meshvae_tpu_torch.ops import bsr_spmm

    real, modes = bsr_spmm._launch, []

    def counted(bsr, x, mode, *args):
        modes.append(mode)
        return real(bsr, x, mode, *args)

    bsr_spmm._launch = counted
    try:
        fn()
    finally:
        bsr_spmm._launch = real
    return modes


def _hold_launches_of(label, modes, mode):
    say(f"  {label}: {len(modes)} launches through the registered "
        f"operator's CUDA implementation, modes {sorted(set(modes))}")
    if len(modes) != LAUNCHES_PER_STEP or set(modes) != {mode}:
        fail(f"{label}: {len(modes)} launches in modes {set(modes)}, "
             f"expected {LAUNCHES_PER_STEP} in {mode} (0 means the lowering "
             "ran the twin or plain torch)")


def profile_artifacts(spec_path: str) -> None:
    """Run in a fresh process by phase 19 (a process whose profiler has
    held no earlier window; phase 19 gives each process one artifact):
    one step of each artifact of the spec in a torch.profiler window, on
    its batch; prints one JSON line of the
    kernel's launches, device ms and names per artifact, and the eager
    wrapper's counts during the step; and the seconds of this cold
    process: importing torch, importing the export module, starting the
    card, loading the first artifact and its first step."""
    t0 = time.perf_counter()
    marks = {}
    import numpy as np
    import torch

    marks["import torch"] = time.perf_counter()
    from meshvae_tpu_torch.device import resolve_device
    from meshvae_tpu_torch.infer import export
    from meshvae_tpu_torch.ops import bsr_spmm

    marks["import infer.export"] = time.perf_counter()
    with open(spec_path) as fp:
        spec = json.load(fp)
    dev = resolve_device("cuda:0")
    with np.load(spec["batch"]) as z:
        args = tuple(torch.from_numpy(z[k]).to(dev) for k in "xrsm")
    torch.cuda.synchronize()
    marks["start the card"] = time.perf_counter()
    out = {}
    for label, path in spec["artifacts"].items():
        step = export.load_serving_step(path, dev)
        marks.setdefault("load_serving_step", time.perf_counter())
        step(*args)
        torch.cuda.synchronize()
        marks.setdefault("first step", time.perf_counter())
        reset_launches()
        count, ms, names = _kernel_launches(torch, lambda: step(*args))
        out[label] = {"launches": count, "ms": ms, "names": sorted(names),
                      "wrapper": bsr_spmm.launches()}
    prev, out["seconds"] = t0, {}
    for name, t in marks.items():
        out["seconds"][name] = round(t - prev, 3)
        prev = t
    print(json.dumps(out), flush=True)


def _hold_profiled(label, got, mode):
    """The profiler window's count of one artifact step: 20 launches of
    the kernel's instantiation for `mode` (its MODE index), none counted
    by the eager wrapper."""
    from meshvae_tpu_torch.ops.bsr_spmm import MODES

    tag = f"<{MODES.index(mode)},"
    say(f"  {label}: {got['launches']} {KERNEL_NAME} launches in one step's "
        f"profiler window, {got['ms']:.3f} ms of device time; the eager "
        f"wrapper's counts {got['wrapper']}; names {got['names']}")
    if got["launches"] != LAUNCHES_PER_STEP:
        fail(f"{label}: {got['launches']} kernel launches in one artifact "
             f"step, expected {LAUNCHES_PER_STEP} (0 means the lowering ran "
             "the twin or plain torch)")
    if not all(tag in name for name in got["names"]):
        fail(f"{label}: kernels {got['names']} are not all mode {mode}")
    if any(got["wrapper"].values()):
        fail(f"{label}: the eager wrapper counted {got['wrapper']} inside "
             "an artifact step")


def _serve_process(args, request, err_path):
    """python -m meshvae_tpu_torch.infer ARGS in a fresh process with
    `request` on stdin: (seconds to its ready line, the ready line, the
    answer lines, seconds to its exit)."""
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "meshvae_tpu_torch.infer", *args],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, text=True)
        try:
            ready, first = None, None
            for line in proc.stdout:
                if line.startswith('{"ready"'):
                    ready, first = time.perf_counter() - t0, json.loads(line)
                    break
            out, _ = proc.communicate(request, timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if proc.returncode != 0 or first is None:
        with open(err_path) as fp:
            fail(f"serve process {args}: rc {proc.returncode}, ready line "
                 f"{first}; stderr: {fp.read()[-3000:]}")
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    return ready, first, lines, time.perf_counter() - t0


def _same_answers(label, got, want, scale):
    """Answer lines of one request stream: files, sex and the error lines
    equal, errors within phase 4's bar; returns the largest error delta."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} answer lines, the warm server {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if ("file" in g) != ("file" in w):
            fail(f"{label}: line {g} against {w}")
        if "file" not in g:
            if g.get("done") != w.get("done") or ("error" in g) != (
                    "error" in w):
                fail(f"{label}: line {g} against {w}")
            continue
        if g["file"] != w["file"] or g["sex"] != w["sex"]:
            fail(f"{label}: {g['file']} sex {g['sex']}, the warm server "
                 f"{w['file']} sex {w['sex']}")
        for k in ("mean", "max"):
            worst = max(worst, abs(g["reconstruction_error"][k]
                                   - w["reconstruction_error"][k]))
    if not worst <= TOL_STEP * scale:
        fail(f"{label}: errors differ by {worst:.3e} > "
             f"{TOL_STEP * scale:.3e}")
    return worst


def _artifact_rows(torch, out):
    """A packed artifact's outputs as InferenceEngine.step's keys, on the
    CPU in float32."""
    packed = out["packed"].float().cpu()
    return {"pred": packed[0].long(), "err_mean": packed[1],
            "err_max": packed[2],
            **{k: out[k].float().cpu() for k in ("recon_orig", "oppo_orig")}}


def _step_memory(torch, fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak / 2**20, (peak - base) / 2**20


def phase_export(torch, dev, models, ops, hier, tmpl, single, many_dir,
                 norm, bf16, tmp, card):
    """Phase 19 (module docstring): the serving export at config 1.
    Returns the launches and kernel sums of the two artifact steps."""
    say("== phase 19: serving export (torch.export artifacts; config 1, "
        "B=16)")
    import contextlib
    import io

    import numpy as np

    from meshvae_tpu_torch.infer import driver as infer_driver
    from meshvae_tpu_torch.infer import export
    from meshvae_tpu_torch.infer.__main__ import main as infer_main
    from meshvae_tpu_torch.infer.driver import InferenceEngine
    from meshvae_tpu_torch.infer.serve import MeshServer, packed_step
    from meshvae_tpu_torch.ops import bsr_spmm
    from meshvae_tpu_torch.ops import cheb as port_cheb
    from meshvae_tpu_torch.train.checkpoint import save_params

    seconds = {}
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "export")
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    save_params(os.path.join(ckpt, "checkpoint_1.pt"),
                models["high"].state_dict())
    np.savez(os.path.join(ckpt, "norm.npz"), mean=norm[0], std=norm[1])
    cfg_path = os.path.join(root, "export.cfg")
    _infer_cfg(cfg_path, dict(config_1(tmp), checkpoint_dir="ckpt/"),
               extra=("matmul_precision",))
    base = ["-c", cfg_path, "-d", root, "-n", "1"]
    arts = {"--export-serve": os.path.join(root, "serve.pt2"),
            "--export": os.path.join(root, "plain.pt2")}

    # --- a. both artifacts through the CLI, lowered for cuda and cpu ------
    say("-- 19a: --export-serve and --export at high, --export-platforms "
        "cuda,cpu")
    timed = {}
    real_export = infer_driver.export_cli

    def export_timed(*args, **kwargs):
        t0 = time.perf_counter()
        rc = real_export(*args, **kwargs)
        timed["export"] = time.perf_counter() - t0
        return rc

    infer_driver.export_cli = export_timed
    try:
        for flag, path in arts.items():
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = infer_main([*base, flag, path, "--export-platforms",
                                 "cuda,cpu"])
            secs = time.perf_counter() - t0
            if rc != 0 or not os.path.exists(path):
                fail(f"{flag}: rc {rc}, {buf.getvalue()[-500:]}")
            header = export.load_serving_step(path, "cpu").header
            say(f"  {flag}: {buf.getvalue().strip()}; CLI {secs:.2f}s, of "
                f"which export and save {timed['export']:.2f}s; "
                f"{os.path.getsize(path) / 1e6:.2f} MB; header {header}")
            if (header["platforms"] != ["cuda", "cpu"]
                    or header["traced_on"] != "cuda"
                    or header["matmul_precision"] != "high"):
                fail(f"{flag}: header {header}")
    finally:
        infer_driver.export_cli = real_export
    seconds["a"] = time.perf_counter() - t_phase

    # --- b. a fresh --serve --artifact process against a --serve one -----
    say("-- 19b: python -m meshvae_tpu_torch.infer --serve --artifact in a "
        "fresh process, beside --serve on the warm hierarchy cache")
    t0 = time.perf_counter()
    many = [os.path.join(many_dir, f) for f in os.listdir(many_dir)]
    request = f"{single}\n{many_dir}\n{os.path.join(tmp, 'missing.obj')}\n"
    warm = MeshServer(models["high"], ops, *norm, template=tmpl.v,
                      faces=tmpl.f, batch_size=BATCH,
                      output_path=os.path.join(root, "out_warm"),
                      save_meshes=False, device=dev)
    try:
        warm.warmup()
        fout = io.StringIO()
        warm.serve_forever(io.StringIO(request), fout)
        warm_lines = [json.loads(l) for l in fout.getvalue().splitlines()]
        _check_lines(warm_lines, single, many)
        scale = float(np.abs(warm.preprocess(sorted(many) + [single])
                             ["original"]).max())
        procs = {}
        for kind, flags in (("artifact", ["--artifact",
                                          arts["--export-serve"]]),
                            ("build", [])):
            procs[kind] = _serve_process(
                [*base, "-o", os.path.join(root, f"out_{kind}"),
                 "--no-meshes", "--serve", *flags], request,
                os.path.join(root, f"{kind}.stderr"))
            ready, first, lines, total = procs[kind]
            _check_lines(lines, single, many)
            delta = _same_answers(f"--serve {kind}", lines, warm_lines, scale)
            say(f"  --serve{' --artifact' if kind == 'artifact' else ''}: "
                f"ready line after {ready:.2f}s ({first}), exit after "
                f"{total:.2f}s; request seconds "
                f"{[l['sec'] for l in lines if 'done' in l]}; answers as the "
                f"warm server's, errors within {delta:.3e} (bar "
                f"{TOL_STEP * scale:.3e})")
        if procs["artifact"][1].get("artifact") != arts["--export-serve"]:
            fail(f"the artifact's ready line {procs['artifact'][1]}")
        say(f"  seconds to the ready line: artifact "
            f"{procs['artifact'][0]:.2f}, build {procs['build'][0]:.2f} "
            f"({procs['build'][0] - procs['artifact'][0]:+.2f}s saved)")
        seconds["b"] = time.perf_counter() - t0

        # --- c. the kernel inside the artifact; its cpu lowering ---------
        say("-- 19c: the kernel inside the artifact, the cpu lowering "
            "against the cuda one, a highest artifact")
        t0 = time.perf_counter()
        step = export.load_serving_step(arts["--export-serve"], dev)
        say(f"  load_serving_step in this process (imports warm): "
            f"{time.perf_counter() - t0:.2f}s")
        host = warm.preprocess(sorted(many)[:BATCH])
        batch = {k: torch.from_numpy(host[k]).to(dev)
                 for k in ("x", "r", "s", "m")}
        args = tuple(batch[k] for k in ("x", "r", "s", "m"))
        step(*args)
        _hold_launches_of("artifact[high]", _launch_calls(
            lambda: step(*args)), "bf16x3")
        out_card = _artifact_rows(torch, step(*args))
        cpu_step = export.load_serving_step(arts["--export-serve"], "cpu")
        out_cpu = _artifact_rows(torch, cpu_step(*(a.cpu() for a in args)))
        pred_eq = bool((out_card["pred"] == out_cpu["pred"]).all())
        d = {k: (out_card[k] - out_cpu[k]).abs().max().item()
             for k in ("recon_orig", "oppo_orig", "err_mean", "err_max")}
        say(f"  cuda vs cpu lowering: pred equal {pred_eq}, max deltas "
            + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
            + f" (bar {TOL_STEP * scale:.3e})")
        if not pred_eq or not all(d[k] <= TOL_STEP * scale
                                  for k in ("recon_orig", "err_mean")):
            fail("the artifact's cuda and cpu lowerings disagree")
        # the same at highest (the kernel's fp32 mode), through the API
        arts["highest"] = os.path.join(root, "serve_highest.pt2")
        export.save_serving_artifact(arts["highest"],
                                     export.export_packed_serving_step(
                                         models["highest"], ops, *norm,
                                         BATCH, hier.levels[0]))
        step32 = export.load_serving_step(arts["highest"], dev)
        step32(*args)
        _hold_launches_of("artifact[highest]", _launch_calls(
            lambda: step32(*args)), "fp32")
        got32 = _artifact_rows(torch, step32(*args))
        want32 = _artifact_rows(torch, packed_step(
            InferenceEngine(models["highest"], ops).step, batch,
            warm.mean_dev, warm.std_dev, True))
        d32 = max((got32[k] - want32[k]).abs().max().item()
                  for k in ("recon_orig", "oppo_orig", "err_mean", "err_max"))
        say(f"  artifact[highest] against the live engine's packed step: "
            f"pred equal {bool((got32['pred'] == want32['pred']).all())}, "
            f"max delta {d32:.3e}")
        if not bool((got32["pred"] == want32["pred"]).all()) or not (
                d32 <= TOL_STEP * scale):
            fail("the highest artifact differs from the live engine")
        seconds["c"] = time.perf_counter() - t0

        # --- d. a bf16 artifact on phase 17a's weights -------------------
        say("-- 19d: a compute_dtype bfloat16 artifact (phase 17a's "
            "weights) against the warm bf16 MeshServer")
        t0 = time.perf_counter()
        n = hier.levels[0]
        t_exp = time.perf_counter()
        data16 = export.export_packed_serving_step(
            bf16["model16"], bf16["ops16"], *norm, BATCH, n,
            platforms=("cuda",))
        t_exp = time.perf_counter() - t_exp
        arts["bf16"] = os.path.join(root, "serve_bf16.pt2")
        export.save_serving_artifact(arts["bf16"], data16)
        step16 = export.load_serving_step(data16, dev)
        step16(*args)
        _hold_launches_of("artifact[bf16]", _launch_calls(
            lambda: step16(*args)), "bf16")
        warm16 = MeshServer(bf16["model16"], bf16["ops16"], *norm,
                            template=tmpl.v, faces=tmpl.f, batch_size=BATCH,
                            output_path=os.path.join(root, "out_bf16"),
                            save_meshes=True, device=dev)
        try:
            art16 = _artifact_rows(torch, step16(*args))
            live16 = _artifact_rows(torch, warm16.serve_step(batch))
        finally:
            warm16.close()
        batch_cpu = {"x": torch.from_numpy(host["x"].astype(np.float32)),
                     **{k: torch.from_numpy(host[k])
                        for k in ("r", "s", "m", "original")}}
        mean, std = torch.from_numpy(norm[0]), torch.from_numpy(norm[1])
        refs = _engine_runs(torch, [
            ("cpu16", bf16["cpu16"], bf16["ops16_cpu"], "cpu"),
            ("cpu32", bf16["cpu32"], bf16["ops32_cpu"], "cpu")],
            batch_cpu, mean, std)
        worst16 = []
        keys = ("recon_orig", "oppo_orig", "err_mean", "err_max")
        _held_rows("bf16 artifact", dict(refs, card=art16), keys, worst16)
        _held_rows("warm bf16 server", dict(refs, card=live16), keys,
                   worst16)
        d16 = max((art16[k] - live16[k]).abs().max().item() for k in keys)
        say(f"  bf16 artifact exported in {t_exp:.2f}s "
            f"({len(data16) / 1e6:.2f} MB); pred equal to the warm bf16 "
            f"server {bool((art16['pred'] == live16['pred']).all())}, max "
            f"delta {d16:.3e}; worst bf16 margin {max(worst16):.3e}")
        seconds["d"] = time.perf_counter() - t0

        # --- c/d: the kernel by name inside both artifact steps ----------
        # one fresh process per artifact: the third window of one process
        # once saw 10 of the 20 launches, as a window late in this long
        # process had; the first window of a process never has
        t0 = time.perf_counter()
        np.savez(os.path.join(root, "batch.npz"),
                 **{k: host[k] for k in ("x", "r", "s", "m")})
        profiled = {}
        for label, path in (("high", arts["--export-serve"]),
                            ("highest", arts["highest"]),
                            ("bf16", arts["bf16"])):
            spec = os.path.join(root, f"profile_{label}.json")
            with open(spec, "w") as fp:
                json.dump({"batch": os.path.join(root, "batch.npz"),
                           "artifacts": {label: path}}, fp)
            proc = subprocess.run(
                [sys.executable, "-c", "import sys; sys.path.insert(0, "
                 f"{ROOT!r}); import chip_smoke; "
                 f"chip_smoke.profile_artifacts({spec!r})"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"the {label} artifact's profiler process: rc "
                     f"{proc.returncode}: {proc.stderr[-3000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            profiled[label] = out[label]
            profiled.setdefault("seconds", out["seconds"])
        say(f"-- 19c/d: one step of each artifact in a torch.profiler "
            f"window, each in a fresh process ({time.perf_counter() - t0:.1f}"
            f"s; the first's cold start, seconds per stage: "
            f"{profiled['seconds']})")
        _hold_profiled("artifact[high]", profiled["high"], "bf16x3")
        _hold_profiled("artifact[highest]", profiled["highest"], "fp32")
        _hold_profiled("artifact[bf16]", profiled["bf16"], "bf16")
        seconds["profile"] = time.perf_counter() - t0

        # --- e. the plain contract against InferenceEngine.step ----------
        t0 = time.perf_counter()
        plain = export.load_serving_step(arts["--export"], dev)
        xb = batch["x"].float()
        got = plain(xb, batch["r"], batch["s"], batch["m"])
        want = InferenceEngine(models["high"], ops).step(
            {"x": xb, "r": batch["r"], "s": batch["s"], "m": batch["m"]},
            warm.mean_dev, warm.std_dev)
        if set(got) != {"pred", "recon_orig", "oppo_orig"}:
            fail(f"--export outputs {sorted(got)}")
        rel = {k: ((got[k].float() - want[k].float()).abs()
                   / (1e-6 + 1e-6 * want[k].float().abs())).max().item()
               for k in got}
        say(f"-- 19e: --export against InferenceEngine.step on the same "
            f"batch: |delta| / (1e-6 + 1e-6 |want|) max {rel} (bar 1)")
        if not all(v <= 1.0 for v in rel.values()):
            fail("the --export artifact differs from InferenceEngine.step")
        seconds["e"] = time.perf_counter() - t0

        # --- f. times ----------------------------------------------------
        t0 = time.perf_counter()
        warm.save_meshes = True  # the artifact's contract: meshes out
        say(f"-- 19f: host-paced steps at B={BATCH} (CUDA events, median "
            f"of {2 * RUNS}), in turns; peak memory ({card})")
        fns = {"serve_step": lambda: warm.serve_step(batch),
               "artifact": lambda: step(*args)}

        def via_op():
            # the eager step with every kernel call dispatched through the
            # registered operator, as an exported program calls it (a
            # serving step has no pool backward)
            saved = port_cheb.bsr_grouped_spmm
            port_cheb.bsr_grouped_spmm = bsr_spmm.through_op
            try:
                return warm.serve_step(batch)
            finally:
                port_cheb.bsr_grouped_spmm = saved

        fns["serve_step via the operator"] = via_op
        times = {k: [] for k in fns}
        for name in ("serve_step", "artifact", "serve_step via the operator",
                     "serve_step via the operator", "artifact",
                     "serve_step") * 2:
            times[name].append(time_ms(torch, fns[name], runs=2 * RUNS,
                                       backlog=False))
        for name, fn in fns.items():
            peak, own = _step_memory(torch, fn)
            say(f"  {name}: {', '.join(f'{t:.3f}' for t in times[name])} ms "
                f"per turn ({BATCH / statistics.median(times[name]) * 1e3:.1f}"
                f" meshes/sec at the median); peak memory {peak:.1f} MiB, the "
                f"step's own {own:.1f} MiB")
        ms = {k: statistics.median(v) for k, v in times.items()}
        # the host's cost of one kernel call, direct and through the
        # operator, with the device held by a sleep kernel (the serving
        # step is host-paced, so this is what the dispatch adds to it)
        bsr = ops.lap[0].bsr
        xk = torch.randn(bsr.n_pad_cols, 128, device=dev)
        calls = {"direct": lambda: bsr_spmm.bsr_grouped_spmm(bsr, xk,
                                                             "bf16x3"),
                 "through the operator": lambda: bsr_spmm.through_op(
                     bsr, xk, "bf16x3")}
        host_us = {k: [] for k in calls}
        for name in ("direct", "through the operator") * 3:
            for _ in range(20):
                calls[name]()
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)
            t1 = time.perf_counter()
            for _ in range(200):
                calls[name]()
            host_us[name].append((time.perf_counter() - t1) / 200 * 1e6)
            torch.cuda.synchronize()
        added = LAUNCHES_PER_STEP * (statistics.median(
            host_us["through the operator"])
            - statistics.median(host_us["direct"])) / 1e3
        say(f"  host us per kernel call (L0, C=128, bf16x3; device "
            f"backlogged): direct {host_us['direct']}, through the operator "
            f"{host_us['through the operator']}; {LAUNCHES_PER_STEP} calls "
            f"per step: {added:+.3f} ms, {added / ms['serve_step']:+.2%} of "
            f"serve_step's median")
        say(f"  medians: artifact / serve_step "
            f"{ms['artifact'] / ms['serve_step']:.3f}; serve_step via the "
            f"operator / serve_step "
            f"{ms['serve_step via the operator'] / ms['serve_step']:.3f}; the"
            f" kernel per artifact step {profiled['high']['ms']:.3f} ms "
            f"(highest {profiled['highest']['ms']:.3f} ms, bf16 "
            f"{profiled['bf16']['ms']:.3f} ms) in the profiler window")
        seconds["f"] = time.perf_counter() - t0
    finally:
        warm.close()
    say("phase 19 seconds " + json.dumps({k: round(v, 1)
                                          for k, v in seconds.items()}))
    return profiled


# --- phase 20: models/experimental.py and the post-hoc entry points ----------
EXP_BATCH = 16
EXP_GAT_L0_BATCH = 4   # the CPU side's logits: 4 x 4998^2 fp32, 0.4 GB each
EXP_STYLE = 16
EXP_FWD, EXP_GRAD, EXP_STATS = 1e-5, 1e-4, 1e-6
EXP_CARD_RUNS = 10


def _flax_tree(shapes: dict, rng) -> dict:
    """A flax variable tree of numpy leaves for nested `shapes`: kernels
    (2-D and up) ~ N(0, 1 / fan_in), vectors ~ 0.5 N(0, 1); batch_stats
    means ~ 0.1 N(0, 1), variances ~ U(0.5, 1.5)."""
    import numpy as np

    def draw(name, shape):
        if isinstance(shape, dict):
            return {k: draw(k, v) for k, v in shape.items()}
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        std = (0.1 if name == "mean" else 0.5 if len(shape) == 1
               else 1.0 / math.sqrt(math.prod(shape[:-1])))
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return draw("", shapes)


def _exp_scalar(out, weights=None):
    """out.sum(), or sum_i (out_i * w_i).sum() over a tuple's outputs (a
    None weight: the plain sum)."""
    if weights is None:
        return out.sum()
    return sum(o.sum() if w is None else (o * w).sum()
               for o, w in zip(out, weights))


def _exp_grad_err(named_card: dict, named_cpu: dict) -> float:
    """max over parameters of |card - CPU| / the layer's max|g_CPU| (a
    layer: the parameter name up to its last dot)."""
    layer = lambda n: n.rsplit(".", 1)[0] if "." in n else ""
    scale = {}
    for n, p in named_cpu.items():
        scale[layer(n)] = max(scale.get(layer(n), 0.0),
                              float(p.grad.abs().max()))
    return max(float((named_card[n].grad.cpu() - p.grad).abs().max())
               / max(scale[layer(n)], 1e-30) for n, p in named_cpu.items())


def _exp_fwd_err(card, cpu) -> float:
    pairs = zip(card, cpu) if isinstance(cpu, tuple) else [(card, cpu)]
    return max(float((a.detach().cpu() - b.detach()).abs().max())
               / max(float(b.detach().abs().max()), 1e-30) for a, b in pairs)


def _exp_case(torch, dev, label, make, tree, args, call=None, weights=None):
    """One module card vs CPU from the same flax-layout weights: make(device)
    builds it, args(device) gives its call arguments, call(module, *args)
    runs it (module(*args) by default), and the gradients are those of
    _exp_scalar(out, weights) (numpy weights). Prints the errors, the
    card's forward + backward ms (CUDA events), the CPU's (one call) and
    the step's device memory peak over what was allocated before."""
    from meshvae_tpu_torch.models.vae import params_from_flax

    state = params_from_flax(tree)
    call = call or (lambda m, *a: m(*a))
    on = lambda d: None if weights is None else [
        None if w is None else torch.from_numpy(w).to(d) for w in weights]
    mods, outs, cpu_ms = {}, {}, None
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        m = make(device)
        m.load_state_dict(state)  # strict: the names and shapes of the tree
        a, w = args(device), on(device)
        t0 = time.perf_counter()
        out = call(m, *a)
        _exp_scalar(out, w).backward()
        if where == "cpu":
            cpu_ms = 1e3 * (time.perf_counter() - t0)
        mods[where], outs[where] = m, out
    fwd = _exp_fwd_err(outs["card"], outs["cpu"])
    grad = _exp_grad_err(dict(mods["card"].named_parameters()),
                         dict(mods["cpu"].named_parameters()))
    m, a, w = mods["card"], args(dev), on(dev)

    def step():
        m.zero_grad(set_to_none=True)
        _exp_scalar(call(m, *a), w).backward()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    card_ms = time_ms(torch, step, runs=EXP_CARD_RUNS, warmup=1)
    say(f"  {label}: forward within {fwd:.2e} of max|y| (bar {EXP_FWD:g}), "
        f"gradients within {grad:.2e} of the layer's max|g| (bar "
        f"{EXP_GRAD:g}); forward + backward card {card_ms:.3f} ms, CPU "
        f"{cpu_ms:.1f} ms (one call), device peak +{peak:.1f} MiB")
    if not (fwd <= EXP_FWD and grad <= EXP_GRAD):
        fail(f"experimental {label}: card vs CPU beyond the bars")


def _exp_reductions(torch, dev, adj, pts, rng):
    """The two sums the port writes its own way, against fp64 on the
    phase's inputs: DiffPool's link loss on the CPU (torch.linalg.norm
    against the root of the summed squares, which the port takes) and
    PointCNN's 4998-term 1-wide conv on the card (F.conv1d against the
    one einsum product the port takes). Printed, not held: the modules'
    own bars are."""
    import numpy as np
    import torch.nn.functional as F

    n0, n1 = adj.shape[0], (adj.shape[0] + 3) // 4
    s = torch.softmax(torch.from_numpy((rng.standard_normal((n0, n1))
                                        / math.sqrt(n0)).astype(np.float32)),
                      dim=-1)
    d = torch.from_numpy(adj) - s @ s.T
    ref = float(torch.sqrt((d.double() ** 2).sum()))
    norm_err = abs(float(torch.linalg.norm(d)) - ref) / ref
    sq_err = abs(float(torch.sqrt(torch.sum(d * d))) - ref) / ref
    w = torch.from_numpy((rng.standard_normal((3, n0)) / math.sqrt(n0))
                         .astype(np.float32))
    x = torch.from_numpy(pts)
    ref = torch.einsum("bnl,on->blo", x.double(), w.double())
    rel = lambda t: float((t.double().cpu() - ref).abs().max()
                          / ref.abs().max())
    xd, wd = x.to(dev), w.to(dev)
    conv = rel(F.conv1d(xd, wd[:, :, None]).transpose(1, 2))
    ein = rel(torch.einsum("bnl,on->blo", xd, wd))
    say(f"  the port's sums against fp64: DiffPool's link loss on the CPU, "
        f"torch.linalg.norm {norm_err:.2e}, sqrt(sum(d * d)) {sq_err:.2e} "
        f"(taken); PointCNN's conv on template coordinates on the card, "
        f"F.conv1d {conv:.2e}, the einsum {ein:.2e} (taken), of max|y|")


def _exp_point_cnn(torch, dev, pts, rng):
    """PointCNN over pts [16, 4998, 3] card vs CPU: train mode (the output,
    the gradients, the batch_stats it updates), then eval mode on them."""
    from meshvae_tpu_torch.models.experimental import PointCNN
    from meshvae_tpu_torch.models.vae import params_from_flax

    n = pts.shape[1]
    dense = lambda i, o: {"kernel": (i, o), "bias": (o,)}
    tree = _flax_tree({"params": {
        "Conv_0": {"kernel": (1, n, 3), "bias": (3,)},
        "BatchNorm_0": {"scale": (3,), "bias": (3,)},
        "Dense_0": dense(9, 90), "Dense_1": dense(90, 10),
        "Dense_2": dense(10, 5), "Dense_3": dense(5, 1)},
        "batch_stats": {"BatchNorm_0": {"mean": (3,), "var": (3,)}}}, rng)
    make = lambda d: PointCNN(n, device=d)
    args = lambda d: (torch.from_numpy(pts).to(d),)
    _exp_case(torch, dev, f"PointCNN train mode [{EXP_BATCH}, {n}, 3]", make,
              tree, args, call=lambda m, x: m(x, train=True)[0])
    # the timed card steps updated the card's statistics again: compare one
    # update on each side, from a fresh module each
    fresh = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        m = make(device)
        m.load_state_dict(params_from_flax(tree))
        with torch.no_grad():
            m(*args(device), train=True)
        fresh[where] = {k: v.cpu() for k, v in
                        m.batch_stats()["BatchNorm_0"].items()}
    err = max(float((fresh["card"][k] - fresh["cpu"][k]).abs().max())
              / float(fresh["cpu"][k].abs().max()) for k in ("mean", "var"))
    say(f"  PointCNN batch_stats after one train step: within {err:.2e} of "
        f"their max (bar {EXP_STATS:g}); mean "
        f"{[round(v, 4) for v in fresh['cpu']['mean'].tolist()]}, var "
        f"{[round(v, 4) for v in fresh['cpu']['var'].tolist()]}")
    if not err <= EXP_STATS:
        fail("experimental PointCNN: batch_stats card vs CPU beyond the bar")
    updated = {"params": tree["params"], "batch_stats": {"BatchNorm_0": {
        k: v.numpy() for k, v in fresh["cpu"].items()}}}
    _exp_case(torch, dev, "PointCNN eval mode on the updated statistics",
              make, updated, args)


def _exp_report(infer_json: str):
    """python -m meshvae_tpu_torch.report -p -e -j on an inference.json the
    inference CLI wrote on the card: its counts against that file."""
    with open(infer_json) as fp:
        data = json.load(fp)
    proc = subprocess.run([sys.executable, "-m", "meshvae_tpu_torch.report",
                           infer_json, "-p", "-e", "-j"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"report -p -e -j: rc {proc.returncode}: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout)
    wrong = [n for n, r in data.items()
             if (0 if n.split("_")[1] == "f" else 1) != r["sex"]]
    by_max = sorted(data, key=lambda n: data[n]["reconstruction_error"]["max"])
    if (got["predictions"] != len(data) or got["errors"]["count"] != len(data)
            or got["prediction"]["wrong"] != wrong
            or [e["name"] for e in got["sorted_max_errors"]] != by_max):
        fail(f"report's summary disagrees with {infer_json}")
    text = subprocess.run([sys.executable, "-m", "meshvae_tpu_torch.report",
                           infer_json, "-p"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    if text.returncode != 0 or f"{len(data)} predictions" not in text.stdout:
        fail(f"report -p: rc {text.returncode}: {text.stdout[-500:]}")
    say(f"  report -p -e -j: {got['predictions']} predictions, "
        f"{len(got['prediction']['wrong'])} wrong, accuracy "
        f"{got['prediction']['accuracy_pct']:.2f}%, worst max error "
        f"{got['errors']['max_error']['worst']:.4f}; counts equal to the "
        f"file's")


def _exp_plot(histories: list, tmp: str):
    """plot_losses's data part on history files a driver wrote on the card:
    the metric names and the epochs of every curve; drawn when matplotlib
    imports, else its absence is printed and -o must exit 2 naming it."""
    from meshvae_tpu_torch import plot_losses

    cfg = os.path.join(ROOT, "files", "default.cfg")
    folds = plot_losses.load_histories(histories)
    panels = plot_losses.curves(folds)
    metrics = list(folds[0][1][0]["validation"])
    if [p["metric"] for p in panels] != metrics:
        fail(f"plot_losses panels {[p['metric'] for p in panels]} != "
             f"{metrics}")
    for p in panels:
        want = [(split, [e["epoch"] for e in fold])
                for _, fold in folds for split in plot_losses.SPLITS
                if p["metric"] in fold[0][split]]
        got = [(ln["label"].split(" ")[0], ln["x"]) for ln in p["lines"]]
        if got != want or any(len(ln["y"]) != len(ln["x"])
                              for ln in p["lines"]):
            fail(f"plot_losses {p['metric']}: curves {got} != {want}")
    text = plot_losses.text_block(folds, cfg)
    if not (text.startswith("Total training time : ")
            and "\nConfig : {" in text):
        fail(f"plot_losses text block: {text[:200]}")
    out = os.path.join(tmp, "losses.png")
    proc = subprocess.run([sys.executable, "-m",
                           "meshvae_tpu_torch.plot_losses", *histories, "-c",
                           cfg, "-o", out], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    try:
        import matplotlib  # noqa: F401
        drawn = True
    except ImportError:
        drawn = False
    if drawn and (proc.returncode != 0 or not os.path.getsize(out)):
        fail(f"plot_losses -o: rc {proc.returncode}: {proc.stderr[-1000:]}")
    if not drawn and (proc.returncode != 2
                      or "matplotlib" not in proc.stderr):
        fail(f"plot_losses -o without matplotlib: rc {proc.returncode}, "
             f"{proc.stderr[-500:]}")
    say(f"  plot_losses: {len(panels)} panels "
        f"({', '.join(metrics)}), {sum(len(p['lines']) for p in panels)} "
        f"curves over {[len(f) for _, f in folds]} epochs; "
        f"{text.splitlines()[0]}")
    say(f"plot: drawn, {os.path.getsize(out)} bytes" if drawn
        else "plot: matplotlib absent, not drawn")


def phase_experimental(torch, dev, hier, tmpl, tmp, card, infer_json,
                       histories):
    """Phase 20 (see the module docstring)."""
    say("== phase 20: models/experimental.py (dense path, card vs CPU) and "
        "the report / plot_losses entry points")
    import numpy as np

    from meshvae_tpu_torch.models import experimental as exp
    from meshvae_tpu_torch.ops import (bsr_spmm, cheb_fused, cheb_mix,
                                       emitted_spmm)
    from meshvae_tpu_torch.ops.graph import cheb_operator

    def counters():
        return (bsr_spmm.launches(), bsr_spmm.launches_seed_dot(),
                sum(bsr_spmm.LAUNCHES_BY_CALL.values()),
                dict(cheb_fused.LAUNCHES), dict(emitted_spmm.LAUNCHES),
                pt_counts()[0], dict(cheb_mix.LAUNCHES))

    t0 = time.perf_counter()
    before = counters()
    ops = {w: [cheb_operator(hier.adjacency[i], d, bsr_min_n=None)
               for i in (0, 1)]
           for w, d in (("card", dev), ("cpu", torch.device("cpu")))}
    on = lambda d: "card" if d.type == "cuda" else "cpu"
    n0, n1 = ops["cpu"][0].n, ops["cpu"][1].n
    say(f"  dense operators: level 0 {n0}, level 1 {n1} (cheb_method dense)")
    rng = np.random.default_rng(20)
    b, f, h = EXP_BATCH, 16, 512
    rows = (3.0 * rng.standard_normal((b, h)) + 1.0).astype(np.float32)
    x0 = rng.standard_normal((b, n0, f)).astype(np.float32)
    x1 = rng.standard_normal((b, n1, f)).astype(np.float32)
    style = rng.standard_normal((b, EXP_STYLE)).astype(np.float32)
    adj = np.abs(np.sign(ops["cpu"][0].dense.numpy()))
    t = lambda a, d: torch.from_numpy(a).to(d)
    dense = lambda i, o: {"kernel": (i, o), "bias": (o,)}
    gat = lambda: {"params": {"Dense_0": {"kernel": (f, f)},
                              "a_src": (f, 1), "a_dst": (f, 1)}}
    cases = [
        (f"EqualLinear {h}->{h} [{b}, {h}]",
         lambda d: exp.EqualLinear(h, h, device=d),
         {"params": {"kernel": (h, h), "bias": (h,)}},
         lambda d: (t(rows, d),)),
        (f"GraphNorm [{b}, {h}]", lambda d: exp.GraphNorm(h, device=d),
         {"params": {"gamma": (h,), "beta": (h,)}}, lambda d: (t(rows, d),)),
        (f"AdaptiveInstanceNorm [{b}, {n0}, {f}], style {EXP_STYLE}",
         lambda d: exp.AdaptiveInstanceNorm(f, EXP_STYLE, device=d),
         {"params": {"style_kernel": (EXP_STYLE, 2 * f),
                     "style_bias": (2 * f,)}},
         lambda d: (t(x0, d), t(style, d))),
        (f"SpatialConv {f}->{f} on level 0 [{b}, {n0}, {f}]",
         lambda d: exp.SpatialConv(f, f, device=d),
         {"params": {"Dense_0": dense(f, f)}},
         lambda d: (t(x0, d), ops[on(d)][0])),
        (f"GraphAttention {f}->{f} on level 1 [{b}, {n1}, {f}]",
         lambda d: exp.GraphAttention(f, f, device=d), gat(),
         lambda d: (t(x1, d), ops[on(d)][1])),
        (f"GraphAttention {f}->{f} on level 0 at B={EXP_GAT_L0_BATCH} "
         f"[{EXP_GAT_L0_BATCH}, {n0}, {f}]",
         lambda d: exp.GraphAttention(f, f, device=d), gat(),
         lambda d: (t(x0[:EXP_GAT_L0_BATCH], d), ops[on(d)][0])),
    ]
    # DiffPool's pooled.sum() and coarse_adj.sum() do not depend on s (its
    # softmax rows sum to 1): their gradient is rounding noise, larger
    # than link_loss's. The gradients are of fixed random weightings of
    # the two and of link_loss.
    dp_weights = (rng.standard_normal((b, n1, f)).astype(np.float32),
                  rng.standard_normal((n1, n1)).astype(np.float32), None)
    cases = [c + (None,) for c in cases] + [
        (f"DiffPool {n0}->{n1} [{b}, {n0}, {f}], adj = |sign(L0)|",
         lambda d: exp.DiffPool(n0, n1, device=d),
         {"params": {"s": (n0, n1)}},
         lambda d: (t(x0, d), t(adj.astype(np.float32), d)), dp_weights)]
    for label, make, shapes, args, weights in cases:
        _exp_case(torch, dev, label, make, _flax_tree(shapes, rng), args,
                  weights=weights)
        torch.cuda.empty_cache()
    # GraphAttention at level 0 and B=16 on the card alone: time and memory
    gat0 = exp.GraphAttention(f, f, device=dev)
    xg = t(x0, dev)

    def gat_step():
        gat0.zero_grad(set_to_none=True)
        gat0(xg, ops["card"][0]).sum().backward()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gat_step()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    gat_ms = time_ms(torch, gat_step, runs=EXP_CARD_RUNS, warmup=1)
    say(f"  GraphAttention {f}->{f} on level 0 at B={b} (card only): "
        f"forward + backward {gat_ms:.3f} ms, device peak +{peak:.1f} MiB")
    del gat0, xg
    torch.cuda.empty_cache()

    # sort_pool, k = level 1's count, with ties in the sort channel
    xs = x0.copy()
    xs[:, :, -1] = np.round(4 * xs[:, :, -1]) / 4
    got = exp.sort_pool(t(xs, dev), n1).cpu()
    want = exp.sort_pool(t(xs, torch.device("cpu")), n1)
    if got.shape != (b, n1 * f) or not torch.equal(got, want):
        fail("experimental sort_pool: card and CPU differ")
    sp_ms = time_ms(torch, lambda: exp.sort_pool(t(xs, dev), n1),
                    runs=EXP_CARD_RUNS, warmup=1)
    say(f"  sort_pool k={n1} on [{b}, {n0}, {f}] (ties in the sort channel):"
        f" card and CPU bit-equal; card {sp_ms:.3f} ms with the upload")

    pts = (tmpl.v[None] + 0.01 * rng.standard_normal(
        (b, n0, 3))).astype(np.float32)
    _exp_point_cnn(torch, dev, pts, rng)
    _exp_reductions(torch, dev, adj.astype(np.float32), pts, rng)
    t1 = time.perf_counter()
    verts, faces = exp.pc2mesh(tmpl.v)
    pc_secs = time.perf_counter() - t1
    if (faces.ndim != 2 or faces.shape[0] == 0 or faces.min() < 0
            or faces.max() >= verts.shape[0]):
        fail(f"pc2mesh on the template: faces {faces.shape}")
    say(f"  pc2mesh on the template's {verts.shape[0]} vertices: "
        f"{faces.shape[0]} faces in {pc_secs:.2f} s (host)")
    after = counters()
    if after != before:
        fail(f"phase 20 launched a kernel of the port: {before} -> {after}")
    say(f"  launch counters unchanged across the modules: {after[0]}, seed "
        f"{after[1]}, fused {after[3]}, emitted {after[4]}, pool_transpose "
        f"{after[5]}")
    for path in (infer_json, *histories):
        if not os.path.isfile(path):
            fail(f"phase 20 reads {path}, which an earlier phase writes")
    _exp_report(infer_json)
    _exp_plot(histories, tmp)
    if counters() != before:
        fail("phase 20's entry points launched a kernel of the port")
    say(f"  ({card}) phase 20 {time.perf_counter() - t0:.1f} s")


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

    from meshvae_tpu_torch.ops import bsr_spmm
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
        reset_launches()
        worst_abs = phase_kernel(torch, ops, s20["ops"], dev)
        worst80 = phase_kernel_bf16(torch, s80["ops"], dev)
        covered = set(bsr_spmm.LAUNCHES_BY_CALL)  # phase 16 holds the rest
        pt_err = phase_pool_transpose(torch, ops, s20, s80, dev)
        mixed = phase_mix(torch, dev)
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
        train_launches, pt_shapes = phase_train(torch, dev, models, ops,
                                                hier, tmpl, tmp)
        seconds["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_step80, launches80 = phase_scaled80k(torch, dev, s80, tmp)
        seconds["scaled80k"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_step_j80, launches_j80 = phase_joint80k(torch, dev, s80, tmp)
        seconds["joint80k"] = time.perf_counter() - t0
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
        t0 = time.perf_counter()
        phase_tiles(dev, s80, tmp)
        seconds["tiles"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mapped, world_classifiers = phase_distribution(
            torch, dev, models, ops, hier, tmpl, (mean, std), many_dir, s20,
            s80, tmp, card)
        seconds["distribution"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scan_reports, _ = phase_scan(torch, dev, models, ops, hier, s20, s80,
                                     tmp)
        seconds["scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        marked = phase_marks(torch, dev)
        seconds["marks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        classifiers = phase_classifiers(torch, dev, ops, hier, tmpl, tmp,
                                        covered, card)
        seconds["classifiers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bf16_paths = phase_bf16_paths(
            torch, dev, models, ops, hier, tmpl, single, many_dir,
            (mean, std), s80, tmp, covered | classifiers["keys"], card)
        seconds["bf16_paths"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reference = phase_reference(torch, dev, tmpl, many_dir, s20, s80,
                                    tmp, card)
        seconds["reference"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        exported = phase_export(torch, dev, models, ops, hier, tmpl, single,
                                many_dir, (mean, std), bf16_paths["ctx"],
                                tmp, card)
        seconds["export"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_experimental(
            torch, dev, hier, tmpl, tmp, card,
            os.path.join(tmp, "infer", "card_high", "inference.json"),
            [os.path.join(tmp, "ckpt_default", f"history{n}.json")
             for n in (1, 2)])
        seconds["experimental"] = time.perf_counter() - t0
    say("phase seconds " + json.dumps({k: round(v, 1)
                                       for k, v in seconds.items()}))

    entry = kernel_entry

    def pool_entry(name, replaces, launched, err, acc):
        return kernel_entry(f"pool_transpose[{name}", replaces, launched,
                            err, acc, source=SOURCE_POOL)

    # phase 6's P^T launches per up-pool, over both precisions' runs
    pool_launches = [sum(v for (_, n_in, _, _), v in
                         (kv for p in pt_shapes for kv in pt_shapes[p].items())
                         if n_in == up.n_in) for up in ops.up[:3]]
    lap_fp32 = train_launches["highest"]["fp32"]
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
        pool_entry("fp32] train step: up-pools 0-1 P^T (#7's calls)",
                   REPLACES["colmajor"], pool_launches[0] + pool_launches[1],
                   pt_err["fp32"], per_step["train_pool_colmajor"]),
        pool_entry("fp32] train step: up-pool 2 P^T (#4's call)",
                   REPLACES["grouped"], pool_launches[2], pt_err["fp32"],
                   per_step["train_pool_grouped"]),
        entry("bsr_grouped_spmm[bf16] scaled80k train step: Laplacian",
              REPLACES["fp32"], launches80["lap"], worst80["lap"],
              per_step80["lap"]),
        pool_entry("bf16] scaled80k train step: up-pool 0 P^T (#5's call)",
                   REPLACES["perblock"], launches80["pool_perblock"],
                   pt_err["bf16"], per_step80["pool_perblock"]),
        pool_entry("bf16] scaled80k train step: up-pools 1-3 P^T (#7's "
                   "calls)", REPLACES["colmajor"],
                   launches80["pool_colmajor"], pt_err["bf16"],
                   per_step80["pool_colmajor"]),
        # the bf16x3 mode's launches on the main path (serving); the P^T
        # case itself runs on no main path (the pool backward is fp32 and
        # takes pool_transpose)
        entry("bsr_grouped_spmm[bf16x3] pool P^T, column-major form "
              "(phase 3 shapes, off the main path)",
              REPLACES["colmajor_bf16x3"], launches["bf16x3"],
              worst_abs["pool_bf16x3"], per_step["pool_bf16x3_colmajor"]),
        entry("bsr_grouped_spmm[bf16x3] pool P^T, per-block form (phase 3 "
              "both-seed shape, off the main path)",
              REPLACES["perblock_bf16x3"], launches["bf16x3"],
              worst_abs["pool_bf16x3"], per_step["pool_bf16x3_perblock"]),
        entry("bsr_grouped_spmm[bf16] joint80k train step: Laplacian",
              REPLACES["fp32"], launches_j80["lap"], worst80["lap"],
              per_step_j80["lap"]),
        pool_entry("bf16] joint80k train step: up-pool 0 P^T at 2B (#5's "
                   "call)", REPLACES["perblock"],
                   launches_j80["pool_perblock"], pt_err["bf16"],
                   per_step_j80["pool_perblock"]),
        pool_entry("bf16] joint80k train step: up-pools 1-3 P^T at 2B (#7's "
                   "calls)", REPLACES["colmajor"],
                   launches_j80["pool_colmajor"], pt_err["bf16"],
                   per_step_j80["pool_colmajor"]),
        entry("bsr_grouped_spmm[fp32] scaled20k train step: Laplacian",
              REPLACES["fp32"], launches20["lap"], worst_abs["fp32"],
              per_step20["lap"]),
        entry("bsr_grouped_spmm[fp32] scaled20k train step: lazy seed",
              REPLACES["seed_dot"], launches20["seed_dot"],
              worst_abs["seed_fp32"], per_step20["lap_seed_dot"]),
        pool_entry("fp32] scaled20k train step: P^T (#7's calls)",
                   REPLACES["colmajor"], launches20["pool"], pt_err["fp32"],
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
    for key, e in emitted.items():
        kernels.append(dict(
            name=f"emitted_spmm[{key[-4:]}] probe, L0 {key} C={e['c']}",
            route="cuda", source=SOURCE_EMITTED, replaces=REPLACES["emitted"],
            launches=e["launches"],
            max_abs_err=emitted_err[torch.bfloat16 if key.endswith("bf16")
                                    else torch.float32],
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            bound_stored_ms=e["stored_ms"]))
    # phase 3c: cheb_mix's mix and dW per train step at the cells' shapes;
    # phase 7's launches per 80k train step
    for cell, got in mixed.items():
        kernels.append(dict(
            kernel_entry(f"cheb_mix[{cell.split()[-1]}] {cell} train step: "
                         "basis mix and dW", "none (pallas_cheb.py:826 "
                         "_basis_mix: concatenation and XLA dot_general)",
                         got["calls"], got["worst"], got["acc"],
                         source=SOURCE_MIX),
            cublas_ms=got["acc"]["cublas_ms"]))
    # _mapped_product (pallas_shard.py:150): the sp=2 world's kernel calls
    kernels.append(mapped)
    # phase 14g: crecon's and the joint model's train steps in the dp=2 and
    # sp=2 worlds (rank 0's launches over 14e's main path; its shapes)
    kernels += world_classifiers
    # phase 15: the same calls replayed in CUDA graphs (launches counted per
    # replay from what was captured, over 3 epochs of SCAN_STEPS); times as
    # measured per step above
    scan = {r["case"]: r["train_launches"] for r in scan_reports}
    graphed = [
        ("config-1 high", "bf16x3", "bf16x3", per_step["train_lap_bf16x3"],
         worst_abs["bf16x3"], scan["config-1 high"][0]["bf16x3"]),
        ("config-1 highest", "fp32", "fp32", per_step["train_lap_fp32"],
         worst_abs["fp32"], scan["config-1 highest"][0]["fp32"]),
        ("scaled20k fp32, FUSED_SEED_DOT", "fp32", "seed_dot",
         per_step20["lap_seed_dot"], worst_abs["seed_fp32"],
         scan["scaled20k fp32, FUSED_SEED_DOT"][1]["fp32"]),
        ("scaled80k bf16", "bf16", "fp32", per_step80["lap"], worst80["lap"],
         scan["scaled80k bf16"][0]["bf16"])]
    for case, mode, replaces, acc, err, launched in graphed:
        part = "lazy seed" if replaces == "seed_dot" else "Laplacian"
        kernels.append(entry(
            f"bsr_grouped_spmm[{mode}] {case} train step replayed in a CUDA "
            f"graph (scanned epoch): {part}", REPLACES[replaces], launched,
            err, acc))
    kernels.append(pool_entry(
        "fp32] config-1 high train step replayed in a CUDA graph (scanned "
        "epoch): up-pools 0-2 P^T", REPLACES["colmajor"],
        scan["config-1 high"][0]["pool fp32"], pt_err["fp32"],
        {k: per_step["train_pool_colmajor"][k]
         + per_step["train_pool_grouped"][k] for k in ACC_KEYS + ("old_ms",)}))
    # phase 15's graphed config-1 high epochs: the steps' phase marks
    # (train and eval), per mark; phase 15b's cells and times
    marks15 = {r["case"]: r["mark_launches"] for r in scan_reports}[
        "config-1 high"]
    kernels.append(dict(
        name="phase_mark per mark, config-1 high scanned train and eval "
             "steps replayed in CUDA graphs", route="cuda",
        source="meshvae_tpu_torch/ops/csrc/phase_mark.cu",
        replaces="none (the JAX package's scanned epoch has no phase marks)",
        launches=sum(marks15["train"].values()) + sum(
            marks15["eval"].values()),
        max_abs_err=marked["err"], ms=marked["ms"],
        plain_ms=marked["plain_ms"], bound_ms=None, bound_by="launch",
        library_ms=None, bound_stored_ms=None))
    # phase 16: the classifier pipelines' train steps. Launches at high
    # (bf16x3, and the joint model's fp32 P^T) from the run() of each; at
    # highest (fp32) from one counted epoch of SCAN_STEPS replayed steps
    cl, err16 = classifiers["per_step"], classifiers["worst"]
    joint16, joint17 = classifiers["joint"], bf16_paths["out"]["c"]["joint"]
    replay = classifiers["per_replay"]
    pool_err = max(pt_err["fp32"], cl["joint_pool_colmajor"]["err_abs"],
                   cl["joint_pool_grouped"]["err_abs"])
    kernels += [
        entry("bsr_grouped_spmm[bf16x3] crecon train step: Laplacian",
              REPLACES["bf16x3"], classifiers["crecon"],
              max(worst_abs["bf16x3"], err16["bf16x3"]),
              cl["crecon_lap_bf16x3"]),
        entry("bsr_grouped_spmm[fp32] crecon train step: Laplacian",
              REPLACES["fp32"], replay["crecon highest"]["lap"],
              max(worst_abs["fp32"], err16["fp32"]), cl["crecon_lap_fp32"]),
        entry("bsr_grouped_spmm[bf16x3] joint train step: Laplacian",
              REPLACES["bf16x3"], joint16["lap"],
              max(worst_abs["bf16x3"], err16["bf16x3"]),
              cl["joint_lap_bf16x3"]),
        entry("bsr_grouped_spmm[fp32] joint train step: Laplacian",
              REPLACES["fp32"], replay["joint highest"]["lap"],
              max(worst_abs["fp32"], err16["fp32"]),
              cl["joint_lap_fp32"]),
        pool_entry("fp32] joint train step: up-pools 0-1 P^T at 2B",
                   REPLACES["colmajor"],
                   joint16["pool"]["P0T"] + joint16["pool"]["P1T"], pool_err,
                   cl["joint_pool_colmajor"]),
        pool_entry("fp32] joint train step: up-pool 2 P^T at 2B",
                   REPLACES["grouped"], joint16["pool"]["P2T"], pool_err,
                   cl["joint_pool_grouped"]),
    ]
    # phase 17: the bf16 serving step, a config-4 batch (B = 128) and the
    # bf16 classifiers' train steps, all mode bf16 (#3b; the joint model's
    # P^T in bf16 blocks, #7 and #4); launches of the main-path runs
    p17, sums, err17 = (bf16_paths["out"], bf16_paths["sums"],
                        bf16_paths["worst"])
    lap16 = max(worst80["lap"], err17["lap"])
    pool16 = max(pt_err["bf16"], sums["joint_bf16_pool_colmajor"]["err_abs"],
                 sums["joint_bf16_pool_grouped"]["err_abs"])
    kernels += [
        entry("bsr_grouped_spmm[bf16] config-1 bf16 serving step",
              REPLACES["fp32"], p17["a"]["launches"]["bf16"], lap16,
              sums["serve_bf16"]),
        entry("bsr_grouped_spmm[bf16] BASELINE config 4 batch inference "
              "(B=128), per batch", REPLACES["fp32"],
              p17["b"]["launches"]["bf16"], lap16, sums["config4_batch"]),
        entry("bsr_grouped_spmm[bf16] crecon bf16 train step: Laplacian",
              REPLACES["fp32"], p17["c"]["crecon"], lap16,
              sums["crecon_bf16_lap"]),
        entry("bsr_grouped_spmm[bf16] joint bf16 train step: Laplacian",
              REPLACES["fp32"], joint17["lap"], lap16,
              sums["joint_bf16_lap"]),
        pool_entry("bf16] joint bf16 train step: up-pools 0-1 P^T at 2B",
                   REPLACES["colmajor"],
                   joint17["pool"]["P0T"] + joint17["pool"]["P1T"], pool16,
                   sums["joint_bf16_pool_colmajor"]),
        pool_entry("bf16] joint bf16 train step: up-pool 2 P^T at 2B",
                   REPLACES["grouped"], joint17["pool"]["P2T"], pool16,
                   sums["joint_bf16_pool_grouped"]),
    ]
    # phase 18: imported reference weights on the reference hierarchy (the
    # inference CLI, MeshServers, a fine-tuning step at high) and the
    # pallas step with the dense pool at highest; the ELL steps launch only
    # their P^T (pool_method gather)
    ref, ref_sums, ref_err = (reference["launches"], reference["sums"],
                              reference["worst"])
    ref_pool = sum(reference["shapes"].get(k, 0) for k in
                   reference["pool_keys"])
    ell = reference["methods"][("ell", "gather")]
    kernels += [
        entry("bsr_grouped_spmm[bf16x3] reference hierarchy, imported "
              "weights: inference CLI at high, per batch", REPLACES["bf16x3"],
              ref["infer"]["bf16x3"], ref_err["bf16x3"],
              ref_sums["serve_bf16x3"]),
        entry("bsr_grouped_spmm[bf16x3] reference hierarchy, imported "
              "weights: MeshServer serving step at high", REPLACES["bf16x3"],
              ref["serve_high"]["bf16x3"], ref_err["bf16x3"],
              ref_sums["serve_bf16x3"]),
        entry("bsr_grouped_spmm[fp32] reference hierarchy, imported "
              "weights: MeshServer serving step at highest",
              REPLACES["fp32"], ref["serve_highest"]["fp32"],
              ref_err["fp32"], ref_sums["serve_fp32"]),
        entry("bsr_grouped_spmm[bf16x3] reference hierarchy fine-tuning "
              "step: Laplacian", REPLACES["bf16x3"],
              reference["train"]["bf16x3"], ref_err["bf16x3"],
              ref_sums["train_lap_bf16x3"]),
        pool_entry("fp32] reference hierarchy fine-tuning step: P^T",
                   REPLACES["colmajor"], ref_pool, ref_err["pool"],
                   ref_sums["train_pool"]),
        entry("bsr_grouped_spmm[fp32] pool_method dense train step at "
              "highest: Laplacian", REPLACES["fp32"],
              reference["methods"][("pallas", "dense")]["lap"],
              ref_err["fp32"], ref_sums["train_lap_fp32"]),
        pool_entry("fp32] cheb_method ell train step at highest: P^T",
                   REPLACES["colmajor"], ell["pool"], ref_err["pool"],
                   ref_sums["train_pool"]),
    ]
    # phase 19: the serving artifacts' steps (torch.export, the registered
    # operator): launches counted by torch.profiler by the kernel's name in
    # one artifact step, ms that window's device time; twin, library and
    # bound of the same 20 calls (phases 5 and 17)
    kernels += [
        dict(entry(f"bsr_grouped_spmm[{mode}] config-1 {label} serving "
                   "artifact step (torch.export)", REPLACES[tpu],
                   got["launches"], err, acc), ms=got["ms"])
        for mode, label, tpu, got, err, acc in (
            ("bf16x3", "high, --serve --artifact", "bf16x3", exported["high"],
             worst_abs["bf16x3"], per_step["serve_bf16x3"]),
            ("fp32", "highest", "fp32", exported["highest"],
             worst_abs["fp32"], per_step["serve_fp32"]),
            ("bf16", "bf16", "fp32", exported["bf16"], lap16,
             sums["serve_bf16"]))]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
