"""The port's side of tests/test_torch_world_classifiers.py: the scenarios
one rank of a ("dp", "sp") world runs for crecon, the joint VAE + GCN and
the Trainer's scanned epoch. It imports torch, numpy, the port and
tests/torch_parallel_worker.py (grid, hierarchy, batches) only, because
the ranks of a spawned gloo world start from a fresh interpreter and
import it; the test process calls the same scenarios with dist=None for
the single-process reference."""
import os

import numpy as np
import torch

from meshvae_tpu_torch.models import (ChebGCN, GCNConfig, MeshVAE, VAEConfig,
                                      build_operators)
from meshvae_tpu_torch.models.joint import build_joint_model
from meshvae_tpu_torch.train import JointTrainer, Trainer
from meshvae_tpu_torch.train.crecon_driver import CreconTrainer

import torch_parallel_worker as W

# tests/test_parallel.py's TestCreconParallel: the VAE config at lr 1e-4
CRECON_CONFIG = dict(W.CONFIG, learning_rate=1e-4)
# TestJointParallel's weights of the three terms; dropout 0.2 for the
# step that draws its masks and noise
JOINT_CONFIG = dict(W.CONFIG, dropout=0.2, latent_split=2, sup_weight=1.0,
                    adv_weight=0.1, cls_weight=1.0)
STEPS = 3   # batches of an epoch: full, padded (mask 0 rows), full
SEEDS = {"dropout": 5, "shuffle": 9}


def ops_of(hier):
    """Every level block-sparse, so sp shards every Laplacian."""
    return build_operators(hier, "cpu", cheb_method="pallas", bsr_min_n=0)


def epoch_batches(n0: int) -> list:
    return [W.step_batch(n0, padded=(i == 1), seed=10 + i)
            for i in range(STEPS)]


def initial_states(hier) -> dict:
    """Seeded weights of the frozen VAE, the GCN and the joint model."""
    coarse = hier.levels[-1]
    return {
        "vae": MeshVAE(VAEConfig.from_config(W.CONFIG, coarse_verts=coarse),
                       generator=torch.Generator().manual_seed(0)
                       ).state_dict(),
        "gcn": ChebGCN(GCNConfig.from_config(CRECON_CONFIG,
                                             coarse_verts=coarse),
                       generator=torch.Generator().manual_seed(1)
                       ).state_dict(),
        "joint": build_joint_model(JOINT_CONFIG, coarse,
                                   generator=torch.Generator().manual_seed(2)
                                   ).state_dict(),
    }


def _crecon_trainer(dist, hier, ops, states):
    coarse = hier.levels[-1]
    vae = MeshVAE(VAEConfig.from_config(W.CONFIG, coarse_verts=coarse))
    vae.load_state_dict(states["vae"])
    gcn = ChebGCN(GCNConfig.from_config(CRECON_CONFIG, coarse_verts=coarse))
    gcn.load_state_dict(states["gcn"])
    return CreconTrainer(gcn, vae, ops, CRECON_CONFIG, device="cpu",
                         dist=dist)


def crecon_scenario(dist, hier, ops, states) -> dict:
    """A train epoch of STEPS steps and an eval epoch, through the per-step
    loop and through the scanned epoch (device reshuffle); the kernel
    calls of the first train step."""
    batches = epoch_batches(hier.levels[0])
    out = {}
    tr = _crecon_trainer(dist, hier, ops, states)
    with W.counted_calls() as calls:
        tr.train_step(tr.to_device(batches[0]))
    out["calls"] = calls
    tr = _crecon_trainer(dist, hier, ops, states)
    out["loop_train"] = tr.run_epoch(batches, train=True)
    out["loop_params"] = W.params_of(tr.model)
    out["loop_eval"] = tr.run_epoch(batches, train=False)
    tr = _crecon_trainer(dist, hier, ops, states)
    staged = tr.stage_batches(batches)
    shuffle = torch.Generator().manual_seed(SEEDS["shuffle"])
    out["scan_train"] = tr.run_epoch(staged, True, shuffle)
    out["scan_params"] = W.params_of(tr.model)
    out["scan_eval"] = tr.run_epoch(staged, train=False)
    out["vae_params"] = W.params_of(tr.vae)
    return out


def _joint_trainer(dist, hier, ops, states):
    model = build_joint_model(JOINT_CONFIG, hier.levels[-1])
    model.load_state_dict(states["joint"])
    return JointTrainer(model, ops, JOINT_CONFIG, device="cpu", dist=dist)


def joint_scenario(dist, hier, ops, states) -> dict:
    """A deterministic train step (z = mu, no dropout) on a full batch; a
    step with dropout 0.2 and the noise drawn from a seeded generator on a
    padded batch; the scanned eval of the epoch's batches."""
    n0 = hier.levels[0]
    zeros, ones = np.zeros((n0, 3), np.float32), np.ones((n0, 3), np.float32)
    batches = epoch_batches(n0)
    out = {}
    tr = _joint_trainer(dist, hier, ops, states)
    norm = tr.norm_to_device(zeros, ones)
    with W.counted_calls() as calls:
        packed = tr.train_step(tr.to_device(batches[0]), None, *norm)
    out["calls"] = calls
    out["metrics_full"] = W.unpack_metrics(packed)
    out["params_full"] = W.params_of(tr.model)
    tr = _joint_trainer(dist, hier, ops, states)
    gen = torch.Generator().manual_seed(SEEDS["dropout"])
    packed = tr.train_step(tr.to_device(batches[1]), gen, *norm)
    out["metrics_dropout"] = W.unpack_metrics(packed)
    out["params_dropout"] = W.params_of(tr.model)
    tr = _joint_trainer(dist, hier, ops, states)
    out["eval_avg"], out["eval_errors"] = tr.evaluate_scanned(
        tr.stage_batches(batches), *tr.norm_to_device(zeros, ones))
    return out


def scan_scenario(dist, hier, ops, states) -> dict:
    """Trainer.train_epoch_scanned_async over STEPS staged batches with the
    device reshuffle and dropout 0.2 from a seeded generator, then
    evaluate_scanned_async with the per-vertex errors."""
    n0 = hier.levels[0]
    zeros, ones = np.zeros((n0, 3), np.float32), np.ones((n0, 3), np.float32)
    config = dict(W.CONFIG, dropout=0.2)
    model = MeshVAE(VAEConfig.from_config(config,
                                          coarse_verts=hier.levels[-1]))
    model.load_state_dict(states["vae"])
    tr = Trainer(model, ops, config, device="cpu", dist=dist)
    staged = tr.stage_batches(epoch_batches(n0))
    norm = tr.norm_to_device(zeros, ones)
    packed = tr.train_epoch_scanned_async(
        staged, torch.Generator().manual_seed(SEEDS["dropout"]), *norm,
        shuffle_generator=torch.Generator().manual_seed(SEEDS["shuffle"]))
    out = {"train_avg": tr.finalize_train_metrics(packed),
           "params": W.params_of(tr.model)}
    out["eval_avg"], out["eval_errors"] = tr.finalize_eval_scanned(
        tr.evaluate_scanned_async(staged, *norm))
    return out


SCENARIOS = {"crecon": crecon_scenario, "joint": joint_scenario,
             "scan": scan_scenario}


def run_scenarios(dist, states_path: str | None = None) -> dict:
    hier = W.hierarchy()
    ops = ops_of(hier)
    states = (torch.load(states_path, weights_only=True) if states_path
              else initial_states(hier))
    return {name: fn(dist, hier, ops, states)
            for name, fn in SCENARIOS.items()}


def world_rank(dist, states_path: str, out_dir: str) -> None:
    """One rank of the spawned world: every scenario, saved to
    out_dir/rank{r}.pt."""
    out = run_scenarios(dist, states_path)
    out["dp_rank"], out["sp_rank"] = dist.dp_rank, dist.sp_rank
    torch.save(out, os.path.join(out_dir, f"rank{dist.rank}.pt"))
