"""The port's side of tests/test_torch_parallel.py: shapes, inputs and the
scenarios that one rank of a ("dp", "sp") world runs. It imports torch,
numpy and the port only, because the ranks of a spawned gloo world start
from a fresh interpreter and import it; the test process calls the same
scenarios with dist=None for the single-process reference.

``ThreadComm`` stands in for a process group inside one process: the sp
ranks of a stacked-shard test run as threads that meet at a barrier, so the
sharded products, their autograd Functions and the sharded conv run
in-process over every shard."""
import contextlib
import os
import threading

import numpy as np
import torch

from meshvae_tpu_torch.infer.serve import MeshServer
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy
from meshvae_tpu_torch.models import MeshVAE, VAEConfig, build_operators
from meshvae_tpu_torch.ops import bsr_shard, bsr_spmm, cheb
from meshvae_tpu_torch.train import Trainer, unpack_metrics

# tests/test_parallel.py's shapes; every level block-sparse (bsr_min_n 0)
CONFIG = {
    "num_conv_filters": [8, 16, 16], "polygon_order": [3, 3, 3],
    "n_layers": 2, "num_hidden": 32, "num_style": 8, "num_classes": 2,
    "dropout": 0.0, "learning_rate": 1e-3, "weight_decay": 5e-4,
    "cheb_method": "pallas", "matmul_precision": "highest",
}
FACTORS = [2, 2]
BATCH = 8
SERVE_MESHES = 12   # two chunks of 8


def grid_mesh(n: int = 8, jitter: float = 0.05, seed: int = 0) -> TriMesh:
    """tests/conftest.py make_grid_mesh, as a port TriMesh."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float64),
                         np.arange(n, dtype=np.float64))
    z = jitter * rng.standard_normal((n, n)) if jitter else np.zeros((n, n))
    v = np.stack([xs.ravel(), ys.ravel(), z.ravel()], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append((a, a + 1, a + n))
            faces.append((a + 1, a + n + 1, a + n))
    return TriMesh(v, np.array(faces, dtype=np.int64))


def hierarchy():
    return build_hierarchy(grid_mesh(), FACTORS)


def model_and_ops(hier, params_path: str, config=CONFIG, device="cpu"):
    cfg = VAEConfig.from_config(config, coarse_verts=hier.levels[-1])
    model = MeshVAE(cfg)
    model.load_state_dict(torch.load(params_path, weights_only=True))
    ops = build_operators(hier, device, cheb_method="pallas", bsr_min_n=0)
    return model, ops


def step_batch(n0: int, padded: bool, seed: int = 0) -> dict:
    """tests/test_parallel.py's batch; padded: its last two rows are batch
    padding (mask 0)."""
    rng = np.random.default_rng(seed)
    b = BATCH
    batch = {
        "x": rng.standard_normal((b, n0, 3)).astype(np.float32),
        "label": rng.integers(0, 2, b).astype(np.int32),
        "r": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
        "s": np.ones(b, np.float32),
        "m": np.zeros((b, 1, 3), np.float32),
        "mask": np.ones(b, np.float32),
        "index": np.arange(b),
    }
    if padded:
        batch["mask"][-2:] = 0.0
    return batch


@contextlib.contextmanager
def counted_calls():
    """The (n_pad, n_pad_cols) of every Laplacian kernel call made through
    ops/cheb.py and ops/bsr_shard.py inside the block, in order."""
    calls = []
    real = bsr_spmm.bsr_grouped_spmm

    def counted(bsr, *args, **kwargs):
        calls.append((bsr.n_pad, bsr.n_pad_cols))
        return real(bsr, *args, **kwargs)

    cheb.bsr_grouped_spmm = bsr_shard.bsr_grouped_spmm = counted
    try:
        yield calls
    finally:
        cheb.bsr_grouped_spmm = bsr_shard.bsr_grouped_spmm = real


def params_of(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def flax_tree(state: dict) -> dict:
    """The port's VAE state_dict as the JAX package's param tree (the
    inverse of params_from_flax): Chebyshev weight and bias as they are, a
    Linear weight [out, in] as a Dense kernel [in, out]."""
    tree = {}
    for name, v in state.items():
        layer, leaf = name.rsplit(".", 1)
        a = v.numpy()
        if leaf == "weight" and not layer.startswith("cheb_"):
            leaf, a = "kernel", a.T
        tree.setdefault(layer, {})[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def train_scenario(dist, params_path: str) -> dict:
    """Deterministic steps (no dropout, z = mu) on a full and then a padded
    batch, one step with dropout 0.2 drawn from a seeded generator, and
    evaluate(collect_meshes=True) over both batches."""
    hier = hierarchy()
    n0 = hier.levels[0]
    zeros, ones = np.zeros((n0, 3), np.float32), np.ones((n0, 3), np.float32)
    out = {}
    model, ops = model_and_ops(hier, params_path)
    trainer = Trainer(model, ops, CONFIG, device="cpu", dist=dist)
    mean, std = trainer.norm_to_device(zeros, ones)
    for tag, padded in (("full", False), ("padded", True)):
        gathers = dist.stats["all_gather"] if dist is not None else 0
        with counted_calls() as calls:
            packed = trainer.train_step(
                trainer.to_device(step_batch(n0, padded)), None, mean, std)
        out[f"calls_{tag}"] = calls
        out[f"gathers_{tag}"] = (dist.stats["all_gather"] - gathers
                                 if dist is not None else 0)
        out[f"metrics_{tag}"] = unpack_metrics(packed)
        out[f"params_{tag}"] = params_of(trainer.model)
    # the staged x: the rank's dp rows and, in the row layout, its level-0
    # vertex rows
    shard = trainer.vertex_shard
    out["x_staged"] = trainer.to_device(step_batch(n0, False))["x"].numpy()
    out["x_shard"] = (None if shard is None else
                      (shard.row0, shard.rows_local, shard.n))
    loader = [step_batch(n0, False, seed=1), step_batch(n0, True, seed=2)]
    avg, errors, meshes = trainer.evaluate(loader, zeros, ones,
                                           collect_meshes=True)
    out.update(eval_avg=avg, eval_errors=errors, eval_meshes=meshes)

    config = dict(CONFIG, dropout=0.2)
    model, ops = model_and_ops(hier, params_path, config)
    trainer = Trainer(model, ops, config, device="cpu", dist=dist)
    gen = torch.Generator().manual_seed(5)
    packed = trainer.train_step(trainer.to_device(step_batch(n0, False)),
                                gen, mean, std)
    out["metrics_dropout"] = unpack_metrics(packed)
    out["params_dropout"] = params_of(trainer.model)
    if dist is not None:
        out["stats"] = dict(dist.stats)
    return out


def serve_scenario(dist, params_path: str, data_dir: str) -> list:
    hier = hierarchy()
    model, ops = model_and_ops(hier, params_path)
    n0 = hier.levels[0]
    server = MeshServer(model.eval(), ops, np.zeros((n0, 3), np.float32),
                        np.ones((n0, 3), np.float32),
                        template=hier.vertices[0], faces=hier.faces[0],
                        batch_size=BATCH, save_meshes=False, device="cpu",
                        dist=dist)
    paths = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                   if f.endswith(".obj"))
    try:
        return server.handle(paths)
    finally:
        server.close()


def world_rank(dist, params_path: str, data_dir: str, out_dir: str) -> None:
    """One rank of the spawned world: every scenario, saved to
    out_dir/rank{r}.pt."""
    out = {"train": train_scenario(dist, params_path),
           "serve": serve_scenario(dist, params_path, data_dir),
           "dp_rank": dist.dp_rank, "sp_rank": dist.sp_rank}
    torch.save(out, os.path.join(out_dir, f"rank{dist.rank}.pt"))


class ThreadComm:
    """The sp group of `size` threads in one process (see the module
    docstring): all_gather concatenates the threads' tensors in rank
    order, all_reduce_ sums them in rank order."""

    def __init__(self, size: int):
        self.size = size
        self._slots = [None] * size
        self._barrier = threading.Barrier(size)

    def member(self, rank: int) -> "ThreadComm.Member":
        return ThreadComm.Member(self, rank)

    def _exchange(self, rank: int, t: torch.Tensor) -> list:
        self._slots[rank] = t
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()  # nobody overwrites a slot still being read
        return parts

    class Member:
        def __init__(self, comm, rank: int):
            self.comm, self.rank, self.size = comm, rank, comm.size

        def all_gather(self, t, dim: int = 0):
            return torch.cat(self.comm._exchange(self.rank, t), dim=dim)

        def all_reduce_(self, t):
            total = self.comm._exchange(self.rank, t.clone())
            acc = total[0].clone()
            for p in total[1:]:
                acc += p
            t.copy_(acc)
            return t


def run_threads(fn, size: int) -> list:
    """fn(rank, comm_member) on `size` threads; their results in rank
    order (a thread's exception is raised here)."""
    comm = ThreadComm(size)
    results, errors = [None] * size, []

    def body(r):
        try:
            results[r] = fn(r, comm.member(r))
        except BaseException as exc:  # re-raised in the caller below
            errors.append(exc)
            comm._barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a thread rank did not finish")
    return results
