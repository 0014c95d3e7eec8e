"""Distribution layer: a ("dp", "sp") world over torch.distributed
(counterpart of meshvae_tpu/parallel/sharding.py).

The JAX package drives every device from one controller over a Mesh with
axes ("dp", "sp"); the port runs one process per rank, PyTorch's idiom:

  * ``world = dp * sp`` ranks; rank r is (dp_rank, sp_rank) = divmod(r, sp).
    Every rank creates every sub-group in the same order: an ``sp`` group
    for each dp index (the ranks that hold the row shards of one batch
    slice) and a ``dp`` group for each sp index;
  * dp: each rank runs its rows of the global batch (``shard_batch``);
    parameters, optimizer state and normalisation are replicated
    (``replicate`` broadcasts rank 0's), the gradients are summed over the
    whole world (train/loop.py) and outputs all-gathered over dp
    (``fetch``);
  * sp: ``shard_operators`` gives every model (the VAE, crecon's GCN
    behind its frozen VAE, the joint model) and every cheb_method one
    layout, the JAX package's P("dp", "sp"): each level of at least
    ModelOperators.bsr_min_n vertices (the pallas hybrid's cutoff) is
    row-sharded, a block-sparse Laplacian as the rank's row shard
    (ops/bsr_shard.py, whose products all-gather the recurrence state
    over the sp group), an ELL or dense one as the rank's rows of it
    (ops/graph.py shard_graph_operator; ops/cheb.py propagates them the
    same way). Either way the level's activations hold only the rank's
    rows (a RowShard: rows [row0, row0 + rows_local) of the level padded
    to n_pad_global, the rows of the level's block-sparse shard, so every
    method places the same rows on a rank); ``shard_batch`` stages VERTEX_KEYS in those rows of level 0,
    the pools keep the rank's rows (each PoolOperator cut once), the loss
    and the pose error sum the rank's rows and then over sp, and
    ``fetch`` all-gathers a vertex-shaped output over sp before it goes
    to the host. Smaller levels, heads, latents and scalars stay whole on
    every rank. The JAX package places x by an even split of N and lets
    GSPMD move it; the port stages it in the conv shard's rows from the
    start ("staging in the consumer's layout",
    meshvae_tpu/train/loop.py:122-130).

The pool backward keeps its P^T kernel (pool_transpose) under any world,
on the input level's row shard of the CSR: the JAX package drops it there
(``_strip_pool_bsr``) because the TPU kernel has no sharding rule inside
the GSPMD graph, and runs P^T as ELL gathers. The two compute the same
products in another order, which the tests hold to the JAX package's mesh
path at their stated bars.

Backend (``choose_backend``): NCCL when every rank has a card of its own;
gloo on the CPU and when the ranks share one card (tests and the card's
smoke run only: validate.py refuses that on the command line). gloo takes
CUDA tensors for every collective used here (all_gather, all_reduce,
broadcast, barrier), checked on an H100 with torch 2.11, so nothing is
staged through host memory. Nothing falls back: a collective that fails
raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

TIMEOUT = datetime.timedelta(minutes=10)


class Comm:
    """One process group of the world and this rank's place in it.
    all_gather concatenates the ranks' tensors along dim 0 in group rank
    order; every call adds to the world's ``stats`` (calls, and the bytes
    this rank receives or, for all_reduce, contributes)."""

    def __init__(self, group, ranks: list[int], rank: int, stats: dict):
        self.group = group
        self.ranks = ranks
        self.size = len(ranks)
        self.rank = ranks.index(rank)
        self.stats = stats

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        self.stats["all_gather"] += 1
        self.stats["all_gather_bytes"] += t.numel() * t.element_size() * (
            self.size - 1)
        return torch.cat(parts, dim=dim)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the group."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
            self.stats["all_reduce"] += 1
            self.stats["all_reduce_bytes"] += t.numel() * t.element_size()
        return t


def choose_backend(device: str, local_rank: int = 0):
    """(backend, torch.device) of a rank: "cuda" gives each rank the card
    cuda:{local_rank} of its own and NCCL; a named card ("cuda:0") is
    shared by every local rank and gives gloo, as does "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return "nccl", resolve_device(f"cuda:{local_rank}")
    return "gloo", resolve_device(dev)


@dataclasses.dataclass
class World:
    """A rank's view of the ("dp", "sp") world (the counterpart of
    make_device_mesh's Mesh)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: str
    world: Comm
    dp_group: Comm   # the dp ranks of this rank's sp index
    sp_group: Comm   # the sp ranks of this rank's dp index
    stats: dict

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0


def make_world(dp: int, sp: int, device, backend: str) -> World:
    """The World over an initialized default process group of dp * sp
    ranks: its sub-groups, created by every rank in the same order."""
    size, rank = dist.get_world_size(), dist.get_rank()
    if size != dp * sp:
        raise ValueError(f"a {dp} x {sp} world needs {dp * sp} ranks, the "
                         f"process group has {size}")
    stats = {"all_gather": 0, "all_gather_bytes": 0, "all_reduce": 0,
             "all_reduce_bytes": 0}
    dp_group = sp_group = None
    for d in range(dp):
        ranks = [d * sp + s for s in range(sp)]
        g = dist.new_group(ranks)
        if rank in ranks:
            sp_group = Comm(g, ranks, rank, stats)
    for s in range(sp):
        ranks = [d * sp + s for d in range(dp)]
        g = dist.new_group(ranks)
        if rank in ranks:
            dp_group = Comm(g, ranks, rank, stats)
    return World(dp=dp, sp=sp, rank=rank, device=torch.device(device),
                 backend=backend,
                 world=Comm(dist.group.WORLD, list(range(size)), rank, stats),
                 dp_group=dp_group, sp_group=sp_group, stats=stats)


def init_world(dp: int, sp: int, rank: int, init_method: str,
               device="cuda", local_rank: int | None = None,
               timeout: float | None = None) -> World:
    """init_process_group (tcp:// or env://) with the backend that
    choose_backend picks for `device`, then make_world. Prints the
    choice. `timeout` (seconds) bounds every collective (default 10
    minutes)."""
    local_rank = rank if local_rank is None else local_rank
    backend, dev = choose_backend(str(device), local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=dp * sp, rank=rank,
        timeout=(TIMEOUT if timeout is None
                 else datetime.timedelta(seconds=timeout)))
    world = make_world(dp, sp, dev, backend)
    print(f"rank {rank}: dp {world.dp_rank}/{dp} sp {world.sp_rank}/{sp} "
          f"backend {backend} device {dev}", flush=True)
    return world


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def initialize_multihost(dp: int, sp: int, device="cuda",
                         coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> World:
    """One process per rank across hosts. With coordinator_address
    ("host:port"), num_processes and process_id the world meets over
    tcp://; with them unset it reads the env:// variables a launcher such
    as torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), as
    jax.distributed.initialize auto-detects. The rank's card is
    cuda:{LOCAL_RANK}."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        if num_processes != dp * sp:
            raise ValueError(f"num_processes {num_processes} must equal "
                             f"data_parallel x seq_parallel = {dp * sp}")
        return init_world(dp, sp, process_id,
                          f"tcp://{coordinator_address}", device, local_rank)
    size = int(os.environ.get("WORLD_SIZE", dp * sp))
    if size != dp * sp:
        raise ValueError(f"WORLD_SIZE {size} must equal data_parallel x "
                         f"seq_parallel = {dp * sp}")
    return init_world(dp, sp, int(os.environ["RANK"]), "env://", device,
                      local_rank)


def is_primary(world: World | None) -> bool:
    """True on the rank that owns artifact writes (checkpoints, history,
    log, norm stats, .obj dumps): rank 0, or the only process."""
    return world is None or world.rank == 0


def sync_processes(world: World | None) -> None:
    """Barrier over the world (no-op in one process): orders a primary-only
    write before the other ranks read it back."""
    if world is not None and world.size > 1:
        dist.barrier()


VERTEX_KEYS = ("x", "original")  # batch arrays carrying a vertex dim


def vertex_dim_shardable(ops, world: World | None) -> bool:
    """True when a batch's vertex axis is staged as the rank's rows: sp > 1
    and level 0 is row-sharded (`ops` from shard_operators, level 0 at
    least ops.bsr_min_n vertices)."""
    return (world is not None and world.sp > 1
            and ops.lap[0].rows is not None)


def vertex_rows(ops, world: World | None):
    """The level-0 RowShard that vertex-shaped arrays are staged in (None
    when vertex_dim_shardable is false)."""
    return ops.lap[0].rows if vertex_dim_shardable(ops, world) else None


def vertex_mean(err: torch.Tensor, rows=None) -> torch.Tensor:
    """[B, N] per-vertex values -> [B] means over the N vertices; with
    `rows` (vertex_rows) err holds the rank's rows [B, rows_local]: those
    below N are summed, then over sp."""
    if rows is None:
        return err.mean(dim=-1)
    return rows.group.all_reduce_(err[:, :rows.count()].sum(dim=-1)) / rows.n


def vertex_max(err: torch.Tensor, rows=None) -> torch.Tensor:
    """[B] maxima over the N vertices of non-negative per-vertex values,
    in vertex_mean's layout; a zero column keeps the maximum of a rank
    without vertices defined."""
    if rows is None:
        return err.max(dim=-1).values
    own = torch.cat([err[:, :rows.count()], err.new_zeros(err.shape[0], 1)],
                    dim=1).amax(dim=-1)
    return rows.group.all_gather(own[None]).amax(dim=0)


def shard_batch(batch: dict, world: World | None, rows=None) -> dict:
    """The rank's rows of a global host batch: rows [dp_rank * B / dp,
    (dp_rank + 1) * B / dp) of every array (B % dp == 0, validate.py) and,
    with `rows` (vertex_rows), the rank's vertex rows of VERTEX_KEYS
    ([B, N, 3] -> [B / dp, rows_local, 3], zero past N): staged in the
    consumer's layout, as the JAX package's P("dp", "sp")."""
    if world is None or (world.dp == 1 and rows is None):
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        b = v.shape[0] // world.dp
        v = v[world.dp_rank * b:(world.dp_rank + 1) * b]
        out[k] = (rows.local(torch.from_numpy(v), dim=1).numpy()
                  if rows is not None and k in VERTEX_KEYS else v)
    return out


def replicate(tensors, world: World | None) -> None:
    """Broadcast rank 0's values of `tensors` (in place) to every rank."""
    if world is None or world.size == 1:
        return
    for t in tensors:
        dist.broadcast(t.data, src=0)


def fetch(t: torch.Tensor, world: World | None, dim: int = 0,
          rows=None) -> np.ndarray:
    """A dp-sharded output (this rank's rows along `dim`) as the full host
    array: all-gathered over the dp group (each rank gets it; the primary
    writes it). With `rows` (a RowShard) the vertex dim, dim + 1, holds
    the rank's vertex rows: they are all-gathered over sp first, to the
    level's n."""
    if rows is not None:
        t = rows.gather(t, dim=dim + 1)
    if world is not None and world.dp > 1:
        t = world.dp_group.all_gather(t, dim=dim)
    return t.cpu().numpy()


def shard_operators(ops, world: World | None):
    """ModelOperators in sp's row layout (module docstring) when sp > 1:
    every level of at least ops.bsr_min_n vertices row-sharded, a
    block-sparse Laplacian (lap, a finest lap_final) as this rank's row
    shard, an ELL or dense one as the rank's rows of it (the same
    operator object is sharded once); the embedded lap_final takes level
    0's rows, its corner kept in its own layout (a block-sparse corner as
    its own row shard, an ELL or dense one whole); each pool whose input or output level is
    row-sharded is cut once (graph.shard_pool_operator)."""
    if world is None or world.sp == 1:
        return ops
    from ..ops.bsr_shard import RowShard, shard_block_sparse
    from ..ops.graph import shard_graph_operator, shard_pool_operator

    sp, rank, group = world.sp, world.sp_rank, world.sp_group
    done = {}

    def convert(op):
        if id(op) not in done:
            if op.bsr is not None:
                sbsr = shard_block_sparse(op.bsr, sp, rank)
                done[id(op)] = dataclasses.replace(
                    op, bsr=None, bsr_sp=sbsr, sp_group=group,
                    row_shard=RowShard.of(sbsr, group))
            elif op.active_n == op.n and op.n >= ops.bsr_min_n:
                done[id(op)] = shard_graph_operator(
                    op, RowShard.for_level(op.n, sp, rank, group))
            else:
                done[id(op)] = op
        return done[id(op)]

    lap = tuple(convert(o) for o in ops.lap)
    level = [op.rows for op in lap]
    final = ops.lap_final
    if final.active_n == final.n:
        final = convert(final)
    elif level[0] is not None:
        if final.bsr is not None:
            final = dataclasses.replace(
                final, bsr=None, sp_group=group,
                bsr_sp=shard_block_sparse(final.bsr, sp, rank))
        final = dataclasses.replace(final, row_shard=level[0])
    return dataclasses.replace(
        ops, lap=lap, lap_final=final,
        down=tuple(shard_pool_operator(p, level[i], level[i + 1])
                   for i, p in enumerate(ops.down)),
        up=tuple(shard_pool_operator(p, level[i + 1], level[i])
                 for i, p in enumerate(ops.up)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(rank: int, fn, dp: int, sp: int, init_method: str,
              device: str, args: tuple, timeout: float):
    # CPU ranks share the host's cores: each takes its share of them for
    # its intra-op threads (more spin against each other in every product)
    threads = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (dp * sp)))
    world = init_world(dp, sp, rank, init_method, device, timeout=timeout)
    try:
        result = fn(world, *args)
        sync_processes(world)
        return result
    finally:
        close_world()
        torch.set_num_threads(threads)


def _spawned(index: int, *args):
    _run_rank(index + 1, *args)


def spawn_local(fn, dp: int, sp: int, device="cuda", args: tuple = (),
                timeout: float = 600.0):
    """Run fn(world, *args) on dp * sp local ranks meeting over tcp:// on a
    free localhost port: rank 0 in this process (it keeps stdin and
    stdout), ranks 1.. in spawned processes. Returns rank 0's result. A
    rank that raises, or a world still running after `timeout` seconds
    (also the collectives' timeout), ends every rank and raises here. fn
    must be a module-level function (the spawned ranks import it)."""
    import time

    import torch.multiprocessing as mp

    n = dp * sp
    run = (fn, dp, sp, f"tcp://localhost:{free_port()}", str(device), args,
           timeout)
    ctx = (mp.start_processes(_spawned, args=run, nprocs=n - 1, join=False,
                              start_method="spawn") if n > 1 else None)
    try:
        result = _run_rank(0, *run)
        deadline = time.monotonic() + timeout
        while ctx is not None and not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{dp} x {sp} world still running after "
                                   f"{timeout} s")
        return result
    finally:
        for p in (ctx.processes if ctx is not None else ()):
            if p.is_alive():
                p.terminate()
            p.join()
