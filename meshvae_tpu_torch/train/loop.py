"""Train and eval steps, the per-step epoch loop and the scanned epoch
(counterpart of meshvae_tpu/train/loop.py; one process, or one rank of a
("dp", "sp") world).

  * one train step is forward, loss, backward, a torch.optim.Adam update
    with L2 added to the gradient before the moments (optax's
    add_decayed_weights -> scale_by_adam -> learning rate, not AdamW), and
    the original-pose per-vertex error on the device; its metrics come
    back as one packed tensor, pulled once;
  * the eval step adds the sex-change counterfactual: decode the same
    latent with the opposite label, re-encode, re-classify;
  * the epoch-granular step LR schedule is ``lr_for_epoch`` +
    ``set_learning_rate``.

With compute_dtype=bfloat16 the model computes in bf16 (models/vae.py)
while the parameters, their gradients and Adam's moments stay float32, and
the loss, the metrics and the pose error are float32.

In a world (parallel/sharding.py), as the JAX package's GSPMD step under a
mesh: each rank runs its dp rows of the global batch, with the operators
row-sharded over sp in sp's one layout (parallel/sharding.py), with x
and the activations at row-sharded levels as the rank's vertex rows, the
NLL and the pose error summed over them and then over sp; the loss and the
packed
metrics are masked means over the global batch (the mask sums are summed
over dp before the division);
the dropout masks and the noise are drawn for the global batch and sliced
(models/vae.py ``rows``); the gradients are summed over the whole world in
one all-reduce and scaled by 1/sp (the sp ranks of a dp slice hold the
same gradient), so every replica applies the same bits; the metrics, the
eval sums and the eval outputs are summed or gathered over dp.

The scanned epoch (the JAX package's ``scan_epoch``, ``lax.scan`` over a
staged epoch): ``stage_batches`` uploads a loader's batches once as
[S, B, ...] device tensors; ``train_epoch_scanned_async`` draws the
epoch's permutation of the flat S * B sample grid on the device (padding
samples ride along, as ``reshuffle_batches``), and each step gathers its
rows through a device-side step index and writes its packed metrics into
row i of an [S, 6] device tensor, pulled once per epoch (graphs.HostCopy)
by ``finalize_train_metrics``; ``evaluate_scanned_async`` does the same for
the eval step in three variants (light: the scalars only; errors; collect:
the test path's meshes). On a card with one process the steps are CUDA
graphs (train/graphs.py) replayed with no host work in between; on the CPU
and in a world (whose collectives are not captured) the same step
functions run eagerly. Adam on CUDA is capturable with a device-tensor lr
(``make_optimizer``), which ``set_learning_rate`` fills in place. Each
scanned step stamps the boundaries of its phases into an [S, P] buffer
pulled with the epoch's outputs, and each finalized epoch leaves a record
in ``phases.RECORDS``; under a profiler the loop's calls are host spans
(train/phases.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..mesh.procrustes import apply_inverse_similarity
from ..models.losses import vae_loss
from ..parallel.sharding import (VERTEX_KEYS, fetch, replicate, shard_batch,
                                 shard_operators, vertex_mean, vertex_rows)
from . import phases
from .graphs import HostCopy, StepGraph, map_tensors

# order of the packed per-step metrics returned by the train step
METRIC_NAMES = ("loss", "kld", "rec_loss", "error", "correct", "count")


def unpack_metrics(arr) -> dict:
    arr = np.asarray(arr, dtype=np.float64).reshape(-1)
    return dict(zip(METRIC_NAMES, arr))


def lr_for_epoch(epoch: int, base_lr: float, learning_rates: list[float],
                 learning_rates_epochs: list[float]) -> float:
    """Reference step schedule: the last threshold the epoch exceeds wins."""
    lr = base_lr
    for i, threshold in enumerate(learning_rates_epochs):
        if epoch > threshold:
            lr = learning_rates[i]
    return lr


def reshuffle_batches(batches: dict, perm) -> dict:
    """Re-draw a staged epoch's batch composition: flatten the [S, B]
    sample grid, gather by perm, restack. Padding samples (mask 0) ride
    along wherever they land. The scanned epoch does not build this
    epoch: each step gathers its own row of it (Trainer._scan_batch), so
    the staged data is held once."""
    steps, bs = batches["mask"].shape[:2]

    def gather(a):
        flat = a.reshape((steps * bs,) + tuple(a.shape[2:]))
        return flat.index_select(0, perm).reshape(
            (steps, bs) + tuple(a.shape[2:]))

    return {k: gather(v) for k, v in batches.items()}


def stage_batch_arrays(loader, device, keys: tuple,
                       with_index: bool = False, rows=None):
    """A loader's batches uploaded once as stacked [S, B, ...] tensors on
    `device` (None for an empty loader): "label" as int64, the rest as
    float32. "mask" is also kept on the host as the numpy "mask_host", and
    with_index the dataset indices as a host "index" [S, B]. With `rows`
    (parallel.vertex_rows) VERTEX_KEYS are staged as the rank's vertex
    rows [S, B, rows_local, 3], the consumer's layout (the JAX package's
    P(None, "dp", "sp"))."""
    batch_list = list(loader)
    if not batch_list:
        return None
    stacked = {k: np.stack([b[k] for b in batch_list]) for k in keys
               if k in batch_list[0]}
    if rows is not None:
        stacked.update({k: rows.local(torch.from_numpy(v), dim=2)
                        for k, v in stacked.items() if k in VERTEX_KEYS})
    staged = {k: torch.as_tensor(v).to(
        device, torch.long if k == "label" else torch.float32)
        for k, v in stacked.items()}
    staged["mask_host"] = stacked["mask"]
    if with_index:
        staged["index"] = np.stack([b["index"] for b in batch_list])
    return staged


# param-group keys that follow the optimizer's device, never a saved state
_DEVICE_POLICY = ("capturable", "foreach", "fused", "differentiable")


def _merge_groups(optimizer, state_dict):
    """load_state_dict pre-hook: each saved param group over this
    optimizer's (a JAX checkpoint's group holds only lr), keeping this
    optimizer's device policy (a checkpoint written on the card loads on
    the CPU, and one from the CPU stays capturable on the card)."""
    groups = []
    for group, saved in zip(optimizer.param_groups,
                            state_dict["param_groups"]):
        fresh = {k: v for k, v in group.items() if k != "params"}
        policy = {k: group[k] for k in _DEVICE_POLICY if k in group}
        groups.append({**fresh, **saved, **policy})
    return dict(state_dict, param_groups=groups)


def _lr_to_device(optimizer) -> None:
    """load_state_dict post-hook on CUDA: the loaded lr (a float or a
    tensor) into a fresh 0-d tensor on the parameters' device."""
    for group in optimizer.param_groups:
        group["lr"] = torch.full((), float(group["lr"]),
                                 device=group["params"][0].device)


def make_optimizer(params, learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: the same update as the JAX package's optax chain
    add_decayed_weights(wd) -> scale_by_adam(0.9, 0.999, 1e-8) -> lr.

    On CUDA it is capturable (a CUDA graph can hold its step) and lr is a
    0-d device tensor that set_learning_rate fills in place, so a captured
    step reads each epoch's rate; a loaded state dict's lr (a float in the
    checkpoints) goes into a new such tensor. On the CPU lr is a float."""
    params = list(params)
    if not params or params[0].device.type != "cuda":
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=weight_decay)
    else:
        lr = torch.full((), float(learning_rate), device=params[0].device)
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay, capturable=True)
        opt.register_load_state_dict_post_hook(_lr_to_device)
    opt.register_load_state_dict_pre_hook(_merge_groups)
    return opt


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def _host(x) -> np.ndarray:
    """A pulled array as numpy: HostCopy (waited for), tensor or array."""
    if isinstance(x, HostCopy):
        x = x.wait()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class _Scan:
    """What the steps of one staged epoch read and write: the staged
    [S, B, ...] tensors flattened to [S * B, ...], the epoch's sample
    order ``perm`` [S * B] (step i takes rows perm[i * B:(i + 1) * B]),
    the step index [1], the normalisation, the [S, ...] output rows
    ``outs``, the phase marks over ``outs["stamps"]`` (phases.unmarked
    without them), the step function and its graph (None when steps run
    eagerly). Built once per staged epoch and kind of step."""

    def __init__(self, kind: str, staged: dict, outs: dict, device,
                 keys: tuple, slots: tuple):
        self.kind = kind
        self.staged = staged
        self.steps, self.batch = staged["mask"].shape[:2]
        n = self.steps * self.batch
        self.flat = {k: staged[k].reshape((n,) + tuple(staged[k].shape[2:]))
                     for k in keys}
        self.perm = torch.arange(n, device=device)
        self.step = torch.zeros(1, dtype=torch.long, device=device)
        self.norm = None
        self.outs = outs
        self.mark = (phases.Marks(outs["stamps"], self.step, slots)
                     if "stamps" in outs else phases.unmarked)
        self.run = None
        self.graph = None
        self.generator = None


# the eval outputs with a vertex dim (the row layout gathers them over sp)
_VERTEX_OUTS = ("errors", "recon_orig", "oppo_orig")


class Trainer:
    """Owns one (model, operators, optimizer) triple on one device.

    Batches are the host dicts of data.BatchIterator (numpy); ``to_device``
    moves the keys a step reads (in a world: the rank's dp rows).
    Randomness (dropout masks, the reparameterisation noise) comes from the
    torch.Generator the caller passes, which must live on the trainer's
    device. With ``dist`` (a parallel.World) the trainer runs on the
    world's device and the operators are sharded for its sp group in sp's
    row layout, where x, the normalisation, the activations at
    row-sharded levels, recon (and the classifiers' difference features)
    and the per-vertex errors are the rank's rows (``vertex_shard``, the
    level-0 RowShard of parallel.vertex_rows; None when level 0 is
    whole).

    ``graphs`` (True on a card in one process) makes the scanned epoch's
    steps CUDA graphs; set it False to run the same steps eagerly. The
    scanned steps stamp their phases (train/phases.py).

    Subclasses (train/joint.py) swap the objective by overriding
    ``_forward_loss`` and surface model-specific eval metrics through
    ``extra_scalar_names`` (rate names) and ``_extra_scalars(aux)`` (the
    matching correct counts): they follow the packed eval scalars and come
    back as name = count / total in the eval averages, and so in
    history{fold}.json. ``sub_phases`` (name -> (first mark, last mark),
    train/phases.py) times parts of the train step's phases by marks that
    a subclass's objective stamps: ``_forward_loss`` gets the step's mark
    to stamp those that are no slot."""

    BATCH_KEYS = ("x", "label", "r", "s", "m", "mask")
    extra_scalar_names: tuple = ()
    sub_phases: dict = {}

    def _extra_scalars(self, aux: dict) -> list:
        return []

    def __init__(self, model, ops, config: dict, device="cuda", dist=None):
        self.dist = dist
        self.device = dist.device if dist is not None else resolve_device(
            device)
        self.model = model.to(self.device)
        self.ops = shard_operators(ops, dist)
        self.vertex_shard = vertex_rows(self.ops, dist)
        self.config = config
        self.num_classes = int(config["num_classes"])
        self.optimizer = make_optimizer(self.model.parameters(),
                                        float(config["learning_rate"]),
                                        float(config["weight_decay"]))
        self.graphs = self.device.type == "cuda" and (dist is None
                                                     or dist.size == 1)
        self._scans: dict[str, _Scan] = {}

    def step_mode(self) -> str:
        """How the scanned epoch runs its steps, for the run log."""
        if self.graphs:
            return "CUDA graphs of the train and eval steps"
        if self.dist is not None and self.dist.size > 1:
            return ("eager steps: a world's collectives are not captured "
                    "in CUDA graphs")
        return f"eager steps on {self.device}"

    def reset_optimizer(self, state: dict | None = None) -> None:
        """A fresh Adam over the model's parameters at the config's lr and
        decay, loaded from `state` when given (make_optimizer's hooks:
        missing group keys keep the fresh values, lr may be a float)."""
        self.optimizer = make_optimizer(self.model.parameters(),
                                        float(self.config["learning_rate"]),
                                        float(self.config["weight_decay"]))
        if state is not None:
            self.optimizer.load_state_dict(state)

    def snapshot(self) -> dict:
        """On-device copy of the model's and Adam's state, {"model":
        state_dict, "optimizer": Adam state dict}: the epoch pipeline
        checkpoints from it one epoch late, after the next epoch's steps
        have updated the live tensors in place."""
        clone = lambda t: t.detach().clone()
        return {"model": map_tensors(clone, self.model.state_dict()),
                "optimizer": map_tensors(clone, self.optimizer.state_dict())}

    def init_params(self, seed: int) -> dict:
        """Fresh weights drawn from `seed` (the init distributions of the
        trainer's model class, ``model.fresh``) and fresh Adam moments;
        returns the state_dict."""
        fresh = self.model.fresh(torch.Generator().manual_seed(seed))
        self.model.load_state_dict(fresh.state_dict())
        replicate(self.model.state_dict().values(), self.dist)
        lr = float(self.optimizer.param_groups[0]["lr"])
        self.reset_optimizer()
        set_learning_rate(self.optimizer, lr)
        return self.model.state_dict()

    def to_device(self, batch: dict) -> dict:
        batch = shard_batch({k: batch[k] for k in self.BATCH_KEYS}, self.dist,
                            self.vertex_shard)
        out = {}
        for k in self.BATCH_KEYS:
            t = torch.as_tensor(np.asarray(batch[k]))
            t = t.long() if k == "label" else t.float()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def norm_to_device(self, norm_mean, norm_std):
        """Normalisation statistics [N, 3] (numpy or tensors) on the
        device as the steps read them: the rank's vertex rows in the row
        layout. The scanned epoch takes them in this form (the driver
        converts them once per fold); train_epoch and evaluate convert
        the [N, 3] statistics they are given."""
        out = tuple(torch.as_tensor(a, dtype=torch.float32,
                                    device=self.device)
                    for a in (norm_mean, norm_std))
        shard = self.vertex_shard
        if shard is None:
            return out
        return tuple(shard.local(t, dim=0) for t in out)

    # ------------------------------------------------------------------
    def _dp_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the dp group (in place; t itself in one process)."""
        if self.dist is not None:
            self.dist.dp_group.all_reduce_(t)
        return t

    def _denominator(self, mask: torch.Tensor) -> torch.Tensor:
        """max(global mask sum, 1): the masked means' denominator."""
        return torch.clamp(self._dp_sum_(mask.sum()), min=1.0)

    def _rows(self, x: torch.Tensor, train: bool):
        """The model's ``rows`` (models/vae.py): this rank's dp rows of the
        global batch when a dp world trains, else None."""
        if train and self.dist is not None and self.dist.dp > 1:
            b = x.shape[0]
            return (self.dist.dp_rank * b, self.dist.dp * b)
        return None

    def _forward_loss(self, batch: dict, train: bool,
                      generator: torch.Generator | None,
                      mark=phases.unmarked):
        """(loss, out, aux, y, denom) of the model on a device batch: the
        objective the steps differentiate and report. `mark` is the train
        step's, for the marks of a subclass's ``sub_phases``."""
        x = batch["x"]
        y = F.one_hot(batch["label"], self.num_classes).to(x.dtype)
        out = self.model(x, y, self.ops, train=train, generator=generator,
                         rows=self._rows(x, train))
        denom = self._denominator(batch["mask"])
        loss, aux = vae_loss(x, out["recon"], out["mu"], out["logvar"], y,
                             out["y_hat"], mask=batch["mask"], denom=denom,
                             shard=self.vertex_shard)
        return loss, out, aux, y, denom

    def _reduce_gradients(self) -> None:
        """Sum every gradient over the world in one all-reduce, scaled by
        1/sp: the result is the single-process gradient, the same bits on
        every rank."""
        if self.dist is None or self.dist.size == 1:
            return
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        self.dist.world.all_reduce_(flat)
        if self.dist.sp > 1:
            flat.mul_(1.0 / self.dist.sp)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p))
            offset += n

    @torch.no_grad()
    def _pose_error(self, recon, batch, norm_mean, norm_std):
        """Denormalize + inverse Procrustes + per-vertex euclidean error.
        The ground truth is recomputed from x through the same transforms
        (the dataset's original is aligned @ R * s + m with aligned =
        x * std + mean). Returns (recon_orig [B, N, 3], err [B, N])."""
        def to_orig(t):
            return apply_inverse_similarity(t * norm_std + norm_mean,
                                            batch["r"], batch["s"],
                                            batch["m"])
        recon_orig = to_orig(recon)
        err = torch.sqrt(torch.sum((recon_orig - to_orig(batch["x"])) ** 2,
                                   dim=-1))
        return recon_orig, err

    def train_step(self, batch: dict, generator: torch.Generator | None,
                   norm_mean: torch.Tensor, norm_std: torch.Tensor,
                   mark=phases.unmarked) -> torch.Tensor:
        """One update from a device batch; returns the packed metrics
        [6] (METRIC_NAMES) on the device. The parameters' .grad hold this
        step's gradients afterwards. generator None makes the step
        deterministic (no dropout, z = mu), for gradient checks. `mark`
        (the scanned epoch's phases.Marks) is called after the loss, the
        backward and the update, and by the objective for the marks of
        its ``sub_phases``."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, out, aux, _, denom = self._forward_loss(
            batch, generator is not None, generator, mark)
        mark("forward")
        loss.backward()
        self._reduce_gradients()
        mark("backward")
        self.optimizer.step()
        mark("optimizer")
        with torch.no_grad():
            mask = batch["mask"]
            _, err = self._pose_error(out["recon"], batch, norm_mean,
                                      norm_std)
            return self._dp_sum_(torch.stack([
                loss.detach(),
                (aux["kld"] * mask).sum() / denom,
                (aux["rec_loss"] * mask).sum() / denom,
                (vertex_mean(err, self.vertex_shard) * mask).sum() / denom,
                aux["correct"],
                mask.sum(),
            ]))

    @torch.no_grad()
    def eval_step(self, batch: dict, norm_mean: torch.Tensor,
                  norm_std: torch.Tensor, mark=phases.unmarked) -> dict:
        """Eval forward, loss, pose error and the sex-change
        counterfactual. ``scalars`` [7 + extras] is loss, kld, rec_loss,
        correct, count, sc_correct, the masked sum of per-mesh mean errors
        and the _extra_scalars counts (over the global batch in a world;
        the other outputs are the rank's rows). `mark` is called after
        the loss and the pose error."""
        model, ops = self.model, self.ops
        loss, out, aux, y, denom = self._forward_loss(batch, False, None)
        mask = batch["mask"]
        recon_orig, err = self._pose_error(out["recon"], batch, norm_mean,
                                           norm_std)
        mark("eval_forward")
        oppo = 1.0 - y
        x_oppo = model.sample(oppo, out["z"], ops)
        y_hat2 = model.classify(model.encode(x_oppo, ops))
        oppo_pred = torch.argmax(y_hat2, dim=-1)
        oppo_label = torch.argmax(oppo, dim=-1)
        sc_correct = ((oppo_pred == oppo_label).to(mask.dtype) * mask).sum()
        oppo_orig, _ = self._pose_error(x_oppo, batch, norm_mean, norm_std)
        scalars = self._dp_sum_(torch.stack([
            loss,
            (aux["kld"] * mask).sum() / denom,
            (aux["rec_loss"] * mask).sum() / denom,
            aux["correct"],
            mask.sum(),
            sc_correct,
            (vertex_mean(err, self.vertex_shard) * mask).sum(),
            *(s.to(mask.dtype) for s in self._extra_scalars(aux)),
        ]))
        return {"scalars": scalars, "errors": err, "recon_orig": recon_orig,
                "oppo_orig": oppo_orig, "oppo_pred": oppo_pred,
                "oppo_label": oppo_label, "y_hat": out["y_hat"],
                "z": out["z"]}

    # ------------------------------------------------------------------
    def train_epoch(self, loader, generator: torch.Generator, norm_mean,
                    norm_std) -> dict:
        """One pass over the loader; returns the epoch averages."""
        totals = {"loss": 0.0, "kld": 0.0, "rec_loss": 0.0, "error": 0.0}
        correct = count = 0.0
        norm_mean, norm_std = self.norm_to_device(norm_mean, norm_std)
        for batch in loader:
            packed = self.train_step(self.to_device(batch), generator,
                                     norm_mean, norm_std)
            metrics = unpack_metrics(packed.cpu())  # one device->host pull
            n = metrics["count"]
            for k in totals:
                totals[k] += metrics[k] * n
            correct += metrics["correct"]
            count += n
        avg = {k: v / max(count, 1.0) for k, v in totals.items()}
        avg["accuracy"] = correct / max(count, 1.0)
        avg["count"] = count
        return avg

    def evaluate(self, loader, norm_mean, norm_std,
                 collect_meshes: bool = False):
        """Whole-loader eval: averages (with sex_change_success_rate and
        the mean pose error) and the [valid, N] per-vertex errors; with
        collect_meshes also the original-pose reconstructions and
        counterfactuals, their predicted and target labels and the
        dataset indices, valid rows only (the test path's mesh dumps). In
        a world every rank gets all of them: the rows are all-gathered over
        dp (parallel.fetch), the vertex rows first over sp in the row
        layout."""
        totals = {"loss": 0.0, "kld": 0.0, "rec_loss": 0.0}
        correct = sc_correct = count = err_sum = 0.0
        extra = np.zeros(len(self.extra_scalar_names))
        errors = []
        meshes = {"recon": [], "oppo": [], "oppo_pred": [], "oppo_label": [],
                  "index": []}
        norm_mean, norm_std = self.norm_to_device(norm_mean, norm_std)
        for batch in loader:
            out = self.eval_step(self.to_device(batch), norm_mean, norm_std)
            sc = out["scalars"].cpu().numpy().astype(np.float64)  # one pull
            n = float(sc[4])
            for i, k in enumerate(("loss", "kld", "rec_loss")):
                totals[k] += float(sc[i]) * n
            correct += float(sc[3])
            sc_correct += float(sc[5])
            err_sum += float(sc[6])
            extra += sc[7:]
            count += n
            keep = np.asarray(batch["mask"]) > 0
            errors.append(fetch(out["errors"], self.dist,
                                rows=self.vertex_shard)[keep])
            if collect_meshes:
                for k, src in (("recon", "recon_orig"), ("oppo", "oppo_orig"),
                               ("oppo_pred", "oppo_pred"),
                               ("oppo_label", "oppo_label")):
                    rows = (self.vertex_shard if k in ("recon", "oppo")
                            else None)
                    meshes[k].append(fetch(out[src], self.dist,
                                           rows=rows)[keep])
                meshes["index"].append(np.asarray(batch["index"])[keep])
        avg = {k: v / max(count, 1.0) for k, v in totals.items()}
        avg["accuracy"] = correct / max(count, 1.0)
        avg["sex_change_success_rate"] = sc_correct / max(count, 1.0)
        avg["error"] = err_sum / max(count, 1.0)
        avg["count"] = count
        for name, total in zip(self.extra_scalar_names, extra):
            avg[name] = float(total) / max(count, 1.0)
        errors = (np.concatenate(errors, axis=0) if errors
                  else np.zeros((0, 1)))
        if collect_meshes:
            meshes = {k: (np.concatenate(v) if v else np.zeros((0,)))
                      for k, v in meshes.items()}
            return avg, errors, meshes
        return avg, errors

    # ------------------------------------------------------------------
    # The scanned epoch (module docstring).
    def stage_batches(self, loader, with_index: bool = False):
        """Upload a whole epoch of batches once as stacked [S, B, ...]
        device tensors (None for an empty loader), to pass to
        train_epoch_scanned / evaluate_scanned in place of the loader:
        later epochs reshuffle on the device instead of shipping the data
        again. with_index also keeps the dataset indices as a host "index"
        [S, B] (evaluate_scanned's mesh collection names files with them).
        "original" is not staged: _pose_error recomputes it from x. In a
        world every rank stages the whole grid, as the permutation moves
        samples between dp slices; each step takes its rank's rows. In the
        row layout x is staged as the rank's vertex rows."""
        with phases.span("stage"):
            return stage_batch_arrays(loader, self.device, self.BATCH_KEYS,
                                      with_index=with_index,
                                      rows=self.vertex_shard)

    def _sub_phases(self, kind: str) -> dict:
        """The sub-phases a kind of scanned step times: the train step's
        ``sub_phases``, none in an evaluation."""
        return self.sub_phases if kind == "train" else {}

    def _mark_slots(self, kind: str) -> tuple:
        """The phase marks a kind of scanned step stamps: the kind's slots,
        then the marks its sub-phases add."""
        return phases.columns(kind, self._sub_phases(kind))

    def _scan_outs(self, kind: str, staged: dict) -> dict:
        """The [S, ...] rows a kind of step writes (this rank's rows of
        each batch in a world) and the int64 phase stamps [S, P]
        (train/phases.py)."""
        s, b = staged["mask"].shape[:2]
        dev = self.device
        stamps = torch.zeros((s, len(self._mark_slots(kind))),
                             dtype=torch.int64, device=dev)
        if kind == "train":
            return {"metrics": torch.zeros((s, len(METRIC_NAMES)),
                                           device=dev), "stamps": stamps}
        b //= self.dist.dp if self.dist is not None else 1
        n = staged["x"].shape[2]
        outs = {"scalars": torch.zeros(
            (s, 7 + len(self.extra_scalar_names)), device=dev)}
        if kind in ("errors", "collect"):
            outs["errors"] = torch.zeros((s, b, n), device=dev)
        if kind == "collect":
            for k in ("recon_orig", "oppo_orig"):
                outs[k] = torch.zeros((s, b, n, 3), device=dev)
            for k in ("oppo_pred", "oppo_label"):
                outs[k] = torch.zeros((s, b), dtype=torch.long, device=dev)
        outs["stamps"] = stamps
        return outs

    def _scan_batch(self, st: _Scan) -> dict:
        """Step st.step's batch: rows perm[i * B:(i + 1) * B] of the flat
        sample grid (the rank's dp rows of them in a world), gathered on
        the device."""
        idx = st.perm.view(st.steps, st.batch).index_select(0, st.step)[0]
        if self.dist is not None and self.dist.dp > 1:
            b = st.batch // self.dist.dp
            idx = idx[self.dist.dp_rank * b:(self.dist.dp_rank + 1) * b]
        return {k: v.index_select(0, idx) for k, v in st.flat.items()}

    def _scan_train_step(self, st: _Scan, generator) -> None:
        st.mark("start")
        packed = self.train_step(self._scan_batch(st), generator, *st.norm,
                                 mark=st.mark)
        st.outs["metrics"].index_copy_(0, st.step, packed[None])
        st.mark("metrics")
        st.step.add_(1)

    def _scan_eval_step(self, st: _Scan) -> None:
        st.mark("start")
        out = self.eval_step(self._scan_batch(st), *st.norm, mark=st.mark)
        for k, rows in st.outs.items():
            if k != "stamps":
                rows.index_copy_(0, st.step, out[k][None])
        st.mark("eval_counterfactual")
        st.step.add_(1)

    def _train_deps(self) -> list:
        """What a captured train step is bound to: the parameters, the
        optimizer, its lr tensors and its state tensors."""
        opt = self.optimizer
        deps = [opt, *self.model.parameters()]
        deps += [g["lr"] for g in opt.param_groups]
        for state in opt.state.values():
            deps += list(state.values())
        return deps

    def _scan_state(self, kind: str, staged: dict, norm_mean, norm_std,
                    generator=None) -> _Scan:
        """The _Scan of `staged` for a kind of step ("train", "light",
        "errors", "collect"), built at a new staged epoch; the
        normalisation (none for steps that take none: norm_mean None) is
        copied into its own tensors; with ``graphs`` its StepGraph, rebuilt
        for another generator and checked against its dependencies
        (train/graphs.py)."""
        st = self._scans.get(kind)
        if st is None or st.staged is not staged:
            st = _Scan(kind, staged, self._scan_outs(kind, staged),
                       self.device, self.BATCH_KEYS, self._mark_slots(kind))
            self._scans[kind] = st
        if norm_mean is None:
            st.norm = ()
        else:
            mean, std = (torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device)
                         for a in (norm_mean, norm_std))
            shard = self.vertex_shard
            if shard is not None and mean.shape[0] != shard.rows_local:
                raise ValueError(
                    "a scanned epoch in the row layout takes the statistics "
                    "as norm_to_device returns them (the rank's rows)")
            if not st.norm:
                st.norm = (mean.clone(), std.clone())
            else:
                st.norm[0].copy_(mean)
                st.norm[1].copy_(std)
        if st.run is None or st.generator is not generator:
            st.generator = generator
            st.graph = None
            if kind == "train":
                st.run = lambda: self._scan_train_step(st, generator)
            else:
                st.run = lambda: self._scan_eval_step(st)
        if self.graphs and st.graph is None:
            deps = (self._train_deps if kind == "train"
                    else lambda: list(self.model.parameters()))
            st.graph = StepGraph(st.run, deps, generator, name=kind)
        elif self.graphs:
            st.graph.check()
        return st

    def _run_scan(self, st: _Scan) -> dict | None:
        """The epoch's steps: replays of the graph (eager calls with
        ``graphs`` off; a graph already captured is kept for later), with
        no host work in between. Returns what the epoch's phase record
        needs (phases.pending; None without stamps)."""
        st.step.zero_()
        replayed = self.graphs and st.graph.graph is not None
        step = st.graph if self.graphs else st.run
        name = "step." + st.kind
        for _ in range(st.steps):
            with phases.span(name):
                step()
        stamps = st.outs.get("stamps")
        return (None if stamps is None
                else phases.pending(st.kind, stamps, replayed,
                                    self._sub_phases(st.kind)))

    def train_epoch_scanned_async(self, staged, generator, norm_mean,
                                  norm_std, shuffle_generator=None,
                                  perm=None):
        """Run one scanned train epoch over `staged` (a stage_batches dict,
        or a loader staged here) without waiting for it: returns the [S, 6]
        per-step metrics as an in-flight HostCopy (None for an empty epoch)
        for finalize_train_metrics, so the next epoch can be queued before
        this one is read (the epoch pipeline, train/driver.py); it carries
        the epoch's phase stamps ``beside``.
        The normalisation is norm_to_device's result. The epoch's order of
        the S * B samples is a permutation drawn on the device from
        shuffle_generator (identity without it); `perm` gives it
        explicitly."""
        if staged is not None and not isinstance(staged, dict):
            staged = self.stage_batches(staged)
        if staged is None:
            return None
        st = self._scan_state("train", staged, norm_mean, norm_std,
                              generator)
        n = st.steps * st.batch
        with phases.span("shuffle"):
            if perm is not None:
                st.perm.copy_(torch.as_tensor(np.asarray(perm),
                                              dtype=torch.long))
            elif shuffle_generator is not None:
                torch.randperm(n, generator=shuffle_generator, out=st.perm)
            else:
                torch.arange(n, out=st.perm)
        return HostCopy(st.outs["metrics"], beside=self._run_scan(st))

    @staticmethod
    def finalize_train_metrics(packed) -> dict:
        """Read and reduce a scanned epoch's [S, 6] metrics (its one
        device-to-host pull): count-weighted means of loss, kld, rec_loss
        and error, accuracy = correct / count. The epoch's phase stamps,
        when its HostCopy carries them, become a phases.RECORDS record."""
        if packed is None:
            return {"loss": 0.0, "kld": 0.0, "rec_loss": 0.0, "error": 0.0,
                    "accuracy": 0.0, "count": 0.0}
        with phases.span("finalize.train"):
            arr = _host(packed).astype(np.float64)
            phases.record(getattr(packed, "beside", None))
        metrics = {k: arr[:, i] for i, k in enumerate(METRIC_NAMES)}
        counts = metrics["count"]
        total = float(counts.sum())
        avg = {k: float((metrics[k] * counts).sum()) / max(total, 1.0)
               for k in ("loss", "kld", "rec_loss", "error")}
        avg["accuracy"] = float(metrics["correct"].sum()) / max(total, 1.0)
        avg["count"] = total
        return avg

    def train_epoch_scanned(self, staged, generator, norm_mean, norm_std,
                            shuffle_generator=None, perm=None) -> dict:
        """train_epoch over a staged epoch, read back at once: the same
        math and averages."""
        return self.finalize_train_metrics(self.train_epoch_scanned_async(
            staged, generator, norm_mean, norm_std,
            shuffle_generator=shuffle_generator, perm=perm))

    def evaluate_scanned_async(self, staged, norm_mean, norm_std,
                               collect_meshes: bool = False,
                               with_errors: bool = True):
        """Run the eval steps over `staged` (or a loader, staged here with
        its indices when collecting) without waiting; returns what
        finalize_eval_scanned reads (None for an empty split).
        with_errors=False runs the light variant, which writes no [S, B, N]
        error rows (finalize it with with_errors=False too). The
        normalisation is norm_to_device's result."""
        if staged is not None and not isinstance(staged, dict):
            staged = self.stage_batches(staged, with_index=collect_meshes)
        if staged is None:
            return None
        index = staged.get("index")
        if collect_meshes and index is None:
            raise ValueError("collect_meshes needs a loader or a dict from "
                             "stage_batches(..., with_index=True)")
        kind = ("collect" if collect_meshes else "errors" if with_errors
                else "light")
        st = self._scan_state(kind, staged, norm_mean, norm_std)
        marks = self._run_scan(st)
        outs = {k: v for k, v in st.outs.items() if k != "stamps"}
        if self.vertex_shard is not None:   # vertex rows -> all N
            outs = {k: self.vertex_shard.gather(v, dim=2)
                    if k in _VERTEX_OUTS else v for k, v in outs.items()}
        if self.dist is not None and self.dist.dp > 1:
            outs = {k: v if k == "scalars"
                    else self.dist.dp_group.all_gather(v, dim=1)
                    for k, v in outs.items()}
        return {"outs": HostCopy(outs, beside=marks), "index": index,
                "collect": collect_meshes, "mask_host": staged["mask_host"]}

    _EVAL_EMPTY = {"loss": 0.0, "kld": 0.0, "rec_loss": 0.0, "error": 0.0,
                   "accuracy": 0.0, "sex_change_success_rate": 0.0,
                   "count": 0.0}

    def finalize_eval_scanned(self, pending, with_errors: bool = True):
        """Read and reduce a scanned evaluation: the averages of evaluate()
        and, with_errors, the [valid, N] per-vertex errors (and with
        collection the meshes, as evaluate(collect_meshes=True)). The
        epoch's phase stamps, when it carries them (``pending["outs"]
        .beside``), become a phases.RECORDS record."""
        if pending is None:
            avg = dict(self._EVAL_EMPTY, **dict.fromkeys(
                self.extra_scalar_names, 0.0))
            return (avg, np.zeros((0, 1))) if with_errors else (avg, None)
        kind = ("collect" if pending["collect"] else "errors" if with_errors
                else "light")
        with phases.span("finalize." + kind):
            return self._finalize_eval(pending, with_errors)

    def _finalize_eval(self, pending, with_errors: bool):
        outs = pending["outs"].wait()
        phases.record(pending["outs"].beside)
        if with_errors and "errors" not in outs:
            raise ValueError(
                "eval scan was dispatched with with_errors=False (light "
                "variant): per-vertex errors were never materialized")
        sc = _host(outs["scalars"]).astype(np.float64)       # [S, 7 + extras]
        counts = sc[:, 4]
        total = float(counts.sum())
        avg = {
            "loss": float((sc[:, 0] * counts).sum()) / max(total, 1.0),
            "kld": float((sc[:, 1] * counts).sum()) / max(total, 1.0),
            "rec_loss": float((sc[:, 2] * counts).sum()) / max(total, 1.0),
            "accuracy": float(sc[:, 3].sum()) / max(total, 1.0),
            "sex_change_success_rate": float(sc[:, 5].sum()) / max(total,
                                                                    1.0),
            "error": float(sc[:, 6].sum()) / max(total, 1.0),
            "count": total,
        }
        for i, name in enumerate(self.extra_scalar_names):
            avg[name] = float(sc[:, 7 + i].sum()) / max(total, 1.0)
        if not with_errors and not pending["collect"]:
            return avg, None
        mask = np.asarray(pending["mask_host"]) > 0              # [S, B]
        errors = _host(outs["errors"])[mask]                     # [valid, N]
        if pending["collect"]:
            meshes = {
                "recon": _host(outs["recon_orig"])[mask],
                "oppo": _host(outs["oppo_orig"])[mask],
                "oppo_pred": _host(outs["oppo_pred"])[mask],
                "oppo_label": _host(outs["oppo_label"])[mask],
                "index": np.asarray(pending["index"])[mask],
            }
            return avg, errors, meshes
        return avg, errors

    def evaluate_scanned(self, staged, norm_mean, norm_std,
                         collect_meshes: bool = False):
        """evaluate() over a staged split (or a loader), run at once and
        read back: the averages, the errors and, with collect_meshes, the
        meshes."""
        pending = self.evaluate_scanned_async(staged, norm_mean, norm_std,
                                              collect_meshes=collect_meshes)
        result = self.finalize_eval_scanned(pending, with_errors=True)
        if collect_meshes and pending is None:
            return result + ({k: np.zeros((0,)) for k in
                              ("recon", "oppo", "oppo_pred", "oppo_label",
                               "index")},)
        return result
