"""Phase marks and host spans of the port's train loop (train/phases.py,
train/loop.py, train/graphs.py, train/driver.py) and the benchmark's
readers of them (meshbench/phases.py, meshbench/metrics/).

On the CPU a scanned epoch's steps run eagerly and the marks are host
clock readings (time.monotonic_ns) written into the same [S, P] stamps the
card's mark kernel fills; the card's test holds a captured step graph's
marks (one row per replay) and its launch counts.
"""
import collections
import json
import os
import sys

import numpy as np
import pytest
import torch

from meshvae_tpu_torch import plot_losses
from meshvae_tpu_torch.config import default_config
from meshvae_tpu_torch.data import (BatchIterator, MeshDataset,
                                    generate_synthetic_dataset, list_meshes)
from meshvae_tpu_torch.mesh import TriMesh, build_hierarchy, save_obj
from meshvae_tpu_torch.models import (GCNConfig, JointMeshVAE, MeshVAE,
                                      VAEConfig, build_operators)
import meshvae_tpu_torch.train as train_package
from meshvae_tpu_torch.train import JointTrainer, Trainer, driver, phases

from conftest import make_grid_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
CONFIG = {"num_classes": 2, "learning_rate": 1e-3, "weight_decay": 5e-4}
TRAIN_SLOTS = phases.SLOTS["train"]
EVAL_SLOTS = phases.SLOTS["eval"]
JOINT_MARKS = ("gcn", "gcn_grad")
JOINT_SUB_PHASES = {"gcn_forward": ("gcn", "forward"),
                    "gcn_backward": ("forward", "gcn_grad")}


def _data(root, grid: int, n: int):
    """A grid template's hierarchy and the batches of n synthetic meshes."""
    mesh = make_grid_mesh(grid, jitter=0.05)
    hier = build_hierarchy(TriMesh(mesh.v, mesh.f), [2, 2])
    template = TriMesh(hier.vertices[0], hier.faces[0])
    generate_synthetic_dataset(template, str(root / "data"), n_samples=n,
                               seed=1)
    cfg = {"root_dir": str(root / "data"),
           "checkpoint_dir": str(root / "ckpt")}
    index, labels = list_meshes(cfg)
    ds = MeshDataset(index, cfg, labels, template.v)
    return hier, ds, list(BatchIterator(ds, BATCH, shuffle=True, seed=3))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """An 8x8 grid (64 -> 32 -> 16 vertices), 12 meshes: three steps."""
    return _data(tmp_path_factory.mktemp("phases"), 8, 12)


def _trainer(hier, device="cpu", bsr_min_n=1024):
    cfg = VAEConfig(num_features=3, filters=(8, 16, 16),
                    polygon_order=(3, 3, 3), n_layers=2, num_hidden=16,
                    latent=4, num_classes=2, dropout=0.2,
                    coarse_verts=hier.levels[-1],
                    precision="highest")
    ops = build_operators(hier, device, cheb_method="pallas",
                          bsr_min_n=bsr_min_n)
    model = MeshVAE(cfg, generator=torch.Generator().manual_seed(0))
    return Trainer(model, ops, dict(CONFIG), device=device)


def _joint_trainer(hier, device="cpu", bsr_min_n=1024):
    """The joint VAE + GCN at _trainer's widths, split 2 of latent 4."""
    vae = VAEConfig(num_features=3, filters=(8, 16, 16),
                    polygon_order=(3, 3, 3), n_layers=2, num_hidden=16,
                    latent=4, num_classes=2, dropout=0.2,
                    coarse_verts=hier.levels[-1], precision="highest")
    gcn = GCNConfig(num_features=6, filters=(8, 16, 16),
                    polygon_order=(3, 3, 3), n_layers=2, num_classes=2,
                    coarse_verts=hier.levels[-1], precision="highest")
    ops = build_operators(hier, device, cheb_method="pallas",
                          bsr_min_n=bsr_min_n)
    model = JointMeshVAE(vae, gcn, 2,
                         generator=torch.Generator().manual_seed(0))
    return JointTrainer(model, ops, dict(CONFIG), device=device)


def _unmarked(monkeypatch):
    """Take the marks out, as a patch that measures their cost would: no
    mark is written and no epoch leaves a record."""
    monkeypatch.setattr(phases, "Marks", lambda *args: phases.unmarked)
    monkeypatch.setattr(phases, "record", lambda beside: None)


def _epoch(tr, staged, norm, gen=None):
    """One scanned train epoch and one light evaluation, not yet read
    (the dropout drawn from `gen`, by default a new CPU generator)."""
    if gen is None:
        gen = torch.Generator().manual_seed(7)
    perm = np.random.default_rng(0).permutation(staged["mask"].numel())
    packed = tr.train_epoch_scanned_async(staged, gen, *norm, perm=perm)
    return packed, tr.evaluate_scanned_async(staged, *norm,
                                             with_errors=False)


def test_scanned_epochs_stamp_their_phases_and_leave_one_record(
        data, monkeypatch):
    """Marks on: [S, 5] train and [S, 3] eval stamps that never decrease
    along a row or from one row to the next, each slot counted once a step
    in LAUNCHES; finalizing leaves one record per epoch with phases >= 0
    that sum to the step's span and gaps >= 0. Marks taken out: the stamps
    stay zero and no record is made. The packed metrics and the eval
    scalars are bit-equal either way."""
    hier, ds, batches = data
    steps = len(batches)
    read = {}
    for marks in (True, False):
        with monkeypatch.context() as m:
            if not marks:
                _unmarked(m)
            tr = _trainer(hier)
            staged = tr.stage_batches(batches)
            norm = tr.norm_to_device(ds.mean, ds.std)
            phases.reset_launches()
            packed, pending = _epoch(tr, staged, norm)
            launches = dict(phases.LAUNCHES)
            count = phases.recorded()
            train_avg = tr.finalize_train_metrics(packed)
            eval_avg, _ = tr.finalize_eval_scanned(pending,
                                                   with_errors=False)
        read[marks] = (packed.wait(), pending["outs"].wait()["scalars"],
                       train_avg, eval_avg)
        new = phases.since(count)
        if not marks:
            for beside in (packed.beside, pending["outs"].beside):
                assert (beside["stamps"].numpy() == 0).all()
            assert new == [] and launches == {}
            continue
        assert launches == {
            slot: steps * ((slot in TRAIN_SLOTS) + (slot in EVAL_SLOTS))
            for slot in TRAIN_SLOTS + EVAL_SLOTS}
        for beside, slots in ((packed.beside, TRAIN_SLOTS),
                              (pending["outs"].beside, EVAL_SLOTS)):
            stamps = beside["stamps"].numpy()
            assert stamps.dtype == np.int64
            assert stamps.shape == (steps, len(slots))
            assert (stamps > 0).all()
            assert (np.diff(stamps.reshape(-1)) >= 0).all()
        assert [r["kind"] for r in new] == ["train", "light"]
        for rec, beside, slots in ((new[0], packed.beside, TRAIN_SLOTS),
                                   (new[1], pending["outs"].beside,
                                    EVAL_SLOTS)):
            stamps = beside["stamps"].numpy()
            assert rec["steps"] == steps
            assert not rec["profiled"] and not rec["replayed"]  # eager
            assert list(rec["phases"]) == list(slots[1:])
            total = sum(rec["phases"].values())
            for ms in rec["phases"].values():
                assert ms.shape == (steps,) and (ms >= 0).all()
            span = (stamps[:, -1] - stamps[:, 0]) * 1e-6
            assert (total <= span + 1e-9).all()
            assert rec["gap"].shape == (steps - 1,)
            assert (rec["gap"] >= 0).all()
            np.testing.assert_allclose(
                rec["gap"], (stamps[1:, 0] - stamps[:-1, -1]) * 1e-6)
    on, off = read[True], read[False]
    torch.testing.assert_close(on[0], off[0], rtol=0, atol=0)
    torch.testing.assert_close(on[1], off[1], rtol=0, atol=0)
    assert on[2] == off[2] and on[3] == off[3]


def test_joint_epoch_times_its_gcn_inside_its_phases(data, monkeypatch):
    """The joint trainer's train stamps carry two more columns, gcn and
    gcn_grad, stamped once a step each (LAUNCHES) with start <= gcn <=
    forward <= gcn_grad <= backward in every row; its record keeps the
    train phases as the slots' differences, the gap from the metrics mark,
    and adds the sub-phases gcn_forward (gcn -> forward) and gcn_backward
    (forward -> gcn_grad), each inside its parent phase; the eval record
    has none and the run log's line names them. With the marks taken out
    the packed metrics and the eval scalars are bit-equal."""
    hier, ds, batches = data
    steps = len(batches)
    read = {}
    for marks in (True, False):
        with monkeypatch.context() as m:
            if not marks:
                _unmarked(m)
            tr = _joint_trainer(hier)
            staged = tr.stage_batches(batches)
            norm = tr.norm_to_device(ds.mean, ds.std)
            phases.reset_launches()
            packed, pending = _epoch(tr, staged, norm)
            launches = dict(phases.LAUNCHES)
            count = phases.recorded()
            tr.finalize_train_metrics(packed)
            tr.finalize_eval_scanned(pending, with_errors=False)
        read[marks] = (packed.wait(), pending["outs"].wait()["scalars"])
        if not marks:
            assert launches == {} and phases.since(count) == []
            continue
        assert launches == {
            slot: steps * ((slot in TRAIN_SLOTS) + (slot in EVAL_SLOTS)
                           + (slot in JOINT_MARKS))
            for slot in TRAIN_SLOTS + EVAL_SLOTS + JOINT_MARKS}
        beside = packed.beside
        assert beside["columns"] == TRAIN_SLOTS + JOINT_MARKS
        stamps = beside["stamps"].numpy()
        assert stamps.shape == (steps, len(TRAIN_SLOTS) + 2)
        col = {name: stamps[:, i]
               for i, name in enumerate(beside["columns"])}
        order = ("start", "gcn", "forward", "gcn_grad", "backward",
                 "optimizer", "metrics")
        for a, b in zip(order, order[1:]):
            assert (col[b] >= col[a]).all(), (a, b)
        train, light = phases.since(count)
        assert (train["kind"], light["kind"]) == ("train", "light")
        assert list(train["phases"]) == list(TRAIN_SLOTS[1:])
        for a, b in zip(TRAIN_SLOTS, TRAIN_SLOTS[1:]):
            np.testing.assert_allclose(train["phases"][b],
                                       (col[b] - col[a]) * 1e-6)
        np.testing.assert_allclose(
            train["gap"], (col["start"][1:] - col["metrics"][:-1]) * 1e-6)
        sub = train["sub_phases"]
        assert set(sub) == {"gcn_forward", "gcn_backward"}
        np.testing.assert_allclose(sub["gcn_forward"],
                                   (col["forward"] - col["gcn"]) * 1e-6)
        np.testing.assert_allclose(sub["gcn_backward"],
                                   (col["gcn_grad"] - col["forward"]) * 1e-6)
        for name, parent in (("gcn_forward", "forward"),
                             ("gcn_backward", "backward")):
            assert sub[name].shape == (steps,) and (sub[name] > 0).all()
            assert (sub[name] <= train["phases"][parent]).all()
        assert light["sub_phases"] == {}
        assert pending["outs"].beside["columns"] == EVAL_SLOTS
        line = phases.epoch_line(1, [train, light])
        assert " gcn_forward " in line and " gcn_backward " in line
    on, off = read[True], read[False]
    torch.testing.assert_close(on[0], off[0], rtol=0, atol=0)
    torch.testing.assert_close(on[1], off[1], rtol=0, atol=0)


def test_a_vae_trainer_keeps_its_slots_and_stamps_nothing_new(data):
    """A MeshVAE trainer stamps the kinds' slots alone: no train marks of
    its own, [S, 5] train stamps named by the slots, no sub-phase in its
    records and no joint mark counted."""
    hier, ds, batches = data
    tr = _trainer(hier)
    assert Trainer.sub_phases == {} and tr.sub_phases == {}
    assert tr._mark_slots("train") == TRAIN_SLOTS
    assert tr._mark_slots("light") == EVAL_SLOTS
    assert JointTrainer.sub_phases == JOINT_SUB_PHASES
    assert phases.columns("train", JOINT_SUB_PHASES) == (TRAIN_SLOTS
                                                         + JOINT_MARKS)
    assert phases.columns("light", {}) == EVAL_SLOTS
    staged = tr.stage_batches(batches)
    norm = tr.norm_to_device(ds.mean, ds.std)
    phases.reset_launches()
    count = phases.recorded()
    packed, pending = _epoch(tr, staged, norm)
    tr.finalize_train_metrics(packed)
    tr.finalize_eval_scanned(pending, with_errors=False)
    assert packed.beside["columns"] == TRAIN_SLOTS
    assert packed.beside["sub_phases"] == {}
    assert packed.beside["stamps"].shape == (len(batches), len(TRAIN_SLOTS))
    assert not set(JOINT_MARKS) & set(phases.LAUNCHES)
    assert [r["sub_phases"] for r in phases.since(count)] == [{}, {}]


def test_records_are_bounded_and_read_back_by_count(monkeypatch):
    """RECORDS keeps at least 2048 records, dropping the oldest; since()
    returns the records appended after a recorded() count, also once the
    oldest are gone."""
    assert phases.RECORDS.maxlen >= 2048
    monkeypatch.setattr(phases, "RECORDS", collections.deque(maxlen=3))
    stamps = np.array([[1, 2, 4], [5, 7, 8]], dtype=np.int64)
    first = phases.recorded()
    recs = [phases.record({"kind": "light", "stamps": stamps + i,
                           "columns": EVAL_SLOTS, "sub_phases": {},
                           "profiled": False, "replayed": True})
            for i in range(5)]
    assert phases.recorded() == first + 5
    assert phases.since(first + 3) == recs[3:]
    assert phases.since(first) == recs[2:]  # the two oldest dropped
    assert phases.since(phases.recorded()) == []
    assert phases.record(None) is None


def test_span_makes_no_record_function_without_a_profiler(data,
                                                          monkeypatch):
    """With no profiler running a span is one shared no-op and a scanned
    epoch, its evaluation and their finalizers open no span."""
    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction on the unprofiled path")

    # the loop's spans (torch's own, as Adam's, are not the loop's)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert phases.span("a") is phases.span("b")
    hier, ds, batches = data
    tr = _trainer(hier)
    staged = tr.stage_batches(batches)
    norm = tr.norm_to_device(ds.mean, ds.std)
    packed, pending = _epoch(tr, staged, norm)
    tr.finalize_train_metrics(packed)
    tr.finalize_eval_scanned(pending, with_errors=False)


def test_spans_nest_as_called_under_a_cpu_profiler(data):
    """Under torch.profiler (CPU) the loop's spans appear by name and nest
    as the calls do: staging, the shuffle, one step span per step and the
    finalizers under the caller's range, each pull under its finalizer;
    the epochs' records say that a profiler ran."""
    from torch.profiler import ProfilerActivity, profile, record_function

    hier, ds, batches = data
    tr = _trainer(hier)
    norm = tr.norm_to_device(ds.mean, ds.std)
    shuffle = torch.Generator().manual_seed(5)
    gen = torch.Generator().manual_seed(7)
    count = phases.recorded()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            staged = tr.stage_batches(batches)
            packed = tr.train_epoch_scanned_async(
                staged, gen, *norm, shuffle_generator=shuffle)
            pending = tr.evaluate_scanned_async(staged, *norm,
                                                with_errors=False)
            tr.finalize_train_metrics(packed)
            tr.finalize_eval_scanned(pending, with_errors=False)
    events = [e for e in prof.events() if e.name.startswith("meshvae.")]
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e.name].append(e)
    parent = lambda e: e.cpu_parent.name if e.cpu_parent else None
    for name in ("stage", "shuffle", "step.train", "step.light",
                 "finalize.train", "finalize.light"):
        assert by_name[f"meshvae.{name}"], name
        assert {parent(e) for e in by_name[f"meshvae.{name}"]} == {
            "caller"}, name
    assert len(by_name["meshvae.step.train"]) == len(batches)
    assert len(by_name["meshvae.step.light"]) == len(batches)
    assert sorted(parent(e) for e in by_name["meshvae.pull"]) == [
        "meshvae.finalize.light", "meshvae.finalize.train"]
    assert [r["profiled"] for r in phases.since(count)] == [True, True]


# --- the benchmark's readers -----------------------------------------------

def _stamps(steps: int, durations: list, gap: float, start: int = 10**9):
    """[steps, len(durations) + 1] ns stamps: each step's phases take
    `durations` ms, and `gap` ms separate a step's last mark from the next
    step's start."""
    rows, t = [], start
    for _ in range(steps):
        row = [t]
        for ms in durations:
            row.append(row[-1] + int(round(ms * 1e6)))
        rows.append(row)
        t = row[-1] + int(round(gap * 1e6))
    return np.array(rows, dtype=np.int64)


def _record(kind, steps, durations, gap, profiled=False, replayed=True):
    return phases.record({"kind": kind, "stamps": _stamps(steps, durations,
                                                         gap),
                          "columns": phases.slots(kind), "sub_phases": {},
                          "profiled": profiled, "replayed": replayed})


def _window_records(monkeypatch):
    """A window of 4 train steps and 2 eval steps per epoch: three train
    epochs whose forward phase takes 1, 2 and 4 ms (median 2), two light
    evaluations of 5 and 7 ms a step, and records the readers must pass
    over (profiled, not replayed, one step, another step count, another
    kind)."""
    monkeypatch.setattr(phases, "RECORDS", collections.deque(maxlen=64))
    for fwd, bwd, opt in ((1.0, 2.0, 0.25), (2.0, 3.0, 0.5),
                          (4.0, 6.0, 0.75)):
        _record("train", 4, [fwd, bwd, opt, 0.5], 0.125)
    _record("light", 2, [3.0, 2.0], 0.25)
    _record("light", 2, [4.0, 3.0], 0.25)
    for kw in ({"profiled": True}, {"replayed": False}):
        _record("train", 4, [100.0] * 4, 50.0, **kw)
        _record("light", 2, [100.0] * 2, 50.0, **kw)
    _record("train", 1, [100.0] * 4, 50.0)
    _record("light", 1, [100.0] * 2, 50.0)
    _record("train", 5, [100.0] * 4, 50.0)
    _record("errors", 2, [100.0] * 2, 50.0)
    return {"steps_per_epoch": (4, 2)}


# the window above: gaps 3 x 3 train ones of 0.125 and 2 x 1 light of 0.25
READINGS = {"forward_ms": 2.0, "backward_ms": 3.0, "optimizer_ms": 0.5,
            "eval_step_ms": 6.0,
            "step_gap_ms": (9 * 0.125 + 2 * 0.25) / 11}


@pytest.mark.parametrize("base", sorted(READINGS))
def test_phase_readers_read_the_window_records(base, monkeypatch):
    """Each reader, found by its metric's name in both cells, reads the
    window's records (train and light epochs of the window's step counts,
    unprofiled and replayed) and returns None when there are none: no
    records, only records it must pass over, no window, or a program
    without phases (an older checkout)."""
    monkeypatch.syspath_prepend(ROOT)
    from meshbench.registry import Registry

    reg = Registry()
    for cfg in ("vae80k", "vae5k"):
        name = f"{base}.{cfg}"
        (entry,) = [m for m in reg.bench["per_layer"] if m["name"] == name]
        assert entry["workloads"] == [f"{cfg}.train"]
        assert entry["moves"] == f"train_meshes_per_s.{cfg}"
        assert entry["source"] == "device_trace"
        assert entry["layer"] == ("train loop" if base == "step_gap_ms"
                                  else "model")
    read = reg.metric_reader(f"{base}.vae5k")
    ctx = _window_records(monkeypatch)
    assert read(ctx) == pytest.approx(READINGS[base], rel=1e-9)
    assert read({}) is None
    with monkeypatch.context() as m:   # a checkout without the marks
        m.delattr(train_package, "phases")
        m.setitem(sys.modules, "meshvae_tpu_torch.train.phases", None)
        assert read(ctx) is None
    assert read(ctx) == pytest.approx(READINGS[base], rel=1e-9)
    monkeypatch.setattr(phases, "RECORDS", collections.deque(maxlen=64))
    assert read(ctx) is None
    _record("train", 4, [1.0] * 4, 1.0, profiled=True)
    _record("light", 2, [1.0] * 2, 1.0, replayed=False)
    _record("train", 1, [1.0] * 4, 1.0)
    _record("light", 1, [1.0] * 2, 1.0)
    assert read(ctx) is None


def _joint_stamps(steps: int, forward: float, gcn_forward: float,
                  backward: float, gcn_backward: float) -> np.ndarray:
    """[steps, 7] joint train stamps (the slots, then gcn and gcn_grad):
    the GCN takes the last gcn_forward ms of the forward phase and the
    first gcn_backward ms of the backward; optimizer and metrics 0.5 ms,
    0.125 ms between steps."""
    main = _stamps(steps, [forward, backward, 0.5, 0.5], 0.125)
    ns = lambda ms: int(round(ms * 1e6))
    gcn = main[:, 1] - ns(gcn_forward)
    grad = main[:, 1] + ns(gcn_backward)
    return np.concatenate([main, gcn[:, None], grad[:, None]], axis=1)


def _joint_window(monkeypatch):
    """Three joint train epochs whose GCN takes 1, 2 and 4 ms of the
    forward and 3, 5 and 6 ms of the backward (medians 2 and 5), one light
    evaluation, and joint records the readers must pass over (profiled,
    not replayed, another step count)."""
    monkeypatch.setattr(phases, "RECORDS", collections.deque(maxlen=64))
    columns = TRAIN_SLOTS + JOINT_MARKS

    def joint(gcn_fwd, gcn_bwd, steps=4, profiled=False, replayed=True):
        phases.record({"kind": "train", "columns": columns,
                       "sub_phases": JOINT_SUB_PHASES,
                       "stamps": _joint_stamps(steps, 10.0, gcn_fwd, 12.0,
                                               gcn_bwd),
                       "profiled": profiled, "replayed": replayed})

    for gcn_fwd, gcn_bwd in ((1.0, 3.0), (2.0, 5.0), (4.0, 6.0)):
        joint(gcn_fwd, gcn_bwd)
    _record("light", 2, [3.0, 2.0], 0.25)
    joint(9.0, 9.0, profiled=True)
    joint(9.0, 9.0, replayed=False)
    joint(9.0, 9.0, steps=5)
    return {"steps_per_epoch": (4, 2)}


GCN_READINGS = {"gcn_forward_ms": 2.0, "gcn_backward_ms": 5.0}


@pytest.mark.parametrize("base", sorted(GCN_READINGS))
def test_gcn_readers_read_the_joint_window_records(base, monkeypatch):
    """gcn_forward_ms and gcn_backward_ms, found by their names in the
    joint cell, read the median over the window's joint train epochs of
    each one's mean sub-phase, inside forward_ms and backward_ms of the
    same records (10 and 12 ms); None for the VAE's records (no
    sub-phases), for no window, and for a program without phases (an
    older checkout)."""
    monkeypatch.syspath_prepend(ROOT)
    from meshbench.registry import Registry

    reg = Registry()
    name = f"{base}.joint80k"
    (entry,) = [m for m in reg.bench["per_layer"] if m["name"] == name]
    assert entry["workloads"] == ["joint80k.train"]
    assert entry["moves"] == "train_meshes_per_s.vae80k"
    assert (entry["source"], entry["layer"]) == ("device_trace", "model")
    read = reg.metric_reader(name)
    ctx = _joint_window(monkeypatch)
    assert read(ctx) == pytest.approx(GCN_READINGS[base], rel=1e-9)
    parent = reg.metric_reader(("forward_ms" if base == "gcn_forward_ms"
                                else "backward_ms") + ".joint80k")
    assert read(ctx) <= parent(ctx) == pytest.approx(
        10.0 if base == "gcn_forward_ms" else 12.0, rel=1e-9)
    assert read({}) is None
    with monkeypatch.context() as m:   # a checkout without the marks
        m.delattr(train_package, "phases")
        m.setitem(sys.modules, "meshvae_tpu_torch.train.phases", None)
        assert read(ctx) is None
    vae = _window_records(monkeypatch)   # the VAE's records: no sub-phase
    assert read(vae) is None


# --- the driver -------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """An 8x8 grid template, 16 synthetic meshes, 2 folds x 2 epochs."""
    root = str(tmp_path_factory.mktemp("phases_driver"))
    template = make_grid_mesh(8, jitter=0.05)
    template_path = os.path.join(root, "template.obj")
    save_obj(template_path, template.v, template.f)
    data_dir = os.path.join(root, "data")
    generate_synthetic_dataset(TriMesh(template.v, template.f), data_dir,
                               n_samples=16, seed=1)
    config = default_config()
    config.update({
        "template": template_path, "root_dir": data_dir, "folds": 2,
        "test_size": 0.25, "n_layers": 2, "num_hidden": 16, "num_style": 4,
        "downsampling_factors": [2, 2], "polygon_order": [3, 3, 3],
        "num_conv_filters": [8, 16, 16], "batch_size": 4, "epoch": 2,
        "hierarchy_cache_dir": os.path.join(root, "cache"),
        "cheb_method": "pallas", "matmul_precision": "highest",
    })
    return root, config


def test_driver_logs_each_epochs_phases_and_keeps_its_records(
        env, monkeypatch):
    """The run log gains one line per epoch of each fold, with the train
    and light phases and the step gap; with the marks taken out it has
    none. Everything else in the log, the histories (their times aside)
    and what plot_losses reads from them are the same either way."""
    root, config = env
    runs = {}
    for marks in (True, False):
        ckpt = os.path.join(root, f"marks_{marks}")
        with monkeypatch.context() as m:
            if not marks:
                _unmarked(m)
            driver.run(dict(config, checkpoint_dir=ckpt,
                            log_file=os.path.join(ckpt, "log.txt")),
                       do_train=True, do_test=False, device="cpu")
        with open(os.path.join(ckpt, "log.txt")) as fp:
            log = fp.read().splitlines()
        paths = [os.path.join(ckpt, f"history{n}.json") for n in (1, 2)]
        hist = []
        for path in paths:
            with open(path) as fp:
                hist.append(json.load(fp))
        runs[marks] = (log, hist, plot_losses.curves(
            plot_losses.load_histories(paths)))
    log_on, log_off = runs[True][0], runs[False][0]
    lines = [line for line in log_on if line.startswith("phases of epoch")]
    assert [line.split(",")[0] for line in lines] == [
        "phases of epoch 1", "phases of epoch 2"] * 2
    for line in lines:
        assert " train forward " in line and " metrics " in line
        assert " light eval_forward " in line
        assert " eval_counterfactual " in line and "step gap mean" in line
    assert [line for line in log_on if line not in lines] == log_off
    assert not any(line.startswith("phases") for line in log_off)
    untimed = lambda h: [{k: v for k, v in e.items()
                          if k not in ("begin", "duration", "finalized")}
                         for e in h]
    for on, off in zip(runs[True][1], runs[False][1]):
        assert untimed(on) == untimed(off)
    assert runs[True][2] == runs[False][2]


# --- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_captured_steps_mark_a_row_per_replay(tmp_path, monkeypatch):
    """On the card, a captured train and light eval step with marks write
    a new row of stamps at each replay (increasing along and across rows),
    the replayed epochs' records say so, each replay counts one launch
    per slot, and the graphs' other launch counts per replay are those of
    the same graphs with the marks taken out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mark kernel has no CPU mode")
    hier, ds, batches = _data(tmp_path, 16, 12)
    graphs = {}
    for marks in (True, False):
        with monkeypatch.context() as m:
            if not marks:
                _unmarked(m)
            tr = _trainer(hier, "cuda", bsr_min_n=128)
            assert tr.graphs
            staged = tr.stage_batches(batches)
            norm = tr.norm_to_device(ds.mean, ds.std)
            gen = torch.Generator(device="cuda").manual_seed(7)
            count = phases.recorded()
            epochs = []
            for epoch in range(3):  # warm-up and capture, then replays
                packed, pending = _epoch(tr, staged, norm, gen)
                tr.finalize_train_metrics(packed)
                tr.finalize_eval_scanned(pending, with_errors=False)
                epochs.append((packed.beside, pending["outs"].beside))
        for epoch, besides in enumerate(epochs):
            if not marks:
                continue
            for beside in besides:
                stamps = beside["stamps"].numpy()
                assert (stamps > 0).all()
                assert (np.diff(stamps.reshape(-1)) >= 0).all()
                assert (np.diff(stamps[:, 0]) > 0).all()  # a row a step
                assert beside["replayed"] == (epoch > 0)
        graphs[marks] = {k: tr._scans[k].graph.per_replay
                         for k in ("train", "light")}
        recs = phases.since(count)
        if marks:
            assert [(r["kind"], r["replayed"]) for r in recs] == [
                ("train", False), ("light", False), ("train", True),
                ("light", True), ("train", True), ("light", True)]
            for rec in recs:
                assert all((ms > 0).all() for ms in rec["phases"].values())
        else:
            assert recs == []
    marks_at = len(graphs[True]["train"]) - 1  # phases.LAUNCHES, last
    for kind, slots in (("train", TRAIN_SLOTS), ("light", EVAL_SLOTS)):
        assert graphs[True][kind][marks_at] == dict.fromkeys(slots, 1)
        assert graphs[False][kind][marks_at] == {}
        assert graphs[True][kind][:marks_at] == graphs[False][kind][:marks_at]
    assert sum(sum(d.values()) for d in graphs[True]["train"][:-1]) > 0


@pytest.mark.cuda
def test_captured_joint_steps_mark_the_gcn_at_each_replay(tmp_path):
    """On the card, the joint trainer's captured train step stamps gcn in
    the forward and gcn_grad from the backward (on the capture's stream)
    at each replay: every row inside its phases, one launch of each per
    replay in the graph's counts, and LAUNCHES counting both once a step
    over warm-up, capture and replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mark kernel has no CPU mode")
    hier, ds, batches = _data(tmp_path, 16, 12)
    tr = _joint_trainer(hier, "cuda", bsr_min_n=128)
    assert tr.graphs
    staged = tr.stage_batches(batches)
    norm = tr.norm_to_device(ds.mean, ds.std)
    gen = torch.Generator(device="cuda").manual_seed(7)
    phases.reset_launches()
    count = phases.recorded()
    for _ in range(3):  # warm-up and capture, then replays
        packed, pending = _epoch(tr, staged, norm, gen)
        tr.finalize_train_metrics(packed)
        tr.finalize_eval_scanned(pending, with_errors=False)
    steps = len(batches)
    assert phases.LAUNCHES["gcn"] == phases.LAUNCHES["gcn_grad"] == 3 * steps
    per_replay = tr._scans["train"].graph.per_replay[-1]
    assert per_replay == dict.fromkeys(TRAIN_SLOTS + JOINT_MARKS, 1)
    assert tr._scans["light"].graph.per_replay[-1] == dict.fromkeys(
        EVAL_SLOTS, 1)
    trains = [r for r in phases.since(count) if r["kind"] == "train"]
    assert [r["replayed"] for r in trains] == [False, True, True]
    for rec in trains:
        sub = rec["sub_phases"]
        assert (sub["gcn_forward"] > 0).all()
        assert (sub["gcn_backward"] > 0).all()
        assert (sub["gcn_forward"] <= rec["phases"]["forward"]).all()
        assert (sub["gcn_backward"] <= rec["phases"]["backward"]).all()
