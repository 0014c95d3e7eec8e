"""CUDA graphs of the train and eval steps: the Hopper form of the JAX
package's one-dispatch epoch (``lax.scan`` over a staged epoch,
meshvae_tpu/train/loop.py ``_train_scan_impl`` / ``_eval_scan_impl``).

A ``StepGraph`` wraps one step function that reads its batch from a
device-staged epoch through a device-side step index and writes its outputs
into row i of preallocated [S, ...] buffers (train/loop.py), so a replay
needs no host work besides ``replay()``:

  * the first call runs the step eagerly on a side stream. This warm-up is
    a real step of the epoch: it creates Adam's state, lets the kernels set
    their shared-memory caps (cudaFuncSetAttribute) and fills the
    allocator's caches, all outside the capture;
  * the next call captures the step (a captured step does not run) and
    replays it; every later call replays. The captured step keeps its
    activations in the graph's private memory pool while the graph lives;
  * the explicit torch.Generator of the dropout masks and the noise is
    registered with the graph, so each replay draws fresh values and
    advances the generator as the eager step does;
  * Python's cyclic garbage collector is off during a capture: a cycle
    holding an earlier graph (a finished fold's staged epoch, a dropped
    trainer) would otherwise be freed inside the capture, and freeing a
    CUDA graph there invalidates the capture;
  * the kernel wrappers count their launches in Python, which runs once, at
    capture. The capture's counts are taken back (nothing ran then) and
    each replay adds them, so ``ops.bsr_spmm.LAUNCHES_BY_CALL`` and the
    other counters (the phase marks' ``phases.LAUNCHES`` among them) count
    the launches that ran;
  * under a profiler the warm-up and the capture are host spans
    ``meshvae.warm_up.<name>`` and ``meshvae.capture.<name>``
    (train/phases.py).

A graph holds the addresses of the tensors it captured. ``deps`` names the
tensors whose identity it depends on (parameters, Adam's state and lr, the
generator); ``check()`` drops the graph when one was replaced (a new
optimizer for a new fold, a resume's load_state_dict), and the next call
warms up and captures again. A capture or replay that fails raises with
its cause; nothing falls back to the eager step.

``HostCopy`` is the epoch's one device-to-host pull, started without
waiting so that it overlaps the next epoch's replays; it can carry a second
tree ``beside`` the one ``wait()`` returns (the epoch's phase stamps),
under the same event.
"""
from __future__ import annotations

import gc
import time

import torch

from ..ops import (bsr_spmm, cheb_fused, cheb_mix, emitted_spmm,
                   pool_transpose)
from . import phases


def _counters() -> tuple[dict, ...]:
    return (bsr_spmm.LAUNCHES_BY_CALL, cheb_fused.LAUNCHES,
            emitted_spmm.LAUNCHES, pool_transpose.LAUNCHES,
            pool_transpose.LAUNCHES_BY_SHAPE, cheb_mix.LAUNCHES,
            phases.LAUNCHES)


def _read_counters() -> list[dict]:
    return [dict(c) for c in _counters()]


def _set_counters(values: list[dict]) -> None:
    for c, v in zip(_counters(), values):
        c.clear()
        c.update(v)


class StepGraph:
    """One step, run eagerly once, then captured and replayed (see the
    module docstring). ``step()`` takes no arguments and returns nothing;
    ``deps()`` returns the tensors (and generator) the graph is bound to;
    ``name`` is the kind of step ("train", "light", ...)."""

    def __init__(self, step, deps, generator: torch.Generator | None = None,
                 name: str = "step"):
        self.step = step
        self.deps = deps
        self.generator = generator
        self.name = name
        self.graph = None
        self.key = None  # identities of deps() after the warm-up
        self._bound = []  # holds deps so their ids cannot be reused
        self.per_replay = None  # launches per replay, by counter
        self.capture_seconds = None
        self.replays = 0
        self._stream = None

    def _key(self) -> tuple:
        self._bound = list(self.deps())
        return tuple(id(d) for d in self._bound)

    def check(self) -> None:
        """Drop the graph (and the warm-up) when a dependency changed."""
        if self.key is not None and self._key() != self.key:
            self.graph = self.key = self.per_replay = None

    def __call__(self) -> None:
        if self.graph is not None:
            self._replay()
        elif self.key is None:
            self._warm_up()
        else:
            self._capture()
            self._replay()

    def _warm_up(self) -> None:
        self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        with phases.span(f"warm_up.{self.name}"), \
                torch.cuda.stream(self._stream):
            self.step()
        torch.cuda.current_stream().wait_stream(self._stream)
        self.key = self._key()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            with phases.span(f"capture.{self.name}"), \
                    torch.cuda.graph(graph, stream=self._stream):
                self.step()
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of the {self.name} "
                               f"step failed: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
            after = _read_counters()
            _set_counters(before)
        self.per_replay = [{k: n - b.get(k, 0) for k, n in a.items()
                            if n != b.get(k, 0)}
                           for a, b in zip(after, before)]
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def _replay(self) -> None:
        try:
            self.graph.replay()
        except Exception as exc:
            raise RuntimeError(f"replay of the {self.name} step's graph "
                               f"failed: {exc}") from exc
        for counter, delta in zip(_counters(), self.per_replay):
            for k, n in delta.items():
                counter[k] = counter.get(k, 0) + n
        self.replays += 1


def map_tensors(fn, tree):
    """fn applied to every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class HostCopy:
    """A tree of tensors (dicts, lists, tuples) copied to host memory. CUDA
    tensors go to pinned memory without waiting (non_blocking, in stream
    order after the work that wrote them) and one event marks the end;
    ``wait()`` waits for that event only, not for work queued later, and
    returns the tree of host tensors. CPU tensors are cloned. A second
    tree ``beside`` (its leaves that are not tensors kept as they are) is
    copied under the same event and read as ``.beside`` after ``wait()``."""

    def __init__(self, tree, beside=None):
        self._event = None

        def copy(t):
            if t.device.type != "cuda":
                return t.detach().clone()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            if self._event is None:
                self._event = torch.cuda.Event()
            return host

        self._tree = map_tensors(copy, tree)
        self.beside = map_tensors(copy, beside)
        if self._event is not None:
            self._event.record()

    def wait(self):
        with phases.span("pull"):
            if self._event is not None:
                self._event.synchronize()
        return self._tree
