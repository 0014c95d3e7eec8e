"""The Chebyshev basis mix and its weight gradient over the K orders as
they lie (meshvae_tpu_torch/ops/cheb_mix.py), in plain PyTorch:

  * the twins ``cheb_mix_reference`` / ``cheb_mix_dw_reference`` against
    the concatenated basis's products that ``_BasisMix`` computed before
    (``torch.matmul(torch.cat(txs, -1), W)`` and ``txcat^T @ g``), at K
    1 / 6 / 10, F_pad 4 / 8 / 16 / 32 / 128, F_out 3 / 16 / 32 and M off
    any row panel, in fp32 (bit for bit: a CPU run keeps the conv's
    summation order) and bf16 (one ulp of the scale);
  * the wrapper's shape checks, the registered operator (opcheck), and an
    export that records ``meshvae_torch::cheb_mix`` in the conv;
  * ``cheb_conv_bsr``'s forward and gradients against the conv written out
    with a dense operator in float64;
  * ``StepGraph`` adding ``cheb_mix.LAUNCHES`` at each replay, and the
    benchmark's reader ``mix_ms`` finding the kernels by name;
  * on a card (marked cuda): the kernels against the twins at the cells'
    shapes (the 80k template's levels 0-3 in bf16 at B = 32, template5k's
    levels 0-1 in fp32 at B = 16) and at shapes off the fast paths, two dW
    launches bit-equal, and the launch counter."""
import contextlib
import os

import numpy as np
import pytest
import torch

from meshvae_tpu_torch.mesh import vertex_adjacency
from meshvae_tpu_torch.ops import cheb_mix as cm
from meshvae_tpu_torch.ops import graph
from meshvae_tpu_torch.ops.cheb import cheb_conv_bsr
from meshvae_tpu_torch.train import graphs

from conftest import make_grid_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
M_ODD = 200  # rows: not a multiple of any row panel of the kernels


def _ulp(scale: float) -> float:
    """One bf16 ulp at `scale` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _case(k, m, f, f_out, dtype, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    txs = [torch.randn(m, f, generator=gen).to(dtype).to(device)
           for _ in range(k)]
    w = (0.3 * torch.randn(k, f, f_out, generator=gen)).to(dtype).to(device)
    g = torch.randn(m, f_out, generator=gen).to(dtype).to(device)
    return txs, w, g


def _concatenated(txs, w, g):
    """The concatenated basis's mix and dW, as _BasisMix computed them."""
    k, f, f_out = w.shape
    txcat = torch.cat(txs, dim=-1)
    out = torch.matmul(txcat, w.reshape(k * f, f_out))
    dw = torch.matmul(txcat.t(), g).reshape(k, f, f_out)
    return out, dw


def _assert_close(got, want, dtype, what):
    assert got.dtype == want.dtype == dtype, what
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    bar = 1e-6 * scale if dtype == torch.float32 else _ulp(scale)
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e} (scale {scale:.3e})"


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("f_out", [3, 16, 32])
@pytest.mark.parametrize("f", [4, 8, 16, 32, 128])
@pytest.mark.parametrize("k", [1, 6, 10])
def test_twins_match_the_concatenated_products(k, f, f_out, dtype):
    txs, w, g = _case(k, M_ODD, f, f_out, dtype, seed=k * 1000 + f + f_out)
    want_out, want_dw = _concatenated(txs, w, g)
    _assert_close(cm.cheb_mix(txs, w), want_out, dtype, "mix")
    _assert_close(cm.cheb_mix_dw(txs, g), want_dw, dtype, "dW")
    if dtype == torch.float32:  # the CPU side sums as the conv did before
        assert torch.equal(cm.cheb_mix(txs, w), want_out)
        assert torch.equal(cm.cheb_mix_dw_fp32(txs, g), want_dw)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    txs, w, g = _case(3, 64, 8, 16, torch.float32)
    with pytest.raises(ValueError, match="alike"):
        cm.cheb_mix(txs[:2] + [txs[2][:, :4].contiguous()], w)
    with pytest.raises(ValueError, match="must be"):
        cm.cheb_mix(txs[:2], w)
    with pytest.raises(TypeError):
        cm.cheb_mix([t.double() for t in txs], w.double())
    with pytest.raises(TypeError, match="bfloat16"):
        cm.cheb_mix(txs, w.to(BF))
    with pytest.raises(ValueError, match="contiguous"):
        cm.cheb_mix([t.t().contiguous().t() for t in txs], w)
    with pytest.raises(ValueError, match="orders"):
        cm.cheb_mix([txs[0]] * (cm.MAX_ORDERS + 1),
                    w[:1].expand(cm.MAX_ORDERS + 1, 8, 16))
    with pytest.raises(ValueError, match="g must be"):
        cm.cheb_mix_dw(txs, g[:10])


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
def test_operator_passes_opcheck(dtype):
    """The registered operator's schema, fake implementation and dispatch,
    and its CPU implementation equal to the twin."""
    txs, w, _ = _case(4, 96, 8, 16, dtype)
    torch.library.opcheck(cm.cheb_mix_op, (txs, w))
    assert torch.equal(torch.ops.meshvae_torch.cheb_mix(txs, w),
                       cm.cheb_mix_reference(txs, w))


@pytest.fixture(scope="module")
def grid_bsr():
    mesh = make_grid_mesh(16, jitter=0.05)  # 256 vertices, 2 block rows
    adj = vertex_adjacency(mesh.num_vertices, mesh.f)
    op = graph.cheb_operator(adj, "cpu", bsr_min_n=1)
    assert op.bsr is not None
    dense = torch.from_numpy(np.asarray(adj.todense(), np.float64))
    return op.bsr, graph.cheb_operator(adj, "cpu", bsr_min_n=None), dense


class _Conv(torch.nn.Module):
    def __init__(self, bsr, weight):
        super().__init__()
        self.bsr = bsr
        self.weight = torch.nn.Parameter(weight)

    def forward(self, x):
        return cheb_conv_bsr(x, self.bsr, self.weight, None)


def test_export_records_the_mix_operator(grid_bsr):
    """torch.export of a block-sparse conv records the mix as one call of
    meshvae_torch::cheb_mix, and the exported program gives the eager
    conv's values."""
    bsr = grid_bsr[0]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, bsr.n, 3, generator=gen)
    conv = _Conv(bsr, 0.3 * torch.randn(6, 3, 16, generator=gen)).eval()
    with torch.no_grad():
        program = torch.export.export(conv, (x,), strict=False)
        calls = [nd for nd in program.graph.nodes
                 if nd.target is torch.ops.meshvae_torch.cheb_mix.default]
        assert len(calls) == 1
        assert torch.equal(program.module()(x), conv(x))


def test_conv_matches_the_dense_float64_conv(grid_bsr):
    """cheb_conv_bsr (the kernel's twin, the mix's twins) against the conv
    written out on the dense operator in float64: the output, dx and dW,
    at 1e-5 of their scales."""
    bsr, dense_op, _ = grid_bsr
    lap = dense_op.dense.double()
    gen = torch.Generator().manual_seed(5)
    k, b, f_in, f_out = 6, 4, 3, 16
    x = torch.randn(b, bsr.n, f_in, generator=gen)
    w = 0.3 * torch.randn(k, f_in, f_out, generator=gen)
    g = torch.randn(b, bsr.n, f_out, generator=gen)

    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = cheb_conv_bsr(xs, bsr, ws, None, precision="highest")
    out.backward(g)

    xd, wd = x.double().requires_grad_(), w.double().requires_grad_()
    txs = [xd, torch.matmul(lap, xd)]
    for _ in range(2, k):
        txs.append(2.0 * torch.matmul(lap, txs[-1]) - txs[-2])
    ref = sum(torch.matmul(t, wd[i]) for i, t in enumerate(txs))
    ref.backward(g.double())
    for got, want in ((out, ref), (xs.grad, xd.grad), (ws.grad, wd.grad)):
        scale = want.abs().max().item()
        assert (got.double() - want).abs().max().item() <= 1e-5 * scale


def test_mix_ms_reads_the_mix_kernels_by_name(monkeypatch):
    """mix_ms.<cfg>, found by name in both cells, reads the device time of
    the kernels named cheb_mix per traced step, and nothing where a
    program launches none (the concatenation and cuBLAS instead)."""
    monkeypatch.syspath_prepend(ROOT)
    from meshbench.registry import Registry
    from meshbench.trace import Window

    reg = Registry()
    for cfg in ("vae80k", "vae5k"):
        (entry,) = [m for m in reg.bench["per_layer"]
                    if m["name"] == f"mix_ms.{cfg}"]
        assert entry == {"name": f"mix_ms.{cfg}", "unit": "ms",
                         "better": "lower", "source": "device_trace",
                         "layer": "model",
                         "moves": f"train_meshes_per_s.{cfg}",
                         "workloads": [f"{cfg}.train"]}
        assert entry in reg.per_layer(f"{cfg}.train")
    read = reg.metric_reader("mix_ms.vae80k")
    ns = "void (anonymous namespace)::"
    win = Window([(0.0, 0.002, ns + "cheb_mix_bf16_kernel<8, 2>(...)"),
                  (0.002, 0.003, ns + "cheb_mix_dw_bf16_kernel<12>(...)"),
                  (0.003, 0.0035, ns + "cheb_mix_dw_reduce_kernel<bf16>"),
                  (0.004, 0.010, "bsr_grouped_spmm_kernel<2, false>"),
                  (0.010, 0.020, "CatArrayBatchedCopy_vect")], [], 0.02)
    assert read({"trace": win, "sub_steps": 2}) == pytest.approx(1.75)
    older = Window([(0.0, 0.01, "CatArrayBatchedCopy_vect"),
                    (0.01, 0.02, "nvjet_tst_16x512")], [], 0.02)
    assert read({"trace": older, "sub_steps": 2}) is None
    assert read({"trace": win, "sub_steps": 0}) is None
    assert read({}) is None


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


def test_step_graph_adds_mix_launches_per_replay(monkeypatch):
    """A captured step's cheb_mix launches, counted once at capture, are
    taken back and added at each replay (the CUDA graph API stubbed)."""
    cuda = graphs.torch.cuda
    monkeypatch.setattr(cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(cuda, "graph",
                        lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "Stream", _FakeStream)
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(cm, "LAUNCHES", dict(cm.LAUNCHES))
    assert cm.LAUNCHES in graphs._counters()
    cm.reset_launches()
    fwd, dw = ("fwd", "bf16", 10, 16, 16), ("dw", "bf16", 10, 16, 16)

    def step():  # what the wrappers count for one conv's launches
        cm._count(*fwd)
        cm._count(*fwd)
        cm._count(*dw)

    sg = graphs.StepGraph(step, lambda: [], name="train")
    sg()  # the warm-up runs the step
    assert cm.LAUNCHES == {fwd: 2, dw: 1}
    sg()  # capture (nothing runs) and the first replay
    assert sg.per_replay[graphs._counters().index(cm.LAUNCHES)] == {
        fwd: 2, dw: 1}
    assert cm.LAUNCHES == {fwd: 4, dw: 2}
    sg()
    sg()
    assert cm.LAUNCHES == {fwd: 8, dw: 4} and sg.replays == 3


# --- the card ----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (n_pad, B, K, [(F_pad, F_out), ...]) of each block-sparse level the cells
# run through _BasisMix: scaled80k bf16 and template5k fp32
CELL_SHAPES = {
    "80k L0": (80000, 32, 10, [(4, 16), (16, 16), (16, 3)], BF),
    "80k L1": (20096, 32, 10, [(16, 16)], BF),
    "80k L2": (5120, 32, 10, [(16, 16), (32, 16)], BF),
    "80k L3": (1280, 32, 10, [(16, 32), (32, 32)], BF),
    "5k L0": (5120, 16, 6, [(8, 16), (16, 16), (16, 3)], torch.float32),
    "5k L1": (1280, 16, 6, [(16, 16), (32, 16)], torch.float32),
}


def _hold_kernels(k, m, f, f_out, dtype, seed, dev):
    txs, w, g = _case(k, m, f, f_out, dtype, seed=seed, device=dev)
    before = dict(cm.LAUNCHES)
    out = cm.cheb_mix(txs, w)
    dw = cm.cheb_mix_dw(txs, g)
    dw2 = cm.cheb_mix_dw(txs, g)
    torch.cuda.synchronize()
    mode = cm.DTYPES[dtype]
    for kind, n in (("fwd", 1), ("dw", 2)):
        key = (kind, mode, k, f, f_out)
        assert cm.LAUNCHES.get(key, 0) - before.get(key, 0) == n
    assert torch.equal(dw, dw2), "two dW launches differ"
    cpu = [t.cpu() for t in txs]
    tag = f"K={k} M={m} F_pad={f} F_out={f_out} {mode}"
    for got, want, what in (
            (out, cm.cheb_mix_reference(cpu, w.cpu()), "mix"),
            (dw, cm.cheb_mix_dw_reference(cpu, g.cpu()), "dW")):
        scale = want.float().abs().max().item()
        err = (got.cpu().float() - want.float()).abs().max().item()
        bar = 1e-5 * scale if dtype == torch.float32 else _ulp(scale)
        assert err <= bar, f"{what} {tag}: {err:.3e} > {bar:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("level", list(CELL_SHAPES))
def test_kernels_match_twins_at_the_cells_shapes(level):
    dev = _cuda()
    n_pad, b, k, pairs, dtype = CELL_SHAPES[level]
    for i, (f, f_out) in enumerate(pairs):
        _hold_kernels(k, n_pad * b, f, f_out, dtype, i, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
def test_kernels_match_twins_off_the_fast_paths(dtype):
    """F_pad 3 (B = 128), 5, 24 and 128 (B = 1), F_out 3, 5 and 64, one
    order, rows off every panel, and a misaligned order (the element
    copy)."""
    dev = _cuda()
    for i, (k, m, f, f_out) in enumerate(
            ((6, 128 * 40, 3, 16), (10, 777, 5, 3), (3, 4096, 24, 64),
             (10, 640, 128, 32), (1, 999, 16, 16), (4, 1000, 8, 5))):
        _hold_kernels(k, m, f, f_out, dtype, 10 + i, dev)
    txs, w, g = _case(3, 1001, 16, 16, dtype, seed=30, device=dev)
    flat = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                      txs[1].reshape(-1)])
    txs[1] = flat[1:].view(1001, 16)  # 2 bytes past a 16-byte boundary
    assert txs[1].data_ptr() % 16
    out, dw = cm.cheb_mix(txs, w), cm.cheb_mix_dw(txs, g)
    cpu = [t.cpu() for t in txs]
    for got, want in ((out, cm.cheb_mix_reference(cpu, w.cpu())),
                      (dw, cm.cheb_mix_dw_reference(cpu, g.cpu()))):
        scale = want.float().abs().max().item()
        bar = 1e-5 * scale if dtype == torch.float32 else _ulp(scale)
        assert (got.cpu().float() - want.float()).abs().max().item() <= bar
