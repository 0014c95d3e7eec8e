"""The port is complete: every public top-level name of meshvae_tpu/
(functions, classes and UPPER_CASE constants) is defined in the port module
at the same path under meshvae_tpu_torch/, or has a row in REPLACED that
names where the port does that work and why it differs; every file of
meshvae_tpu/ has its port file or a replacement (FILES); the root entry
points have their ``python -m`` modules (ENTRY_POINTS). Source is read
with ast only: nothing of either package, and no JAX, is imported."""
import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "meshvae_tpu")
PORT_PKG = os.path.join(REPO, "meshvae_tpu_torch")

_KNOB = ("a TPU tuning knob of the Pallas kernels (VMEM budgets, panels, "
         "grid steps, A/B switches), outside the contract by ROADMAP's "
         "ground rules: the Hopper kernel picks its own tiles")

# "module:name" of meshvae_tpu -> (port location "file[:symbol]" under
# meshvae_tpu_torch/, why the port does it there)
REPLACED = {
    **{f"ops/pallas_cheb.py:{name}": ("ops/csrc/bsr_spmm.cu", _KNOB)
       for name in ("COLMAJOR_VMEM_BUDGET", "FORCE_COLMAJOR", "GROUPED",
                    "GROUP_MAX_PANEL", "GROUP_ROWS", "GROUP_VMEM_BUDGET",
                    "MAX_PANEL")},
    "ops/block_sparse.py:MAX_GROUP": ("ops/csrc/bsr_spmm.cu", _KNOB),
    "ops/pallas_cheb.py:BF16_STATE": (
        "ops/bsr_spmm.py:bsr_grouped_spmm",
        "an A/B switch whose default the port fixes: mode bf16 keeps the "
        "whole recurrence state in bf16"),
    "ops/pallas_cheb.py:FUSED_BWD": (
        "ops/cheb.py:_BasisMix",
        "an A/B switch whose default the port fixes: the backward is always "
        "the fused reverse recurrence (two-seed kernel calls)"),
    "ops/pallas_cheb.py:INTERPRET": (
        "ops/bsr_spmm.py:bsr_grouped_spmm_reference",
        "Pallas's interpreter on the CPU; a CUDA kernel has none, so a CPU "
        "tensor runs the kernel's plain twin"),
    "ops/pallas_cheb.py:FUSED_SEED_DOT": (
        "ops/cheb.py:FUSED_SEED_DOT",
        "the same switch (MESHVAE_FUSED_SEED_DOT), read where the port's "
        "backward takes it"),
    "ops/pallas_cheb.py:bsr_matmul": (
        "ops/bsr_spmm.py:bsr_grouped_spmm",
        "y = L x through the kernel; its backward is L again (symmetric)"),
    "ops/pallas_cheb.py:cheb_step": (
        "ops/bsr_spmm.py:bsr_grouped_spmm",
        "T_k = 2 L T_{k-1} - T_{k-2} as one kernel call (alpha, t_prev)"),
    "ops/pallas_cheb.py:cheb_conv_pallas": (
        "ops/cheb.py:cheb_conv_bsr",
        "the Chebyshev conv on the block-sparse kernel"),
    "ops/pallas_fused.py:cheb_conv_fused": (
        "ops/cheb_fused.py:cheb_conv_fused",
        "the fused conv on ops/csrc/cheb_fused.cu"),
    **{f"ops/pallas_shard.py:{name}": (f"ops/bsr_shard.py:{name}",
                                       "the sp row shard over "
                                       "torch.distributed")
       for name in ("ShardedBlockSparse", "bsr_matmul_sharded",
                    "cheb_step_sharded", "shard_block_sparse")},
    "ops/pallas_shard.py:cheb_conv_pallas_sharded": (
        "ops/bsr_shard.py:cheb_conv_bsr_sharded",
        "the sharded conv, named as its unsharded cheb_conv_bsr"),
    "ops/graph.py:PALLAS_MIN_N": (
        "ops/graph.py:BSR_MIN_N",
        "the same hybrid cutoff (1024), named for the layout; "
        "build_operators(bsr_min_n=) overrides it"),
    **{f"ops/graph.py:{name}": (
        "models/operators.py:build_operators",
        "an operator holds the one layout its cheb_method reads "
        "(build_operators(cheb_method=, bsr_min_n=)), not a set of them")
       for name in ("ALL_LAYOUTS", "CHEB_METHOD_LAYOUTS",
                    "layouts_for_method")},
    "ops/cheb.py:propagate_dense": (
        "ops/cheb.py:cheb_conv", "the dense branch of cheb_conv"),
    "ops/pool.py:TRANSPOSE_GRAD": (
        "ops/pool.py:_PoolApply",
        "the gather pool's backward always applies the stored P^T (weighted "
        "gathers, or the kernel above TGRAD_ELL_MAX); the switch's other "
        "side, autodiff's scatter-add, is an atomic index_add in torch, "
        "whose sums depend on thread order"),
    **{f"validate.py:{name}": (
        "validate.py:ell_step_bytes",
        "the TPU's ELL crash envelope; the port refuses an ELL config whose "
        "level-0 bytes exceed the card")
       for name in ("ELL_SAFE_BATCH_VERTICES", "ELL_LARGE_N",
                    "ELL_SAFE_BATCH_VERTICES_LARGE_N")},
    "parallel/sharding.py:make_device_mesh": (
        "parallel/sharding.py:make_world",
        "a ('dp', 'sp') world of torch.distributed ranks"),
    "parallel/sharding.py:batch_sharding": (
        "parallel/sharding.py:shard_batch",
        "each rank takes its dp rows of the batch"),
    "parallel/sharding.py:put_sharded": (
        "parallel/sharding.py:shard_batch",
        "each rank holds the global batch and keeps its dp rows"),
    "parallel/sharding.py:replicated_sharding": (
        "parallel/sharding.py:replicate",
        "a broadcast from rank 0 replaces a replicated placement"),
    "parallel/sharding.py:replicate_tree": (
        "parallel/sharding.py:replicate",
        "a broadcast of the tensors from rank 0"),
    "train/loop.py:call_synced": (
        "train/graphs.py:StepGraph",
        "JAX's compile-then-barrier for multi-process AOT; the port's steps "
        "run eagerly or as CUDA graphs, with no compile to skew the ranks"),
    "train/torch_import.py:import_torch_vae_state": (
        "train/torch_import.py:import_reference_state",
        "the reference state_dict into the port's names (VAE and GCN)"),
    "models/gcn.py:ChebConvGlorot": (
        "models/gcn.py:ChebGCN",
        "a flax module per initialiser; ChebGCN draws its ChebConvLayers' "
        "glorot weights and zero biases after construction"),
    "native/build.py:build": (
        "native/__init__.py:build", "g++ of native/meshops.cpp"),
    "native/build.py:SRC": (
        "native/__init__.py:SOURCE",
        "the host library's C++ source (QSlim, transfer, OBJ parse)"),
    "native/build.py:OUT": (
        "native/__init__.py:library_path",
        "the library under ops/_build/, named by the source's hash"),
    "native/build.py:HERE": (
        "native/__init__.py:_HERE",
        "the package directory, which the source and build paths start at"),
}

# files of meshvae_tpu/ with no port file at the same path -> what holds
# their work in the port
FILES = {
    "native/build.py": ["native/__init__.py", "ops/_build.py"],
    "ops/pallas_cheb.py": ["ops/csrc/bsr_spmm.cu", "ops/bsr_spmm.py",
                           "ops/cheb.py"],
    "ops/pallas_fused.py": ["ops/csrc/cheb_fused.cu", "ops/cheb_fused.py"],
    "ops/pallas_shard.py": ["ops/bsr_shard.py"],
}

# the repo's root scripts -> the port's `python -m` modules
ENTRY_POINTS = {
    "main.py": "train/__main__.py",
    "crecon.py": "crecon.py",
    "inference.py": "infer/__main__.py",
    "report.py": "report.py",
    "plotLosses.py": "plot_losses.py",
}


def _tree(path):
    with open(path) as fp:
        return ast.parse(fp.read(), filename=path)


def _defined(path, public_only=True) -> set:
    """Top-level functions, classes and UPPER_CASE constants."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                names.update(n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name)
                             and re.fullmatch(r"_?[A-Z][A-Z0-9_]*", n.id))
    return {n for n in names if not (public_only and n.startswith("_"))}


def _sources(root):
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), root)


def _missing():
    out = {}
    for rel in _sources(JAX_PKG):
        port = os.path.join(PORT_PKG, rel)
        have = _defined(port, False) if os.path.exists(port) else set()
        for name in _defined(os.path.join(JAX_PKG, rel)):
            if name not in have:
                out[f"{rel}:{name}"] = rel
    return out


def test_every_public_name_is_ported_or_replaced():
    missing = _missing()
    unlisted = sorted(set(missing) - set(REPLACED))
    assert not unlisted, f"no port and no REPLACED row: {unlisted}"
    stale = sorted(set(REPLACED) - set(missing))
    assert not stale, f"REPLACED rows for names the port defines or the " \
        f"JAX package lacks: {stale}"


@pytest.mark.parametrize("key", sorted(REPLACED))
def test_replaced_row_names_a_port_location(key):
    location, reason = REPLACED[key]
    path, _, symbol = location.partition(":")
    full = os.path.join(PORT_PKG, path)
    assert os.path.isfile(full), location
    if symbol:
        assert symbol in _defined(full, False), location
    assert len(reason) > 20
    assert not re.search(r"unnecessary|not needed|unused|dead", reason)


def test_every_file_has_a_port_file():
    for rel in _sources(JAX_PKG):
        if os.path.exists(os.path.join(PORT_PKG, rel)):
            assert rel not in FILES, rel
            continue
        assert rel in FILES, f"{rel}: no port file and no FILES row"
        for target in FILES[rel]:
            assert os.path.isfile(os.path.join(PORT_PKG, target)), target
    cpp = os.path.join("native", "meshops.cpp")
    assert os.path.isfile(os.path.join(JAX_PKG, cpp))
    assert os.path.isfile(os.path.join(PORT_PKG, cpp))


@pytest.mark.parametrize("script", sorted(ENTRY_POINTS))
def test_entry_point_has_a_port_module(script):
    """The root script and its port module both run as __main__."""
    def runs_as_main(path):
        return any(isinstance(node, ast.If)
                   and "__main__" in ast.dump(node.test)
                   for node in _tree(path).body)

    assert runs_as_main(os.path.join(REPO, script))
    port = os.path.join(PORT_PKG, ENTRY_POINTS[script])
    assert os.path.isfile(port) and runs_as_main(port), port
