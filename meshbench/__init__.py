"""The benchmark of meshvae_tpu_torch, the PyTorch/H100 port: one command
runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output.

    python3 -m meshbench.run --workload vae80k.train --seed 7 \
        --seconds 10 --trace 0

The harness measures the port only; it loads nothing of the JAX package
or of JAX. See registry.py for how its pieces are found by name.
"""
