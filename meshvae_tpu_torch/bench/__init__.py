"""Probes of the port's kernels (``python -m meshvae_tpu_torch.bench.<name>``)."""
