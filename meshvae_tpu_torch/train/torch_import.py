"""Import a reference PyTorch checkpoint into the port's model (counterpart
of meshvae_tpu/train/torch_import.py).

Maps the reference cheb_VAE or cheb_GCN state_dict (a checkpoint's
``checkpoint['state_dict']``, or a bare ``initial_weight.pt``) onto the
port's parameter names, so weights trained with the reference keep
working:

  python -m meshvae_tpu_torch.train.torch_import REF.pt OUT -c CFG
      [--type cheb_VAE|cheb_GCN] [--device cpu | --cpu]

OUT is a params file (``train/checkpoint.py`` ``save_params``) that
``load_params`` and ``load_model_state`` read: written as
``checkpoint_{n}.pt`` under a config's checkpoint_dir, the inference CLI
serves it (``-n n``), and crecon takes it as its ``checkpoint_file``.

Name map (reference -> port):
  cheb.{i}.weight [K,in,out]   -> cheb_enc_{i}.weight  (cheb_{i} for the GCN)
  cheb.{i}.bias [out]          -> cheb_enc_{i}.bias
  cheb_dec.{i}.weight/.bias    -> cheb_dec_{i}.weight/.bias (the last: no bias)
  <lin>.weight [out,in], .bias -> <lin>.weight, .bias: the port's linear heads
  are nn.Linear, [out, in] as the reference's (models/vae.py ``dense``
  multiplies by weight.t()), so nothing is transposed; for lin in enc_lin,
  dec_lin, dec_lin_2, classifier_layer, z_mean, z_log_var (cheb_VAE) or
  enc_lin, cls_layer (cheb_GCN)
Names the port's model lacks (the reference's dead dec_lin_1 head,
buffers) are skipped; a shape that differs raises.

A reference-trained checkpoint is only meaningful on the reference's exact
mesh hierarchy, so the CLI builds with hierarchy_mode = reference unless
the config file sets the key itself; keep the key in the config that runs
the imported model.
"""
from __future__ import annotations

import configparser

import torch

_LINEARS = {"cheb_VAE": ("enc_lin", "dec_lin", "dec_lin_2",
                         "classifier_layer", "z_mean", "z_log_var"),
            "cheb_GCN": ("enc_lin", "cls_layer")}
_ENC_PREFIX = {"cheb_VAE": "cheb_enc_", "cheb_GCN": "cheb_"}


def _port_name(name: str, model_type: str) -> str | None:
    """The port's name of a reference parameter, None for one it lacks."""
    parts = name.split(".")
    if parts[0] in ("cheb", "cheb_dec") and len(parts) == 3:
        prefix = _ENC_PREFIX[model_type] if parts[0] == "cheb" else "cheb_dec_"
        return f"{prefix}{parts[1]}.{parts[2]}"
    return name if name.rpartition(".")[0] in _LINEARS[model_type] else None


def import_reference_state(state_dict: dict, target: dict,
                           model_type: str = "cheb_VAE") -> dict:
    """A new state_dict of the port's model with the reference's values.

    `target` is the state_dict of a port model of the matching
    architecture (a MeshVAE for cheb_VAE, a ChebGCN for cheb_GCN): it
    gives the names and shapes, and its values stay where the reference
    has none."""
    if model_type not in _LINEARS:
        raise ValueError(f"unknown model type {model_type!r}; expected one "
                         f"of {sorted(_LINEARS)}")
    out = {k: v.detach().cpu().clone() for k, v in target.items()}
    for name, tensor in state_dict.items():
        port = _port_name(name, model_type)
        if port not in out:
            continue  # dead params (dec_lin_1), buffers, ...
        value = torch.as_tensor(tensor).detach().cpu().to(torch.float32)
        if tuple(value.shape) != tuple(out[port].shape):
            raise ValueError(
                f"shape mismatch importing {name} -> {port}: "
                f"{tuple(value.shape)} vs {tuple(out[port].shape)}")
        out[port] = value.clone()
    return out


def sets_hierarchy_mode(conf_path: str) -> bool:
    """Whether the INI file assigns hierarchy_mode in any section (parsed,
    so that a comment naming the key does not count)."""
    parser = configparser.RawConfigParser()
    parser.read(conf_path)
    return any(key == "hierarchy_mode" for section in parser.sections()
               for key, _ in parser.items(section))


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m meshvae_tpu_torch.train.torch_import",
        description="Import a reference PyTorch checkpoint")
    parser.add_argument("torch_ckpt")
    parser.add_argument("output", help="output params file (.pt)")
    parser.add_argument("-c", "--conf", required=True)
    parser.add_argument("--type", default="cheb_VAE",
                        choices=sorted(_LINEARS))
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for the CPU)")
    parser.add_argument("--cpu", action="store_const", const="cpu",
                        dest="device", help="the same as --device cpu")
    args = parser.parse_args(argv)

    from ..config import read_config
    from ..models.gcn import ChebGCN, GCNConfig
    from .checkpoint import save_params
    from .driver import build_model_and_ops

    # a reference checkpoint holds tensors, dicts and numbers only (the
    # state_dict, the optimizer's, the epoch and losses)
    payload = torch.load(args.torch_ckpt, map_location="cpu",
                         weights_only=True)
    state_dict = payload.get("state_dict", payload)
    config = read_config(args.conf)
    if not sets_hierarchy_mode(args.conf):
        config["hierarchy_mode"] = "reference"
        print("hierarchy_mode=reference (bit-exact reference QSlim; set "
              "hierarchy_mode in the config to override)")
    # the reference's models are a plain VAE and a GCN, whatever the
    # config's type
    model, _, hier, template = build_model_and_ops(
        dict(config, type=args.type), args.device)
    if args.type == "cheb_GCN":
        model = ChebGCN(GCNConfig.from_config(
            config, coarse_verts=hier.levels[-1],
            num_features=2 * template.v.shape[1]))
    params = import_reference_state(state_dict, model.state_dict(),
                                    model_type=args.type)
    save_params(args.output, params)
    print("wrote", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
