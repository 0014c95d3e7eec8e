"""python -m meshvae_tpu_torch.infer -c CFG -d DATA_DIR -o OUT -n FOLD
[-p KEY VALUE] [--pred] [--error_list] [--inference] [--no-meshes]
[--serve] [--device cpu]: batch inference with the semantics of the JAX
package's inference.py.

  * with no selection flag (--pred, --error_list, --inference) all three
    JSON files are written, else only the selected ones; --no-meshes skips
    the sex_change/ .obj triples;
  * checkpoint_dir resolves relative to the config file's directory (the
    reference's quirk), root_dir is DATA_DIR;
  * the fold's checkpoint is checkpoint_{FOLD}.pt, or the JAX package's
    checkpoint_{FOLD}.msgpack (train/checkpoint.find_checkpoint), and the
    normalisation is checkpoint_dir/norm.npz;
  * --serve starts the port's MeshServer (infer/serve.py) on that
    checkpoint and norm instead: mesh paths on stdin, JSON lines on stdout.

--export, --export-serve, --artifact and --export-platforms (the JAX
package's serving artifacts) are not ported yet and exit non-zero. Runs on
the CUDA card unless --device cpu is given.
"""
import argparse
import os
import sys

EXPORT_FLAGS = ("export", "export_serve", "artifact", "export_platforms")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m meshvae_tpu_torch.infer",
        description="Mesh-VAE batch inference (PyTorch / CUDA port)")
    parser.add_argument("-c", "--conf", help="path of config file")
    parser.add_argument("-p", "--parameter", metavar=("parameter", "value"),
                        action="append", nargs=2, help="config parameters")
    parser.add_argument("-o", "--output_path", type=str, default=" ")
    parser.add_argument("-d", "--data_dir", type=str, default=" ")
    parser.add_argument("-n", "--model", type=int, default=1,
                        help="fold number of the checkpoint to load")
    parser.add_argument("--pred", action="store_true",
                        help="write pred.json (default: write all outputs)")
    parser.add_argument("--error_list", action="store_true",
                        help="write error_list.json")
    parser.add_argument("--inference", action="store_true",
                        help="write inference.json")
    parser.add_argument("--no-meshes", action="store_true",
                        help="skip writing recon/gt/oppo .obj files")
    parser.add_argument("--serve", action="store_true",
                        help="serve mesh paths from stdin (infer/serve.py)")
    for flag in EXPORT_FLAGS:
        parser.add_argument("--" + flag.replace("_", "-"), default=None,
                            help="not ported yet (ROADMAP.md item 7)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for the CPU)")
    args = parser.parse_args(argv)

    asked = [f"--{f.replace('_', '-')}" for f in EXPORT_FLAGS
             if getattr(args, f) is not None]
    if asked:
        print(f"{', '.join(asked)}: serving artifacts (export) are not "
              "ported yet; see ROADMAP.md section 1, item 7 (export)",
              file=sys.stderr)
        return 2

    import json

    import numpy as np

    from ..config import apply_overrides, read_config
    from ..device import resolve_device
    from ..train.checkpoint import find_checkpoint, load_checkpoint
    from ..train.driver import build_model_and_ops
    from .driver import run_inference
    from .serve import MeshServer

    if args.conf is None:
        args.conf = os.path.join(os.path.dirname(__file__), os.pardir,
                                 os.pardir, "files", "default.cfg")
        print("configuration file not specified, trying", args.conf)
    config = apply_overrides(read_config(args.conf), args.parameter)
    # the reference's quirk: checkpoint_dir resolves relative to the config
    config["checkpoint_dir"] = os.path.join(os.path.dirname(args.conf),
                                            config["checkpoint_dir"])
    config["root_dir"] = args.data_dir
    device = resolve_device(args.device)

    model, ops, _, template = build_model_and_ops(config, device)
    ckpt = find_checkpoint(config["checkpoint_dir"], args.model)
    model.load_state_dict(load_checkpoint(ckpt)["model"])
    with np.load(os.path.join(config["checkpoint_dir"], "norm.npz")) as norm:
        mean = norm["mean"].astype(np.float32)
        std = norm["std"].astype(np.float32)
    batch_size = int(config["batch_size"])

    if args.serve:
        server = MeshServer(
            model, ops, mean, std, template=template.v, faces=template.f,
            batch_size=batch_size, output_path=args.output_path,
            save_meshes=not args.no_meshes,
            wire_dtype=np.dtype(config.get("serve_wire_dtype", "float16")),
            device=device)
        try:
            sec = server.warmup()
            print(json.dumps({"ready": True, "warmup_sec": round(sec, 2),
                              "batch_size": server.batch_size}), flush=True)
            server.serve_forever(sys.stdin, sys.stdout)
        finally:
            server.close()
        return 0

    any_selected = args.pred or args.error_list or args.inference
    run_inference(
        model, ops, args.output_path, mean, std, config,
        template=template.v, batch_size=batch_size, faces=template.f,
        write_pred=args.pred or not any_selected,
        write_error_list=args.error_list or not any_selected,
        write_inference=args.inference or not any_selected,
        save_meshes=not args.no_meshes, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
