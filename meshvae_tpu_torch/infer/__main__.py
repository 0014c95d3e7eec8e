"""python -m meshvae_tpu_torch.infer -c CFG -d DATA_DIR -o OUT -n FOLD
[-p KEY VALUE] [--pred] [--error_list] [--inference] [--no-meshes]
[--serve [--artifact PATH]] [--export PATH] [--export-serve PATH]
[--export-platforms cpu,cuda] [--device cpu | --cpu]: batch inference
with the semantics of the JAX package's inference.py, for a MeshVAE or a
joint model (type = joint_VAE) at either compute_dtype.

  * with no selection flag (--pred, --error_list, --inference) all three
    JSON files are written, else only the selected ones; --no-meshes skips
    the sex_change/ .obj triples;
  * checkpoint_dir resolves relative to the config file's directory (the
    reference's quirk), root_dir is DATA_DIR;
  * the fold's checkpoint is checkpoint_{FOLD}.pt, or the JAX package's
    checkpoint_{FOLD}.msgpack (train/checkpoint.find_checkpoint); a params
    file under that name (an imported reference checkpoint,
    train/torch_import.py) serves too; the normalisation is
    checkpoint_dir/norm.npz;
  * --serve starts the port's MeshServer (infer/serve.py) on that
    checkpoint and norm instead: mesh paths on stdin, JSON lines on stdout;
  * --export PATH writes the serving step ((x, r, s, m) -> pred,
    recon_orig, oppo_orig) as a torch.export artifact (infer/export.py),
    --export-serve PATH the serving loop's step (packed pred / errors, the
    ground truth recomputed on the device, the serve_wire_dtype wire; the
    meshes unless --no-meshes), each with the checkpoint's weights, the
    norm and the operators baked in, and exit;
  * --serve --artifact PATH serves an --export-serve artifact: it reads
    only the config, the template and norm.npz, and builds no hierarchy,
    operators or model and loads no checkpoint;
  * --export-platforms names the devices the artifact runs on, among cpu
    and cuda (default: the --device); cuda is exported on the card.

Runs on the CUDA card unless --device cpu (or --cpu) is given. The config's
data_parallel / seq_parallel / multihost give the world as they do for
training (as inference.py passes trainer.mesh): each rank runs its dp rows
with the operators row-sharded over sp, and only the primary writes files
and, with --serve, reads stdin and answers; either model type runs there.
Export and --artifact are refused in a world: they are one process's step.
"""
import argparse
import os
import sys


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
    parser.add_argument("--export", metavar="PATH", default=None,
                        help="write the serving step as a torch.export "
                             "artifact at PATH and exit")
    parser.add_argument("--export-serve", metavar="PATH", default=None,
                        help="write the serving loop's step (what --serve "
                             "--artifact loads) at PATH and exit")
    parser.add_argument("--artifact", metavar="PATH", default=None,
                        help="with --serve: serve an --export-serve "
                             "artifact instead of building the model")
    parser.add_argument("--export-platforms", default=None,
                        help="comma-separated devices the artifact runs "
                             "on, among cpu and cuda (default: --device)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for the CPU)")
    parser.add_argument("--cpu", action="store_const", const="cpu",
                        dest="device", help="the same as --device cpu")
    args = parser.parse_args(argv)

    exporting = args.export is not None or args.export_serve is not None
    if args.artifact is not None and not args.serve:
        print("--artifact is read by --serve only", file=sys.stderr)
        return 2
    if exporting:
        import torch

        from .export import check_platforms

        try:
            args.export_platforms = check_platforms(
                args.export_platforms.split(",") if args.export_platforms
                else [torch.device(args.device).type])
        except (ValueError, RuntimeError) as exc:
            print(f"--export-platforms: {exc}", file=sys.stderr)
            return 2
        if ("cuda" in args.export_platforms
                and torch.device(args.device).type != "cuda"):
            print("--export-platforms cuda: a cuda lowering is exported on "
                  "the card; run with --device cuda", file=sys.stderr)
            return 2

    from ..config import apply_overrides, read_config
    from ..train.driver import enter_world, names_world
    from ..validate import validate_config
    from .driver import run_cli, serve_artifact

    if args.conf is None:
        args.conf = os.path.join(os.path.dirname(__file__), os.pardir,
                                 os.pardir, "files", "default.cfg")
        print("configuration file not specified, trying", args.conf)
    config = apply_overrides(read_config(args.conf), args.parameter)
    # the reference's quirk: checkpoint_dir resolves relative to the config
    config["checkpoint_dir"] = os.path.join(os.path.dirname(args.conf),
                                            config["checkpoint_dir"])
    config["root_dir"] = args.data_dir
    validate_config(config, args.device)
    if (exporting or args.artifact) and names_world(config):
        dp = int(config.get("data_parallel", 1))
        sp = int(config.get("seq_parallel", 1))
        print("export and --artifact are single-process only: the "
              f"artifact is one process's step (data_parallel x "
              f"seq_parallel = {dp * sp}, multihost = "
              f"{config.get('multihost', False)})", file=sys.stderr)
        return 2
    if args.artifact:
        return serve_artifact(args, config)
    if names_world(config):
        return enter_world(run_cli, config, args.device, (args, config))
    return run_cli(None, args, config)


if __name__ == "__main__":
    raise SystemExit(main())
