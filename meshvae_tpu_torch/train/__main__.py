"""python -m meshvae_tpu_torch.train -c CFG [-t] [-s] [-v] [-p KEY VALUE]
[--device cpu | --cpu]: k-fold training (-t) and testing (-s) with the
flags of main.py; -v writes the test path's sex-change .obj triples. Runs
on the CUDA card unless --device cpu (or --cpu) is given. With data_parallel x seq_parallel
> 1 (-p data_parallel 2 -p seq_parallel 2) it starts that many local ranks
itself, one card each (gloo ranks with --device cpu); with multihost it is
one rank of a world across hosts (train/driver.py)."""
import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m meshvae_tpu_torch.train",
        description="Mesh-VAE k-fold trainer (PyTorch / CUDA port)")
    parser.add_argument("-c", "--conf", help="path of config file")
    parser.add_argument("-t", "--train", action="store_true")
    parser.add_argument("-s", "--test", action="store_true")
    parser.add_argument("-v", "--vis", action="store_true",
                        help="save transformed meshes")
    parser.add_argument("-p", "--parameter", metavar=("parameter", "value"),
                        action="append", nargs=2, help="config overrides")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for the CPU)")
    parser.add_argument("--cpu", action="store_const", const="cpu",
                        dest="device", help="the same as --device cpu")
    args = parser.parse_args(argv)

    from ..config import apply_overrides, read_config
    from .driver import run

    if args.conf is None:
        args.conf = os.path.join(os.path.dirname(__file__), os.pardir,
                                 os.pardir, "files", "default.cfg")
        print("configuration file not specified, trying", args.conf)
    config = apply_overrides(read_config(args.conf), args.parameter)
    run(config, do_train=args.train, do_test=args.test, vis=args.vis,
        device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
