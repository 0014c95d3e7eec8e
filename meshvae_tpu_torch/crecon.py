"""python -m meshvae_tpu_torch.crecon -c CFG [-t] [-s] [-p KEY VALUE]
[--device cpu | --cpu]: the second-stage reconstruction-difference
classifier (crecon.py's flags): train (-t) and test (-s) a ChebGCN over 5
folds on the difference features of the frozen VAE named by the config's
checkpoint_file (the port's .pt or the JAX package's .msgpack). Runs on
the CUDA card unless --device cpu (or --cpu) is given
(train/crecon_driver.py)."""
import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m meshvae_tpu_torch.crecon",
        description="crecon trainer (PyTorch / CUDA port)")
    parser.add_argument("-c", "--conf", help="path of config file")
    parser.add_argument("-t", "--train", action="store_true")
    parser.add_argument("-s", "--test", action="store_true")
    parser.add_argument("-p", "--parameter", metavar=("parameter", "value"),
                        action="append", nargs=2, help="config overrides")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for the CPU)")
    parser.add_argument("--cpu", action="store_const", const="cpu",
                        dest="device", help="the same as --device cpu")
    args = parser.parse_args(argv)

    from .config import apply_overrides, read_config
    from .train.crecon_driver import run

    if args.conf is None:
        args.conf = os.path.join(os.path.dirname(__file__), os.pardir,
                                 "files", "crecon.cfg")
        print("configuration file not specified, trying", args.conf)
    config = apply_overrides(read_config(args.conf), args.parameter)
    run(config, do_train=args.train, do_test=args.test, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
