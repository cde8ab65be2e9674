"""CLI: ``python -m raft_tpu_torch design.{json,yaml} [--csv out.csv]
[--device cpu]``: :func:`raft_tpu_torch.drivers.run` on the design, a
summary line per case and FOWT.  The analysis runs on the current CUDA
device unless ``--device`` names another; without a card and without
``--device`` it exits non-zero, naming ``device="cpu"``."""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch",
        description="frequency-domain FOWT analysis of a design's load "
                    "cases (PyTorch/CUDA)")
    p.add_argument("design", help="design JSON or YAML (RAFT schema)")
    p.add_argument("--csv", default=None, help="write channel statistics CSV")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    from raft_tpu_torch.drivers import run

    try:
        model = run(args.design, save_csv=args.csv, device=args.device)
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"error: {e}", file=sys.stderr)
        return 2
    for iCase, per_fowt in model.results["case_metrics"].items():
        for ifowt, m in per_fowt.items():
            print(f"case {iCase} fowt {ifowt}: "
                  f"surge {float(m['surge_avg']):+.2f}"
                  f"±{float(m['surge_std']):.2f} m, "
                  f"heave {float(m['heave_avg']):+.2f}"
                  f"±{float(m['heave_std']):.2f} m, "
                  f"pitch {float(m['pitch_avg']):+.2f}"
                  f"±{float(m['pitch_std']):.2f} deg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
