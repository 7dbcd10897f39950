"""Experiment sweeps: the counterpart of ``scripts/experiments.py``, the
reference's ``scripts/*_exp.sh`` recipes (decay_exp.sh, odo_basic_exp.sh,
tracking_basic_exp.sh, lowfreq_exp.sh) as one script around the port's
CLI (``python -m dynslam_tpu_torch.main``), with the JAX script's flags.
Each run writes its config-encoded CSVs so the reference notebooks (and
``scripts/plot_results.py``) can aggregate them.

    python -m dynslam_tpu_torch.scripts.experiments decay \\
        --dataset_root /data/odometry/09 --out /path/to/exp
    python -m dynslam_tpu_torch.scripts.experiments odo \\
        --dataset_base /data/odometry --seqs 00 06 --out /path/to/exp
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cli(extra_args, tag, out_base):
    out = os.path.join(out_base, tag)
    cmd = [
        sys.executable, "-m", "dynslam_tpu_torch.main",
        "--out", out, "--csv_out_dir", os.path.join(out_base, "csv"),
        "--enable_evaluation",
    ] + extra_args
    print("[exp]", " ".join(cmd), flush=True)
    return subprocess.call(cmd, cwd=REPO)


def decay_exp(args):
    """decay_exp.sh:9-12: weights {1,2,3,5,8,10} x ages {40,80}."""
    for weight, age in itertools.product([1, 2, 3, 5, 8, 10], [40, 80]):
        run_cli(["--dataset_root", args.dataset_root,
                 "--max_decay_weight", str(weight),
                 "--min_decay_age", str(age),
                 "--evaluation_delay", str(age + 40),
                 "--frame_limit", str(args.frame_limit)],
                f"decay-w{weight}-a{age}", args.out)


def odo_exp(args):
    """odo_basic_exp.sh:19-29: every sequence x {elas, dispnet}, decay
    age 150, weight 99999 (decay everything old)."""
    for seq in args.seqs:
        for dispnet in (False, True):
            extra = ["--dataset_root", os.path.join(args.dataset_base, seq),
                     "--min_decay_age", "150",
                     "--max_decay_weight", "99999",
                     "--frame_limit", str(args.frame_limit or 4400)]
            if dispnet:
                extra.append("--use_dispnet")
            run_cli(extra, f"odo-{seq}-{'dispnet' if dispnet else 'elas'}",
                    args.out)


def lowfreq_exp(args):
    """lowfreq_exp.sh:18-27: fuse every k in {1..15, 20, 25}."""
    for k in list(range(1, 16)) + [20, 25]:
        run_cli(["--dataset_root", args.dataset_root,
                 "--fusion_every", str(k),
                 "--min_decay_age", "300",
                 "--max_decay_weight", "99999",
                 "--frame_limit", str(args.frame_limit)],
                f"lowfreq-k{k}", args.out)


def tracking_exp(args):
    """tracking_basic_exp.sh: the dynamic pipeline on tracking
    sequences."""
    for seq in args.seqs:
        run_cli(["--dataset_root", args.dataset_base,
                 "--dataset_type", "kitti-tracking",
                 "--kitti_tracking_sequence_id", str(seq),
                 "--frame_limit", str(args.frame_limit)],
                f"tracking-{int(seq):04d}", args.out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decay")
    d.add_argument("--dataset_root", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--frame_limit", type=int, default=1125)
    d.set_defaults(fn=decay_exp)

    o = sub.add_parser("odo")
    o.add_argument("--dataset_base", required=True)
    o.add_argument("--seqs", nargs="+",
                   default=[f"{i:02d}" for i in range(11)])
    o.add_argument("--out", required=True)
    o.add_argument("--frame_limit", type=int, default=0)
    o.set_defaults(fn=odo_exp)

    lf = sub.add_parser("lowfreq")
    lf.add_argument("--dataset_root", required=True)
    lf.add_argument("--out", required=True)
    lf.add_argument("--frame_limit", type=int, default=1000)
    lf.set_defaults(fn=lowfreq_exp)

    t = sub.add_parser("tracking")
    t.add_argument("--dataset_base", required=True)
    t.add_argument("--seqs", nargs="+", type=int, default=list(range(5)))
    t.add_argument("--out", required=True)
    t.add_argument("--frame_limit", type=int, default=0)
    t.set_defaults(fn=tracking_exp)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
