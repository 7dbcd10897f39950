"""The correctness check's readings on the card: for each seed, one run
of a cell with a short window, the numbers the check compares for the
port (its lower readings) and for the control, the reference in
bfloat16 put in the port's place (its upper readings). Not part of the
benchmark's runs.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--seconds 3]

One JSON line a seed, then one with the worst port reading and the least
control reading of each number over the seeds.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control_seeds", type=int, default=3,
                    help="the first N seeds also run the control")
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctl = k < args.control_seeds
        r = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                             control=ctl)
        port = {k: v["value"] for k, v in r["checks"].items()}
        for k, v in port.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in r.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "port": port, "control": r.get("control"),
                          "control_by_frame": r.get("control_by_frame"),
                          "fps": r["metrics"].get("fps", {}).get("value")}),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
