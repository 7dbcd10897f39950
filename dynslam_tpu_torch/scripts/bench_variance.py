"""Run one mode of the port's bench (``python -m dynslam_tpu_torch.bench``)
N times, each in a fresh process, and report the spread: the evidence
for any claim that a margin holds across runs. Each run draws new input
noise and builds its own pipeline and caches.

    python -m dynslam_tpu_torch.scripts.bench_variance [--runs 3] \\
        [--mode dynamic|static] [--eval] [--cpu]

Prints ``{mode, eval, runs, min, max, mean, device, power_limit_w}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
#: the bench command a run executes (flags appended)
BENCH_CMD = [sys.executable, "-m", "dynslam_tpu_torch.bench"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--mode", default="dynamic", choices=["dynamic", "static"])
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the bench on the CPU")
    args = ap.parse_args(argv)

    flags = [f"--{args.mode}"] + (["--eval"] if args.eval else []) \
        + (["--cpu"] if args.cpu else [])
    vals, device = [], {}
    for r in range(args.runs):
        out = subprocess.run(BENCH_CMD + flags, capture_output=True,
                             text=True, cwd=str(ROOT))
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if not lines:
            print(f"[variance] run {r}: no JSON line (rc={out.returncode}); "
                  "stderr tail:", file=sys.stderr)
            print("\n".join(out.stderr.splitlines()[-5:]), file=sys.stderr)
            continue
        res = json.loads(lines[-1])
        vals.append(res["value"])
        device = {k: res.get(k) for k in ("device", "power_limit_w")}
        print(f"[variance] run {r}: {res['value']}", file=sys.stderr)
    if not vals:
        return 1
    print(json.dumps({
        "mode": args.mode, "eval": bool(args.eval), "runs": vals,
        "min": min(vals), "max": max(vals),
        "mean": round(sum(vals) / len(vals), 3), **device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
