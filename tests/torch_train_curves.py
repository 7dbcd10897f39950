"""SegNet-lite's and DispNet-lite's training curves in both packages on the
CPU: ``chip_smoke.py`` phase 17's data, batches, rate and init, through
the JAX package's ``make_train_step`` (optax Adam) and the port's (torch
Adam). A one-off measurement, not a test: it takes minutes a model.

    JAX_PLATFORMS=cpu python tests/torch_train_curves.py --model segnet \\
        --steps 600 --frames DIR/frames.npz --out curves.json

``--frames`` is an ``.npz`` of the bench's dynamic sequence (``left`` gray
uint8 (N, H, W), ``objid``, and for DispNet-lite ``right`` and
``depth``), as ``bench_setup.render_sets`` caches it; phase 17b trains on
frames 0-10 of 12. ``--init`` starts both from a params file in Flax's
msgpack layout (either package's ``save_params``) in place of phase 17's
seeded init (whose draws depend on the torch version, where phase 17b's
come from torch's generator). Prints each curve's first-10 and last-10
means and the step where the two curves first part by more than ``PART_RTOL``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

#: relative gap at which two losses count as parted; torch's CPU threads
PART_RTOL, THREADS = 1e-3, 4


def seg_setup(frames: dict):
    """Phase 17b: the port's seeded init, its batches (frame ``(it + 5 j)
    % n``, the last frame held out) as NHWC numpy."""
    import torch

    from dynslam_tpu_torch.models import segnet

    model = segnet.init_params(segnet.create_model(),
                               torch.Generator().manual_seed(cs.SEED))
    gray = frames["left"]
    rgb = np.repeat(gray[..., None], 3, -1).astype(np.float32)
    cars = frames["objid"] > 0
    n = len(gray) - 1

    def batch(it):
        idx = [(it + 5 * j) % n for j in range(cs.SEG_BATCH)]
        return dict(rgb=rgb[idx], mask=cars[idx])

    return model, batch, cs.SEG_LR


def disp_setup(frames: dict, config):
    """Phase 17a: the seeded Flax-layout init, its batches (frame ``(it +
    3 j) % n``) as NHWC numpy."""
    gray_l, gray_r = frames["left"], frames["right"]
    depth = frames["depth"]
    bf = config.calibration.baseline_m * config.calibration.focal_length_px
    disp = np.where(depth > 0, bf / np.maximum(depth, 1e-6), 0.0).astype(
        np.float32)
    valid = (depth > 0) & (disp <= config.stereo.max_disparity)
    left = np.repeat(gray_l[..., None], 3, -1).astype(np.float32)
    right = np.repeat(gray_r[..., None], 3, -1).astype(np.float32)
    n = len(gray_l)

    def batch(it):
        idx = [(it + 3 * j) % n for j in range(cs.DISP_BATCH)]
        return dict(left=left[idx], right=right[idx], disparity=disp[idx],
                    valid=valid[idx])

    return cs.seeded_dispnet(config, cs.SEED), batch, cs.DISP_LR


def to_torch(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2) if v.ndim == 4 else v))
        for k, v in batch.items()}


def curves(kind: str, frames: dict, steps: int, init: Path = None) -> dict:
    """Both packages' losses over ``steps`` steps from one init."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from dynslam_tpu.models import dispnet as jd
    from dynslam_tpu.models import segnet as js
    from dynslam_tpu_torch import convert
    from dynslam_tpu_torch.models import dispnet as td
    from dynslam_tpu_torch.models import segnet as ts
    from dynslam_tpu_torch.scripts.bench_setup import bench_config
    from dynslam_tpu_torch.utils import msgpack

    torch.set_num_threads(THREADS)
    if kind == "segnet":
        model, batch, lr = seg_setup(frames)
        jm, jmod, tmod = js.create_model(), js, ts
    else:
        config = bench_config(False)
        model, batch, lr = disp_setup(frames, config)
        jm = jd.create_model(
            max_disparity=float(config.stereo.max_disparity))
        jmod, tmod = jd, td
    flax = convert.state_dict_to_flax(model.state_dict()) if init is None \
        else msgpack.from_bytes(init.read_bytes())
    model.load_state_dict(convert.flax_to_state_dict(flax))
    params = jax.tree_util.tree_map(jnp.asarray, flax)
    opt = optax.adam(lr)
    jstep = jax.jit(jmod.make_train_step(jm, opt))
    state = opt.init(params)
    tstep = tmod.make_train_step(model, torch.optim.Adam(model.parameters(),
                                                         lr=lr))
    out = dict(jax=[], torch=[], jax_s=0.0, torch_s=0.0)
    for it in range(steps):
        b = batch(it)
        t0 = time.perf_counter()
        params, state, loss = jstep(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        out["jax"].append(float(loss))
        t1 = time.perf_counter()
        out["torch"].append(float(tstep(to_torch(b))))
        out["torch_s"] += time.perf_counter() - t1
        out["jax_s"] += t1 - t0
    return out


def summary(out: dict) -> dict:
    def means(c):
        return statistics.mean(c[:10]), statistics.mean(c[-10:])

    part = next((i for i, (a, b) in enumerate(zip(out["jax"], out["torch"]))
                 if abs(a - b) > PART_RTOL * abs(a)), None)
    return dict(jax=means(out["jax"]), torch=means(out["torch"]),
                parts_at=part, steps=len(out["jax"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("segnet", "dispnet"),
                    default="segnet")
    ap.add_argument("--steps", type=int, default=cs.SEG_STEPS)
    ap.add_argument("--frames", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--init", type=Path, default=None,
                    help="a params file (Flax msgpack) to start both from")
    args = ap.parse_args(argv)
    with np.load(args.frames) as z:
        frames = dict(z)
    out = curves(args.model, frames, args.steps, args.init)
    s = summary(out)
    print(json.dumps(dict(model=args.model, **s,
                          jax_s=out["jax_s"], torch_s=out["torch_s"])))
    if args.out:
        args.out.write_text(json.dumps(dict(summary=s, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
