"""Train DispNet-lite on synthetic stereo pairs: the counterpart of
``scripts/train_dispnet.py`` (the in-framework replacement of the
reference's offline Caffe DispNet), with its flags and output.

Trains with the sharded step of ``parallel/sharding.py`` over every CUDA
device (one process each; ``--model-axis`` ranks split the wide convs'
channels), or one CPU process with ``--cpu``. Writes
``<out>/params.pkl``: ``{"params": <Flax-layout variables as numpy>,
"max_disparity": float}``, the layout the JAX script writes, so either
package's model loads it.

    python -m dynslam_tpu_torch.scripts.train_dispnet --steps 300 \\
        --out /path/to/dispnet_ckpt
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--max-disparity", type=float, default=48.0)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "dispnet_ckpt"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel axis size (divides device count)")
    return ap.parse_args(argv)


def make_batch(rng, scene, intr, calib, width, height, batch, frame0=0):
    """``batch`` consecutive synthetic stereo frames from ``frame0`` (gray
    replicated to RGB, in [0, 255]) as NCHW tensors, with the true
    disparity and its valid mask."""
    from dynslam_tpu_torch.io.synthetic import (
        render_stereo_frame, straight_trajectory,
    )

    poses = straight_trajectory(frame0 + batch, speed=0.4)
    left, right, disp = [], [], []
    for i in range(batch):
        fr = render_stereo_frame(scene, poses[frame0 + i], intr, calib,
                                 width, height, frame=frame0 + i)
        left.append(np.clip(fr["left_gray"] * 255, 0, 255))
        right.append(np.clip(fr["right_gray"] * 255, 0, 255))
        disp.append(fr["disparity"])

    def rgb(grays):
        g = torch.tensor(np.stack(grays), dtype=torch.float32)
        return g[:, None].expand(-1, 3, -1, -1).contiguous()

    d = torch.tensor(np.stack(disp), dtype=torch.float32)
    return {"left": rgb(left), "right": rgb(right), "disparity": d,
            "valid": d > 0}


def _train(rank: int, world: int, dev: torch.device, args) -> None:
    from dynslam_tpu_torch.config import Intrinsics, StereoCalibration
    from dynslam_tpu_torch.convert import state_dict_to_flax
    from dynslam_tpu_torch.io.synthetic import SyntheticScene
    from dynslam_tpu_torch.models import dispnet
    from dynslam_tpu_torch.parallel import sharding

    intr = Intrinsics(0.8 * args.width, 0.8 * args.width, args.width / 2,
                      args.height / 2)
    calib = StereoCalibration(0.54, intr.fx)
    model_axis = args.model_axis if world % args.model_axis == 0 else 1
    mesh = sharding.make_mesh(world, model_axis, dev)
    model = dispnet.create_model(max_disparity=args.max_disparity)
    dispnet.init_params(model, torch.Generator().manual_seed(0))
    model = sharding.shard_params(mesh, model)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = sharding.make_sharded_train_step(mesh, model, opt)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[train] mesh {{'data': {world // model_axis}, 'model': "
        f"{model_axis}}}, batch {args.batch}, {args.width}x{args.height}",
        flush=True)

    # every rank draws the same global batches and takes its share
    rng = np.random.default_rng(0)
    t0 = time.time()
    for it in range(args.steps):
        scene = SyntheticScene.default_scene(seed=int(rng.integers(1e6)))
        batch = make_batch(rng, scene, intr, calib, args.width, args.height,
                           args.batch, frame0=int(rng.integers(4)))
        loss = float(step(sharding.shard_batch(mesh, batch)))
        if it % 20 == 0 or it == args.steps - 1:
            say(f"[train] step {it:4d} loss {loss:7.3f} px "
                f"({time.time() - t0:.0f}s)", flush=True)

    params = state_dict_to_flax(sharding.gather_params(mesh, model))
    if rank == 0:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "params.pkl"), "wb") as f:
            pickle.dump({"params": params,
                         "max_disparity": args.max_disparity}, f)
        say(f"[train] saved checkpoint to {args.out}/params.pkl; "
            f"final loss {loss:.3f} px", flush=True)


def main(argv=None) -> None:
    from dynslam_tpu_torch.parallel import launch

    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    world = 1 if args.cpu else torch.cuda.device_count()
    if world <= 1:
        with launch.group(1, 0, device) as dev:
            _train(0, 1, dev, args)
    else:
        launch.spawn(_train, world, device, args)


if __name__ == "__main__":
    main()
