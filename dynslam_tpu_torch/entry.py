"""Entry points: one mapping step on one device, and a multi-process dry
run of the parallel paths (the counterparts of ``__graft_entry__.py``).

``entry(device)`` returns ``(fn, example_args)``: ``fn`` is the hot path
of the map, one fused static step (allocate -> visible blocks -> fusion
(K1) -> the dense tracer's render) at a small configuration, and the
arguments are the JAX entry's inputs (seed 0). ``fn`` updates the map in
place and returns (state, rendered depth).

``dryrun_multichip(n, device)`` runs, on n ranks (n processes; world size
1 in the calling process): one sharded DispNet-lite training step on a
("data", "model") mesh (model axis 2 when n is even), the sharded apply,
and the static and dynamic batch evaluations over max(2, data axis)
sequences, then prints the JAX entry's summary line from rank 0.

    python -m dynslam_tpu_torch.entry [--cpu] [--n N]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from dynslam_tpu_torch.device import DeviceLike, constant, resolve_device
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.ops.integrate import integrate


def _small_cfg() -> tsdf.TsdfConfig:
    return tsdf.TsdfConfig(
        pool_capacity=4096, local_dims=(48, 24, 48), max_new_blocks=2048,
        max_visible_blocks=3072, voxel_size=0.08, mu=0.32,
        raycast_coarse_steps=20, raycast_fine_steps=18, width=256,
        height=160, fx=200.0, fy=200.0, cx=128.0, cy=80.0)


def entry(device: DeviceLike = None):
    """(fn, example_args) of one fused static mapping step."""
    dev = resolve_device(device)
    cfg = _small_cfg()

    def fusion_step(state, rgb, depth_m, cam_to_world, world_to_cam,
                    frame_idx):
        origin = tsdf.compute_origin(cfg, cam_to_world)
        grid = tsdf.build_local_grid(cfg, state, origin)
        state, grid, _ = tsdf.allocate(cfg, state, grid, origin, depth_m,
                                       cam_to_world, frame_idx)
        slots, mask = tsdf.visible_blocks(cfg, state, grid, origin,
                                          world_to_cam)
        integrate(cfg, state, slots, mask, rgb, depth_m, world_to_cam,
                  frame_idx)
        rc = tsdf.raycast(cfg, state, grid, origin, cam_to_world,
                          constant((cfg.fx, cfg.fy, cfg.cx, cfg.cy),
                                   torch.float32, dev))
        return state, rc.depth

    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(0)
    rgb = torch.tensor(rng.integers(0, 255, (h, w, 3)), dtype=torch.uint8,
                       device=dev)
    vv, uu = np.mgrid[0:h, 0:w]
    depth = torch.tensor(
        np.clip(4.0 + 2.0 * np.sin(uu / 40.0) + vv / 60.0, 0.6, 19.0),
        dtype=torch.float32, device=dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    state = tsdf.create_state(cfg, dev)
    return fusion_step, (state, rgb, depth, eye, eye, 0)


def _synthetic_frame_stack(cfg: tsdf.TsdfConfig, n_frames: int,
                          n_sequences: int) -> dict:
    """The JAX entry's tiny time-major (T, S, ...) frame stacks (seed 2):
    per-sequence geometry, forward motion, as CPU tensors."""
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(2)
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = np.empty((n_frames, n_sequences, h, w), np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n_frames, n_sequences, 1, 1))
    for s in range(n_sequences):
        base = 3.5 + 0.7 * s
        for t in range(n_frames):
            depth[t, s] = np.clip(
                base + 1.5 * np.sin(uu / 37.0 + s) + vv / 70.0 - 0.1 * t,
                0.6, 19.0)
            c2w[t, s, 2, 3] = 0.1 * t  # forward motion
    w2c = np.linalg.inv(c2w)
    return {
        "rgb": torch.tensor(rng.integers(0, 255, (n_frames, n_sequences, h,
                                                  w, 3)), dtype=torch.uint8),
        "depth": torch.from_numpy(depth),
        "cam_to_world": torch.from_numpy(c2w),
        "world_to_cam": torch.from_numpy(w2c.astype(np.float32)),
    }


def _dryrun(rank: int, world: int, dev: torch.device) -> dict:
    """The dry run on one rank of a group of ``world``."""
    from dynslam_tpu_torch.models import dispnet
    from dynslam_tpu_torch.parallel import batch_eval, sharding

    model_axis = 2 if world % 2 == 0 else 1
    mesh = sharding.make_mesh(world, model_axis, dev)
    data_axis = world // model_axis

    h, w = 64, 96
    model = dispnet.create_model(max_disparity=32.0)
    dispnet.init_params(model, torch.Generator().manual_seed(0))
    model = sharding.shard_params(mesh, model)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4)

    batch_size = max(world, 2 * data_axis)
    rng = np.random.default_rng(1)
    batch = {
        "left": torch.tensor(rng.uniform(0, 255, (batch_size, 3, h, w)),
                             dtype=torch.float32),
        "right": torch.tensor(rng.uniform(0, 255, (batch_size, 3, h, w)),
                              dtype=torch.float32),
        "disparity": torch.tensor(rng.uniform(0, 32, (batch_size, h, w)),
                                  dtype=torch.float32),
        "valid": torch.ones((batch_size, h, w), dtype=torch.bool),
    }
    local = sharding.shard_batch(mesh, batch)
    step = sharding.make_sharded_train_step(mesh, model, optimizer)
    loss = float(step(local))
    if not np.isfinite(loss):
        raise RuntimeError("non-finite loss in the multichip dry run")

    apply = sharding.make_sharded_apply(mesh, model)
    disp = apply(local["left"], local["right"])
    if tuple(disp.shape) != (batch_size, h, w):
        raise RuntimeError(f"sharded apply gave {tuple(disp.shape)}")

    n_seq = max(2, data_axis)
    cfg = _small_cfg()
    frames = _synthetic_frame_stack(cfg, n_frames=2, n_sequences=n_seq)
    local_frames = batch_eval.shard_frames(mesh, frames)
    n_local = local_frames["depth"].shape[1]
    _, metrics = batch_eval.make_batch_eval(cfg, mesh)(
        batch_eval.stacked_states(cfg, n_local, dev), local_frames)
    metrics = metrics.cpu().numpy()
    if metrics.shape != (2, n_seq, 2) or not np.isfinite(metrics).all():
        raise RuntimeError(f"batch-eval metrics {metrics.shape}: {metrics}")

    icfg = dataclasses.replace(cfg, pool_capacity=1024,
                               local_dims=(32, 16, 32), max_new_blocks=512,
                               max_visible_blocks=1024)
    m = np.zeros((2, n_seq, cfg.height, cfg.width), bool)
    m[:, :, cfg.height // 3: cfg.height // 2,
      cfg.width // 3: cfg.width // 2] = True  # the "car" box
    dyn_frames = dict(frames, obj_mask=torch.from_numpy(m))
    _, dyn = batch_eval.make_dynamic_batch_eval(cfg, icfg, mesh)(
        (batch_eval.stacked_states(cfg, n_local, dev),
         batch_eval.stacked_states(icfg, n_local, dev)),
        batch_eval.shard_frames(mesh, dyn_frames))
    dyn = dyn.cpu().numpy()
    if dyn.shape != (2, n_seq, 3) or not np.isfinite(dyn).all():
        raise RuntimeError(f"dynamic-step metrics {dyn.shape}: {dyn}")
    if not (dyn[-1, :, 2] > 0).all():
        raise RuntimeError("dynamic-step composited render empty")

    line = (f"dryrun_multichip OK: mesh=({{'data': {data_axis}, 'model': "
            f"{model_axis}}}), loss={loss:.4f}, "
            f"disp_mean={float(disp.mean()):.3f}, "
            f"seq_eval_err={metrics[-1, :, 0].mean():.3f}m over {n_seq} "
            f"sequences, dyn_step_err={dyn[-1, :, 0].mean():.3f}m "
            f"(dyn bucket {dyn[-1, :, 1].mean():.3f}m, comp coverage "
            f"{dyn[-1, :, 2].mean():.2f})")
    if rank == 0:
        print(line, flush=True)
    return dict(line=line, loss=loss, metrics=metrics, dyn=dyn,
                disp=disp.cpu().numpy())


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """The dry run on ``n_devices`` ranks (processes; CUDA needs that many
    cards). Returns rank 0's results (summary line, loss, metrics)."""
    from dynslam_tpu_torch.parallel import launch

    if n_devices == 1:
        with launch.group(1, 0, device) as dev:
            return _dryrun(0, 1, dev)
    return launch.spawn(_dryrun, n_devices, device)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo) instead of CUDA (NCCL)")
    ap.add_argument("--n", type=int, default=None,
                    help="ranks of the dry run (default: the CUDA device "
                         "count, or 2 with --cpu)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    fn, example = entry(device)
    _, depth = fn(*example)
    print(f"entry fusion_step OK: depth {tuple(depth.shape)}, hit "
          f"{float((depth > 0).float().mean()):.3f}", flush=True)
    n = args.n or (2 if args.cpu else torch.cuda.device_count())
    dryrun_multichip(n, device)


if __name__ == "__main__":
    main()
