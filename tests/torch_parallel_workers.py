"""Worker functions the ``tests/test_torch_parallel.py`` and
``test_torch_batch_eval.py`` run on gloo ranks through
``dynslam_tpu_torch.parallel.launch.spawn``. Spawned processes import
this module by name, so it imports no JAX (and nothing of the tests that
does): each worker starts as a fresh interpreter with torch alone.

Every worker is ``fn(rank, world, device, *args)`` and returns numpy
arrays and floats.
"""

import numpy as np
import torch

from dynslam_tpu_torch.models import dispnet
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.parallel import batch_eval, sharding

#: DispNet-lite parity size: odd rows so the strided convs pad (1, 1)
#: and (0, 1) both; the global batch splits over 2 data ranks
H, W, BATCH = 33, 48, 4
LR, STEPS = 1e-3, 3


def dispnet_batch(seed: int = 1) -> dict:
    """A global batch whose valid masks differ from sample to sample (20%
    to 90% valid), so the data ranks' mask counts differ."""
    rng = np.random.default_rng(seed)
    frac = np.linspace(0.2, 0.9, BATCH)[:, None, None]
    return {
        "left": torch.tensor(rng.uniform(0, 255, (BATCH, 3, H, W)),
                             dtype=torch.float32),
        "right": torch.tensor(rng.uniform(0, 255, (BATCH, 3, H, W)),
                              dtype=torch.float32),
        "disparity": torch.tensor(rng.uniform(0, 32, (BATCH, H, W)),
                                  dtype=torch.float32),
        "valid": torch.tensor(rng.random((BATCH, H, W)) < frac),
    }


def dispnet_model() -> dispnet.DispNetLite:
    model = dispnet.create_model(max_disparity=32.0)
    return dispnet.init_params(model, torch.Generator().manual_seed(0))


def state_numpy(state_dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state_dict.items()}


def single_device_steps(steps: int = STEPS) -> dict:
    """The unsharded reference: ``steps`` Adam steps on the global batch,
    at 1 torch thread as the gloo ranks run; the caller's count is
    restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = dispnet_model()
        step = dispnet.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=LR))
        batch = dispnet_batch()
        losses = [float(step(batch)) for _ in range(steps)]
    finally:
        torch.set_num_threads(before)
    return dict(losses=losses, params=state_numpy(model.state_dict()))


def sharded_steps(rank, world, device, model_axis: int, steps: int = STEPS):
    """The sharded step on a (world / model_axis, model_axis) mesh: the
    losses, the gathered parameters, the local parameter count, the mesh's
    shape, the sharded apply's disparity and that of one module holding
    the gathered parameters."""
    mesh = sharding.make_mesh(world, model_axis, device)
    model = sharding.shard_params(mesh, dispnet_model())
    step = sharding.make_sharded_train_step(
        mesh, model, torch.optim.Adam(model.parameters(), lr=LR))
    local = sharding.shard_batch(mesh, dispnet_batch())
    losses = [float(step(local)) for _ in range(steps)]
    disp = sharding.make_sharded_apply(mesh, model)(local["left"],
                                                    local["right"])
    params = sharding.gather_params(mesh, model)
    whole = dispnet_model()
    whole.load_state_dict(params)
    batch = dispnet_batch()
    with torch.no_grad():
        disp_whole = whole(batch["left"], batch["right"]).numpy()
    return dict(losses=losses, params=state_numpy(params),
                local_numel=sum(p.numel() for p in model.parameters()),
                mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                data_rank=mesh.get_local_rank("data"),
                model_rank=mesh.get_local_rank("model"),
                local_batch=int(local["left"].shape[0]),
                disp=disp.numpy(), disp_whole=disp_whole)


def library_gather_grad(rank, world, device):
    """The trap the sharded convs avoid: a replicated loss through
    ``torch.distributed.nn.functional.all_gather`` over the whole group.
    Returns this rank's input gradient (the true one is all ones)."""
    from torch.distributed.nn.functional import all_gather

    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    torch.cat(all_gather(x), 1).sum().backward()
    return x.grad.numpy()


def tiny_cfg() -> tsdf.TsdfConfig:
    """``tests/test_batch_eval.py``'s configuration."""
    return tsdf.TsdfConfig(
        pool_capacity=2048, local_dims=(32, 16, 32), max_new_blocks=1024,
        max_visible_blocks=1536, voxel_size=0.1, mu=0.4,
        raycast_coarse_steps=16, raycast_fine_steps=14, width=96, height=64,
        fx=80.0, fy=80.0, cx=48.0, cy=32.0)


def tiny_instance_cfg() -> tsdf.TsdfConfig:
    import dataclasses

    return dataclasses.replace(tiny_cfg(), pool_capacity=512,
                               local_dims=(16, 12, 16), max_new_blocks=256,
                               max_visible_blocks=512)


def eval_frames(n_frames: int, n_seq: int) -> dict:
    """``tests/test_batch_eval.py``'s frames (seed 7) plus its car box, as
    numpy."""
    cfg = tiny_cfg()
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(7)
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = np.empty((n_frames, n_seq, h, w), np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n_frames, n_seq, 1, 1))
    for s in range(n_seq):
        for t in range(n_frames):
            depth[t, s] = np.clip(
                3.0 + 0.5 * s + np.sin(uu / 30.0) + vv / 80.0, 0.8, 15.0)
            c2w[t, s, 2, 3] = 0.05 * t
    mask = np.zeros((n_frames, n_seq, h, w), bool)
    mask[:, :, h // 3: h // 2, w // 3: w // 2] = True
    return {
        "rgb": rng.integers(0, 255, (n_frames, n_seq, h, w, 3)).astype(
            np.uint8),
        "depth": depth,
        "cam_to_world": c2w,
        "world_to_cam": np.linalg.inv(c2w).astype(np.float32),
        "obj_mask": mask,
    }


def batch_eval_ranks(rank, world, device, n_frames: int, n_seq: int):
    """Static and dynamic batch evaluation over ``n_seq`` sequences on a
    (world, 1) mesh: every rank's metrics (all of them) and its own
    sequences' maps, and the K1 launches a frame (counted by
    ``integrate_many``'s calls on the CPU)."""
    import dynslam_tpu_torch.parallel.batch_eval as be

    mesh = sharding.make_mesh(world, 1, device)
    frames = {k: torch.from_numpy(v) for k, v in
              eval_frames(n_frames, n_seq).items()}
    calls = []
    real = be.integrate_many

    def counted(cfg, pool, vols, *args):
        calls.append(len(vols))
        return real(cfg, pool, vols, *args)

    be.integrate_many = counted
    try:
        cfg, icfg = tiny_cfg(), tiny_instance_cfg()
        static = {k: v for k, v in frames.items() if k != "obj_mask"}
        local = batch_eval.shard_frames(mesh, static)
        n_local = local["depth"].shape[1]
        states, metrics = batch_eval.make_batch_eval(cfg, mesh)(
            batch_eval.stacked_states(cfg, n_local, device), local)
        static_calls = list(calls)
        calls.clear()
        (dstates, insts), dmetrics = batch_eval.make_dynamic_batch_eval(
            cfg, icfg, mesh)(
            (batch_eval.stacked_states(cfg, n_local, device),
             batch_eval.stacked_states(icfg, n_local, device)),
            batch_eval.shard_frames(mesh, frames))
    finally:
        be.integrate_many = real

    def maps(pool):
        return {k: getattr(pool, k).numpy()
                for k in ("tsdf_w", "color", "valid", "block_coords")}

    return dict(metrics=metrics.numpy(), dyn_metrics=dmetrics.numpy(),
                static=maps(states), dynamic=maps(dstates),
                inst=maps(insts), static_calls=static_calls,
                dyn_calls=list(calls), first=rank * n_local)
