"""Command-line entry point — the port of ``dynslam_tpu/main.py`` (the
reference's ``DynSLAMGUI.cpp main()``, lines 1288-1315, with its gflags,
lines 26-72, as argparse flags of the same names), headless: previews,
CSVs, the trajectory and checkpoints go to an output folder.

Usage::

    python -m dynslam_tpu_torch.main --dataset_root /data/kitti/odometry/06 \\
        --enable_evaluation --out /tmp/run06
    python -m dynslam_tpu_torch.main --dataset_root DIR --cpu --tiny

The pipelines run on the GPU; ``--cpu`` runs the kernels' plain PyTorch
versions on the CPU instead. Without ``--fused`` the staged pipeline runs
(``pipeline/builder.py::build_dynslam``); with it the fused steps, which
take every flag but ``--direct_refinement`` and a delayed evaluation.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # dataset flags (DynSLAMGUI.cpp:26-34)
    p.add_argument("--dataset_root", required=True,
                   help="KITTI-layout sequence root")
    p.add_argument("--dataset_type",
                   choices=["kitti-odometry", "kitti-tracking"],
                   default="kitti-odometry")
    p.add_argument("--kitti_tracking_sequence_id", type=int, default=-1)
    p.add_argument("--frame_offset", type=int, default=0)
    p.add_argument("--frame_limit", type=int, default=0,
                   help="stop after this many frames (0 = all)")
    # pipeline flags (DynSLAMGUI.cpp:29-55)
    p.add_argument("--dynamic_mode", action="store_true", default=True)
    p.add_argument("--no-dynamic_mode", dest="dynamic_mode",
                   action="store_false")
    p.add_argument("--direct_refinement", action="store_true", default=False,
                   help="refine each object's motion by dense photometric "
                        "alignment of its consecutive views (staged path "
                        "only; the reference ships this disabled)")
    p.add_argument("--use_bilateral_filter", action="store_true",
                   default=False,
                   help="bilateral-filter the input depth before fusion")
    p.add_argument("--use_dispnet", action="store_true", default=False)
    p.add_argument("--fill_disparity_gaps", type=int, default=0,
                   help="live-stereo gap interpolation: fill horizontal "
                        "invalid runs up to N px (0 = off)")
    p.add_argument("--use_live_stereo", action="store_true", default=False,
                   help="census matcher depth instead of precomputed dumps")
    p.add_argument("--voxel_decay", action="store_true", default=True)
    p.add_argument("--no-voxel_decay", dest="voxel_decay",
                   action="store_false")
    p.add_argument("--min_decay_age", type=int, default=200)
    p.add_argument("--max_decay_weight", type=int, default=1)
    p.add_argument("--use_depth_weighting", action="store_true",
                   default=False)
    p.add_argument("--fusion_every", type=int, default=1)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--max_depth", type=float, default=None,
                   help="fusion depth cutoff in metres (default 20; the CSV "
                        "names encode it)")
    # evaluation flags (DynSLAMGUI.cpp:56-72)
    p.add_argument("--enable_evaluation", action="store_true", default=False)
    p.add_argument("--semantic_evaluation", action="store_true", default=True)
    p.add_argument("--evaluation_delay", type=int, default=0)
    p.add_argument("--csv_out_dir", default=None)
    # outputs
    p.add_argument("--out", default="./dynslam_out")
    p.add_argument("--dump_previews_every", type=int, default=0,
                   help="write raycast preview PNGs every k frames")
    p.add_argument("--save_mesh", action="store_true", default=False,
                   help="write the static map's mesh as static_map.obj")
    p.add_argument("--save_object_meshes", action="store_true",
                   default=False,
                   help="write each reconstructed object's mesh as "
                        "object_<id>_<class>.obj")
    p.add_argument("--cpu", action="store_true", default=False,
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--tiny", action="store_true", default=False,
                   help="small pools and feature counts (tests, small "
                        "inputs)")
    p.add_argument("--prefetch", action="store_true", default=False,
                   help="read the next frame in a background thread")
    p.add_argument("--min_detection_size", type=int, default=None,
                   help="min detection side in px (default: the "
                        "reference's 45)")
    p.add_argument("--fused", action="store_true", default=False,
                   help="run the fused frame steps (in-graph census "
                        "stereo; precomputed depth dumps are ignored); "
                        "--evaluation_delay > 0 needs the staged path")
    p.add_argument("--checkpoint_out", default=None,
                   help="write a map+trajectory checkpoint here at the end")
    p.add_argument("--resume_from", default=None,
                   help="resume the static map + trajectory from a "
                        "checkpoint")
    p.add_argument("--debug_numerics", action="store_true", default=False,
                   help="stop at the first frame whose pose is not finite")
    return p


def make_config(args):
    """The ``DynSlamConfig`` the flags ask for."""
    from dynslam_tpu_torch.config import (
        DynSlamConfig, EvaluationParams, InstanceMapParams, MapParams,
        SceneParams, StereoMatcherParams, VisualOdometryParams,
        VoxelDecayParams,
    )

    if args.tiny:
        base = DynSlamConfig(
            map=MapParams(pool_capacity=16384, local_dims=(80, 32, 80),
                          max_new_blocks_per_frame=4096),
            instance_map=InstanceMapParams(
                blocks_per_object=1024, local_dims=(48, 24, 64),
                max_new_blocks_per_frame=512),
            vo=VisualOdometryParams(max_candidates=1024, max_matches=512,
                                    ransac_iters=60, max_disparity=64),
            stereo=StereoMatcherParams(max_disparity=64),
        )
    else:
        base = DynSlamConfig()
    cfg = base.replace(
        dynamic_mode=args.dynamic_mode,
        use_dispnet=args.use_dispnet,
        fusion_every=args.fusion_every,
        use_bilateral_filter=args.use_bilateral_filter,
        scale=args.scale,
        scene=SceneParams(voxel_size_m=args.voxel_size),
        decay=VoxelDecayParams(args.voxel_decay, args.min_decay_age,
                               args.max_decay_weight),
        evaluation=EvaluationParams(
            enabled=args.enable_evaluation,
            semantic_evaluation=args.semantic_evaluation,
            evaluation_delay=args.evaluation_delay),
    )
    cfg = dataclasses.replace(
        cfg,
        map=dataclasses.replace(cfg.map,
                                use_depth_weighting=args.use_depth_weighting),
        stereo=dataclasses.replace(cfg.stereo,
                                   fill_gaps=args.fill_disparity_gaps),
        use_direct_refinement=args.direct_refinement)
    if args.max_depth is not None:
        cfg = dataclasses.replace(cfg, max_depth_m=args.max_depth)
    return cfg


def _tracking_sequence(args):
    return (args.kitti_tracking_sequence_id
            if args.dataset_type == "kitti-tracking" else None)


def _device_memory_line(device) -> str:
    """The device's allocated and reserved memory (the reference's
    cudaMemGetInfo readout, DynSLAMGUI.cpp:910-915)."""
    import torch

    if device.type != "cuda":
        return "[device memory: not measured on the CPU]"
    stats = torch.cuda.memory_stats(device)
    return (f"[device memory: {stats.get('allocated_bytes.all.current', 0) / 2 ** 20:.0f}"
            f" MB allocated, {stats.get('reserved_bytes.all.current', 0) / 2 ** 20:.0f}"
            f" MB reserved]")


def _check_pose(args, n: int, pose) -> None:
    """With ``--debug_numerics``, stop at a non-finite pose; a device
    tensor is fetched only then."""
    if not args.debug_numerics:
        return
    pose = np.asarray(pose.cpu() if hasattr(pose, "cpu") else pose)
    if not np.isfinite(pose).all():
        raise FloatingPointError(f"frame {n}: non-finite pose {pose}")


def _write_previews(out: str, n: int, color: np.ndarray,
                    depth_img: np.ndarray) -> None:
    from dynslam_tpu_torch.io.images import write_png

    write_png(os.path.join(out, f"frame{n:06d}_color.png"), color)
    write_png(os.path.join(out, f"frame{n:06d}_depth.png"), depth_img)


def _write_lidar_error(out: str, n: int, dyn, input_) -> None:
    """The LIDAR-vs-fused-depth error overlay of frame ``n``, where its
    scan exists (the GUI's visual diff modes, headless)."""
    from dynslam_tpu_torch.eval.error_viz import render_depth_error
    from dynslam_tpu_torch.io.images import write_png

    ev = dyn.evaluation
    frame = input_.frame_offset + n
    if ev is None or not ev.velodyne.frame_available(frame):
        return
    overlay = render_depth_error(
        ev.velodyne.read_frame(frame),
        dyn.get_static_map_raycast_depth_preview().cpu().numpy(),
        input_.get_images()[0], ev.calib.velo_to_left_cam,
        ev.calib.proj_left_color, ev.calib.proj_right_color,
        ev.baseline_m * ev.focal_px)
    write_png(os.path.join(out, f"frame{n:06d}_lidar_error.png"), overlay)


def _print_tracks(tracks) -> None:
    for t in tracks:
        vol = t.reconstruction.get_used_block_count() \
            if t.has_reconstruction() else 0
        print(f"[track #{t.id} {t.class_name} {t.state.value}: "
              f"{len(t.frames)} frames, {t.fused_frames} fused, "
              f"{vol} blocks]")


def _object_mesh_paths(out: str, tracks):
    """(track, OBJ path) of each track with a reconstruction."""
    return [(t, os.path.join(out, f"object_{t.id}_{t.class_name}.obj"))
            for t in tracks if t.has_reconstruction()]


def run_fused(args, cfg, device) -> int:
    """--fused: the fused frame steps driven over the sequence. Each
    frame's pose stays on the device until the loop ends, so that the host
    stays a frame ahead of the device, as in the JAX CLI. A resumed run
    goes on from the checkpoint's next frame and writes the checkpoint's
    poses before its own; the JAX CLI reads a static checkpoint's sequence
    again from frame 0 and writes the resumed frames alone."""
    import torch

    from dynslam_tpu_torch.io.calib import write_kitti_poses
    from dynslam_tpu_torch.ops import depth as depth_ops
    from dynslam_tpu_torch.pipeline import checkpoint
    from dynslam_tpu_torch.pipeline.builder import build_fused

    pipe, input_, segp = build_fused(
        args.dataset_root, cfg,
        kitti_tracking_sequence=_tracking_sequence(args),
        frame_offset=args.frame_offset,
        min_detection_size_px=args.min_detection_size,
        with_evaluation=args.enable_evaluation,
        csv_out_dir=args.csv_out_dir or os.path.join(args.out, "csv"),
        use_prefetch=args.prefetch, device=device)
    eye = np.eye(4, dtype=np.float32)
    # world-to-camera poses of the frames before this run (the bootstrap
    # frame 0's is the identity) and, on the device, this run's
    n, prior, poses = 0, [eye], []
    if args.resume_from:
        n = checkpoint.load_fused_checkpoint(args.resume_from, pipe)
        input_.frame_idx = input_.frame_offset + n
        print(f"[resumed from {args.resume_from} at frame {n}]")
        saved = checkpoint.fused_pose_history(args.resume_from)
        if len(saved) == n + 1:
            prior = list(saved[1:])
        else:
            prior = []
            print(f"[{args.resume_from} holds no poses before frame {n}: "
                  f"the trajectory starts at frame {n}]")

    def gray(rgb):
        return depth_ops.rgb_to_gray(torch.from_numpy(rgb)).numpy()

    t_steady, n_start = None, n
    while input_.has_more_images():
        t0 = time.perf_counter()
        input_.read_next_frame()
        rgb, _ = input_.get_images()
        lg, rg = gray(rgb), gray(input_.get_stereo_color()[1])
        if segp is not None:
            pipe.process_frame(lg, rg, rgb,
                               segp.segment_frame(rgb).instance_detections)
        else:
            pipe.process_frame(lg, rg, rgb)
            o = pipe.last_outputs
            if pipe.evaluation is not None and o is not None:
                pipe.evaluation.submit(n, o.raycast.depth, o.depth_m, None,
                                       o.used_blocks, o.decayed_blocks)
        if pipe.last_outputs is not None:
            poses.append(pipe.last_outputs.pose_w2c)
            _check_pose(args, n, poses[-1])
            if args.dump_previews_every and n \
                    and n % args.dump_previews_every == 0:
                rc = pipe.last_outputs.raycast
                color = pipe.composited_preview() if segp is not None \
                    else rc.color.cpu().numpy()
                d = rc.depth.cpu().numpy()
                dv = np.clip(d / max(float(d.max()), 1e-3) * 255, 0, 255)
                _write_previews(args.out, n, color, dv.astype(np.uint8))
        print(f"[Dispatched frame {n} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms]")
        n += 1
        if n - n_start == 3:
            t_steady = time.perf_counter()
        if args.frame_limit and n - n_start >= args.frame_limit:
            break
    if segp is not None:
        pipe.finalize()
    if pipe.evaluation is not None:
        pipe.evaluation.close()
    if args.prefetch:
        input_.close()
    # one fetch for the run's poses; it waits for the device to drain
    w2c = prior + (list(torch.stack(poses).cpu().numpy()) if poses else [])
    if t_steady is not None and n - n_start > 3:
        fps = (n - n_start - 3) / (time.perf_counter() - t_steady)
        print(f"[steady-state: {fps:.2f} FPS over {n - n_start - 3} frames]")
    if args.checkpoint_out:
        checkpoint.save_fused_checkpoint(
            args.checkpoint_out, pipe,
            pose_history=[eye] + w2c if prior else None, frame=n)
        print(f"[checkpoint written to {args.checkpoint_out}]")
    # trajectory rows == frames processed; frame 0 is the bootstrap
    write_kitti_poses(os.path.join(args.out, "trajectory.txt"),
                      np.stack([np.linalg.inv(p) for p in w2c])
                      if w2c else np.zeros((0, 4, 4)))
    if args.save_mesh:
        from dynslam_tpu_torch.viz.meshing import extract_mesh, write_obj

        verts, tris = extract_mesh(pipe.carry.state, pipe.cfg.voxel_size)
        write_obj(os.path.join(args.out, "static_map.obj"), verts, tris)
        print(f"[saved static map mesh: {tris.shape[0]} triangles]")
    if segp is not None:
        tracks = list(pipe.tracker.active_tracks.values())
        _print_tracks(tracks)
        if args.save_object_meshes:
            from dynslam_tpu_torch.viz.meshing import save_engine_mesh

            for t, path in _object_mesh_paths(args.out, tracks):
                nt = save_engine_mesh(t.reconstruction, path)
                print(f"[saved object #{t.id} mesh: {nt} triangles]")
    print(f"[map: {pipe.get_used_block_count()} blocks, "
          f"{pipe.get_dropped_allocation_count()} dropped allocations]")
    if segp is not None:
        nd = pipe.get_dropped_detection_count()
        if nd:
            print(f"[WARNING: {nd} detections exceeded the {pipe.K} mask "
                  f"slots over the run (largest kept); raise "
                  f"instance_map.max_detections]")
        if pipe.oversize_masks:
            print(f"[{pipe.oversize_masks} oversized masks exceeded the "
                  f"fusion crop; {pipe.truncated_pixels} px truncated (0 = "
                  f"every one took the full-frame fallback)]")
    return 0


def run_staged(args, cfg, device) -> int:
    """The staged pipeline over the sequence."""
    from dynslam_tpu_torch.io.calib import write_kitti_poses
    from dynslam_tpu_torch.pipeline.builder import build_dynslam
    from dynslam_tpu_torch.pipeline.mapping import PreviewType

    dyn, input_ = build_dynslam(
        args.dataset_root, cfg,
        kitti_tracking_sequence=_tracking_sequence(args),
        use_live_stereo=args.use_live_stereo,
        frame_offset=args.frame_offset,
        with_instances=args.dynamic_mode,
        with_evaluation=args.enable_evaluation,
        csv_out_dir=args.csv_out_dir or os.path.join(args.out, "csv"),
        min_detection_size_px=args.min_detection_size,
        use_prefetch=args.prefetch, device=device)
    n = 0
    if args.resume_from:
        from dynslam_tpu_torch.pipeline.checkpoint import load_checkpoint

        n = load_checkpoint(args.resume_from, dyn)
        input_.frame_idx = input_.frame_offset + n
        print(f"[resumed from {args.resume_from} at frame {n}]")
    while dyn.process_frame(input_):
        ms = dyn.last_frame_ms()
        _check_pose(args, n, dyn.get_current_pose())
        print(f"[Finished frame {n} in {ms:.1f} ms @ "
              f"{1000.0 / max(ms, 1e-3):.2f} FPS]")
        if args.dump_previews_every and n \
                and n % args.dump_previews_every == 0:
            _write_previews(
                args.out, n,
                dyn.get_static_map_raycast_preview(preview=PreviewType.COLOR),
                dyn.get_static_map_raycast_preview(preview=PreviewType.DEPTH))
            _write_lidar_error(args.out, n, dyn, input_)
        if n and n % 50 == 0:
            print(_device_memory_line(device))
        n += 1
        # frames counted from the sequence's start, a resumed run's too
        if args.frame_limit and n >= args.frame_limit:
            break
    if args.checkpoint_out:
        from dynslam_tpu_torch.pipeline.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint_out, dyn)
        print(f"[checkpoint written to {args.checkpoint_out}]")
    dyn.finalize()
    if dyn.evaluation is not None:
        dyn.evaluation.close()
    if args.prefetch:
        input_.close()
    est = np.stack([np.linalg.inv(p) for p in dyn.pose_history[1:]])
    write_kitti_poses(os.path.join(args.out, "trajectory.txt"), est)
    if args.save_mesh:
        tris = dyn.save_static_map(os.path.join(args.out, "static_map.obj"))
        print(f"[saved static map mesh: {tris} triangles]")
    rec = dyn.instance_reconstructor
    if rec is not None:
        if cfg.use_direct_refinement:
            print(f"[direct refinement: {rec.direct_refinements} object "
                  f"motions refined]")
        tracks = list(rec.tracker.active_tracks.values())
        _print_tracks(tracks)
        if args.save_object_meshes:
            for t, path in _object_mesh_paths(args.out, tracks):
                dyn.save_dynamic_object(t.id, path)
                print(f"[saved object #{t.id} mesh: {path}]")
    print(dyn.get_timing_report())
    scene = dyn.static_scene
    print(f"[map: {scene.get_used_block_count()} blocks, "
          f"{scene.get_used_memory_bytes() / 1e6:.1f} MB; decay saved "
          f"{scene.get_saved_decay_memory_bytes() / 1e6:.1f} MB; "
          f"{scene.get_dropped_allocation_count()} dropped allocations]")
    return 0


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.fused and args.direct_refinement:
        raise SystemExit("--fused does not support --direct_refinement; use "
                         "the staged path for it")
    from dynslam_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = make_config(args)
    os.makedirs(args.out, exist_ok=True)
    if args.fused:
        if args.enable_evaluation and args.evaluation_delay:
            raise SystemExit("--fused evaluation supports "
                             "--evaluation_delay=0 only; use the staged "
                             "path for delayed evaluation")
        return run_fused(args, cfg, device)
    return run_staged(args, cfg, device)


if __name__ == "__main__":
    sys.exit(main())
