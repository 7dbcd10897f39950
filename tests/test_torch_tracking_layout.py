"""The KITTI-tracking layout (``io/input.py::kitti_tracking_config``,
``--dataset_type kitti-tracking``) over a folder that
``tests/torch_tracking_layout.py`` re-lays from the port's
``write_kitti_sequence``: both packages' readers read from it the frames,
depth, masks, LIDAR, calibration and tracklets that they read from the
odometry folder; the port's staged and fused CLIs give over it the
trajectories and CSV contents they give over the odometry folder; and the
staged run's tracks, fed per frame to ``TrackingEvaluation``, give
finite errors against the tracklets of ``label_02/NNNN.txt``."""

import os

import numpy as np
import pytest

from dynslam_tpu.io import calib as jcal
from dynslam_tpu.io import depth_providers as jdp
from dynslam_tpu.io import input as jin
from dynslam_tpu.io import segmentation as jseg
from dynslam_tpu.io import tracklets as jtr
from dynslam_tpu.io import velodyne as jvel
from dynslam_tpu_torch import main
from dynslam_tpu_torch.config import StereoCalibration as TCalib
from dynslam_tpu_torch.io import calib as tcal
from dynslam_tpu_torch.io import depth_providers as tdp
from dynslam_tpu_torch.io import input as tin
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.io import tracklets as ttr
from dynslam_tpu_torch.io import velodyne as tvel
from dynslam_tpu_torch.io.calib import read_kitti_poses
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence

from test_torch_cli import _dynamic_tracker
from torch_threads import threads
from torch_tracking_layout import relayout_as_tracking

torch_threads = threads(2)

W, H, N, SEQ = 160, 120, 5, 3
PRESET = f"kitti-tracking-sequence-{SEQ:04d}"


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """(odometry folder, the same files as tracking sequence ``SEQ``)."""
    base = tmp_path_factory.mktemp("layouts")
    odo = str(base / "odometry")
    write_kitti_sequence(odo, num_frames=N, width=W, height=H,
                         with_dynamic=True, write_dispnet=True)
    return odo, relayout_as_tracking(odo, str(base / "tracking"), SEQ)


def _input(mod, dp, root, icfg):
    prov = dp.PrecomputedDepthProvider(
        os.path.join(root, icfg.depth_folder), icfg.depth_fname_format,
        input_is_depth=icfg.read_depth)
    return mod.Input(root, icfg, prov, (W, H), TCalib(0.5, 0.8 * W))


@pytest.mark.parametrize("dispnet", [False, True], ids=["elas-xml", "pfm"])
def test_readers_equal_over_layouts(folders, dispnet):
    """Frames and depth (``Input``), masks (the MNC dumps' provider), LIDAR
    and calibration: the JAX package's and the port's readers over the
    tracking folder, each equal to the port's over the odometry folder."""
    odo, trk = folders
    ocfg = (tin.kitti_odometry_dispnet_config() if dispnet
            else tin.kitti_odometry_config())
    ref = _input(tin, tdp, odo, ocfg)
    sides = []
    for mod, dp in ((jin, jdp), (tin, tdp)):
        icfg = (mod.kitti_tracking_dispnet_config(SEQ) if dispnet
                else mod.kitti_tracking_config(SEQ))
        assert icfg.left_gray_folder == icfg.left_color_folder
        sides.append(_input(mod, dp, trk, icfg))
    for f in range(N):
        ref.read_next_frame()
        want = ref.get_images() + ref.get_stereo_color()
        for inp in sides:
            assert inp.has_more_images()
            inp.read_next_frame()
            for a, b in zip(want, inp.get_images() + inp.get_stereo_color()):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert not any(inp.has_more_images() for inp in sides)
    assert [inp.get_dataset_identifier() for inp in sides] == [
        f"{PRESET}-tracking"] * 2

    icfg = tin.kitti_tracking_config(SEQ)
    providers = [tseg.PrecomputedSegmentationProvider(
        os.path.join(odo, ocfg.segmentation_folder), min_detection_size_px=8)]
    providers += [mod.PrecomputedSegmentationProvider(
        os.path.join(trk, icfg.segmentation_folder), min_detection_size_px=8)
        for mod in (jseg, tseg)]
    masks = 0
    for f in range(N):
        want, *got = (p.segment_frame(None).instance_detections
                      for p in providers)
        for dets in got:
            assert len(dets) == len(want), f
            for a, b in zip(want, dets):
                for m in ("copy_mask", "delete_mask", "conservative_mask"):
                    ma, mb = getattr(a, m), getattr(b, m)
                    assert vars(ma.bbox) == vars(mb.bbox), (f, m)
                    assert np.array_equal(ma.data, mb.data), (f, m)
        masks += len(want)
    assert masks >= N - 1

    lidar = tvel.VelodyneIO(os.path.join(odo, ocfg.velodyne_folder))
    for vel in (jvel, tvel):
        io = vel.VelodyneIO(os.path.join(trk, icfg.velodyne_folder),
                            icfg.velodyne_fname_format)
        for f in range(N):
            assert np.array_equal(io.read_frame(f), lidar.read_frame(f))

    want = tcal.read_kitti_calibration(os.path.join(odo, "calib.txt"))
    path = os.path.join(trk, icfg.calibration_fname)
    lines = open(path).read().splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "P0:", "P1:", "P2:", "P3:", "R_rect", "Tr_velo_cam", "Tr_imu_velo"]
    for cal in (jcal, tcal):
        got = cal.read_kitti_calibration(path)
        for k in ("proj_left_gray", "proj_right_gray", "proj_left_color",
                  "proj_right_color", "velo_to_left_cam"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k


def test_tracklets_equal_over_layouts(folders):
    odo, trk = folders
    want = ttr.read_grouped_tracklets(os.path.join(odo, "tracklets.txt"))
    path = os.path.join(trk, tin.kitti_tracking_config(SEQ).tracklet_folder)
    assert want
    for tr in (jtr, ttr):
        got = tr.read_grouped_tracklets(path)
        assert got.keys() == want.keys()
        for f, ts in want.items():
            for a, b in zip(ts, got[f]):
                assert (a.frame, a.track_id, a.bbox_2d) == (
                    b.frame, b.track_id, b.bbox_2d)
                assert np.array_equal(a.location_cam_m, b.location_cam_m)


def _csvs(out) -> dict:
    """{the CSV's kind (its name past the dataset identifier): (name,
    text)}."""
    d = os.path.join(out, "csv")
    out = {}
    for name in os.listdir(d):
        kind = name.split("-")[-3:] if "depth-result" in name \
            else name.split("-")[-1:]
        out["-".join(kind)] = (name, open(os.path.join(d, name)).read())
    return out


#: the CLI runs held equal over the two layouts: the staged path with
#: delayed evaluation, and the fused steps, static and dynamic
RUNS = {
    "staged": ["--enable_evaluation", "--evaluation_delay", "1"],
    "fused-static": ["--fused", "--no-dynamic_mode", "--max_depth", "8",
                     "--enable_evaluation"],
    "fused-dynamic": ["--fused", "--max_depth", "8", "--enable_evaluation"],
}


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_tracking_equals_odometry(folders, tmp_path, monkeypatch, run):
    """``--dataset_type kitti-tracking --kitti_tracking_sequence_id SEQ``
    over the tracking folder gives the trajectory of the odometry folder's
    run, equal, and CSVs of equal contents under the tracking preset's
    names; the staged run's tracks give ``TrackingEvaluation`` records
    with finite errors."""
    from dynslam_tpu_torch.eval.tracking_eval import TrackingEvaluation
    from dynslam_tpu_torch.pipeline.dynslam import DynSlam

    _dynamic_tracker(monkeypatch)
    odo, trk = folders
    base = ["--cpu", "--tiny", "--min_detection_size", "8",
            "--min_decay_age", "3"] + RUNS[run]
    layouts = {
        "odometry": ["--dataset_root", odo],
        "tracking": ["--dataset_root", trk, "--dataset_type",
                     "kitti-tracking", "--kitti_tracking_sequence_id",
                     str(SEQ)]}
    records = []
    if run == "staged":
        tev = TrackingEvaluation(ttr.read_grouped_tracklets(os.path.join(
            trk, tin.kitti_tracking_config(SEQ).tracklet_folder)))
        process = DynSlam.process_frame

        def process_frame(dyn, input_):
            n = dyn.current_frame_no
            ok = process(dyn, input_)
            if ok and input_.config.dataset_name == PRESET:
                records.extend(tev.evaluate_frame(dyn, n))
            return ok
        monkeypatch.setattr(DynSlam, "process_frame", process_frame)
    got = {}
    for layout, flags in layouts.items():
        out = str(tmp_path / layout)
        assert main.main(base + flags + ["--out", out]) == 0
        got[layout] = (read_kitti_poses(os.path.join(out, "trajectory.txt")),
                       _csvs(out))
    (to, co), (tt, ct) = got["odometry"], got["tracking"]
    assert to.shape == (N, 4, 4) and np.array_equal(tt, to)
    assert co.keys() == ct.keys() and len(ct) == (
        5 if run != "fused-static" else 4)
    for kind, (name, text) in ct.items():
        assert f"-{PRESET}-tracking-" in name, name
        assert text == co[kind][1], kind
    if run == "staged":
        assert records and all(np.isfinite([r.trans_error, r.rot_error])
                               .all() for r in records), records
