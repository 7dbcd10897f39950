"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference``).

``StepProbe`` wraps the port's step function (``pipeline.fused.
fused_step`` or ``pipeline.fused_dynamic.fused_dynamic_step``) for a run
and copies, at chosen frames only, what the step was handed and what it
returned, on the device and in the stream's order, so the copies cost
the window a few device copies and no host sync; at the next call it
compares the carry handed over with the one returned. After the window
the reference recomputes each captured step (``reference.replay``) and
``compare`` reads the gaps. Every number has its limit in the cell's
workload file (``"limits"``).

A check plug-in (``checks/<name>.py``) adds readings of its own: its
``probe(pipe, frames, run)`` is entered beside ``StepProbe`` for the run
(a context manager whose ``__enter__`` returns what it captured), and
after the window its ``gaps(captured, su, run)`` (``control_gaps`` for
the control) gives ``{frame: {reading: value}}`` for every checked frame
(``merge``).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import replay, tsdf
from benchmark.reference import segmentation as rseg


def plain(x):
    """A deep copy of ``x`` made of tensors, numpy arrays, dicts and
    scalars: named tuples and dataclasses become dicts, a generator its
    state."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, np.ndarray):
        return x.copy()
    if hasattr(x, "_asdict"):
        return {k: plain(v) for k, v in x._asdict().items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def leaves(x, path=()):
    """(path, leaf) pairs of ``x`` as ``plain`` walks it: named tuples and
    dataclasses as dicts of their fields."""
    if hasattr(x, "_asdict"):
        x = x._asdict()
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, path + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from leaves(v, path + (i,))
    else:
        yield path, x


def _differing(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elements of ``a`` and ``b`` that differ (NaN equals NaN), summed on
    the device."""
    d = a != b
    if a.is_floating_point():
        d &= ~(a.isnan() & b.isnan())
    return d.sum()


def _device_bytes(x) -> int:
    return sum(v.untyped_storage().nbytes() for _, v in leaves(x)
               if isinstance(v, torch.Tensor) and v.is_cuda)


#: carry fields the dynamic pipeline's oversize-mask fallback fuses into
#: between two steps (``_finish_one``)
FALLBACK_FIELDS = ("inst", "inst_fidx")


class StepProbe:
    """Wraps ``module.<name>`` and copies the calls whose carry's
    ``frame_idx`` is in ``frames``: ``captured[frame_idx] = (arguments,
    result)``, both ``plain``.

    At the call after each captured one it compares the carry and the
    generator handed in with what the captured call returned and left
    (``handover``: differing elements, counted on the device without a
    sync). ``fallbacks``, where given, counts the pipeline's oversize-mask
    fallbacks; one between the two calls changes the carry's volumes on
    purpose, which are then left out of that comparison.

    On a CUDA card it keeps the port's own peak of allocated memory
    (``port_peak``): the peak of each stretch between its copies, less the
    bytes of the copies it held over that stretch."""

    def __init__(self, module, name: str, frames, fallbacks=None):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.sig = inspect.signature(self.real)
        self.frames = set(frames)
        self.fallbacks = fallbacks or (lambda: 0)
        self.captured: Dict[int, tuple] = {}
        self.handover: Dict[int, tuple] = {}
        self._left: Dict[int, tuple] = {}
        self.held = self.peak = 0

    def _close(self, dev) -> None:
        """Ends a stretch: its peak, less the copies held, is the port's."""
        if dev.type == "cuda":
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(dev)
                            - self.held)

    @staticmethod
    def _open(dev) -> None:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def _compare_handover(self, k: int, arguments: dict) -> tuple:
        """(host count, device count) of what differs between the carry
        and generator step ``k`` returned and left and those handed to
        step ``k + 1``."""
        gen_left, fallbacks = self._left[k]
        skip = FALLBACK_FIELDS if self.fallbacks() != fallbacks else ()
        got = dict(leaves(self.captured[k][1][0]))
        handed = {p: v for p, v in leaves(arguments["carry"])
                  if p[0] not in skip}
        got = {p: v for p, v in got.items() if p[0] not in skip}
        host = len(set(got) ^ set(handed))
        counts = []
        for p in set(got) & set(handed):
            a, b = got[p], handed[p]
            if isinstance(a, torch.Tensor):
                if not isinstance(b, torch.Tensor) or a.shape != b.shape \
                        or a.dtype != b.dtype:
                    host += 1
                else:
                    counts.append(_differing(a, b))
            elif isinstance(a, np.ndarray):
                host += int(not np.array_equal(
                    a, b, equal_nan=a.dtype.kind == "f"))
            else:
                host += int(a != b)
        gen = arguments.get("generator")
        if gen is not None:
            host += int(not torch.equal(gen_left, gen.get_state()))
        return host, torch.stack(counts).sum() if counts else None

    def handover_diff(self, k: int) -> float:
        """Elements that differ in step ``k``'s hand-over to step ``k + 1``
        (inf where step ``k + 1`` never ran); syncs."""
        if k not in self.handover:
            return float("inf")
        host, dev = self.handover[k]
        return float(host + (int(dev) if dev is not None else 0))

    def port_peak(self, dev) -> int:
        self._close(dev)
        self._open(dev)
        return self.peak

    def __enter__(self):
        real, sig = self.real, self.sig

        def probe(*args, **kw):
            bound = sig.bind(*args, **kw)
            carry = bound.arguments["carry"]
            fi = carry.frame_idx
            if fi not in self.frames and fi - 1 not in self.frames:
                return real(*args, **kw)
            dev = carry.pose_w2c.device
            self._close(dev)
            if fi - 1 in self.frames:
                self.handover[fi - 1] = self._compare_handover(
                    fi - 1, bound.arguments)
            if fi not in self.frames:
                self._open(dev)
                return real(*args, **kw)
            before = plain(dict(bound.arguments))
            self.held += _device_bytes(before)
            self._open(dev)
            out = real(*args, **kw)
            self._close(dev)
            copy = plain(out)
            self.held += _device_bytes(copy)
            self.captured[fi] = (before, copy)
            gen = bound.arguments.get("generator")
            self._left[fi] = (None if gen is None else gen.get_state(),
                              self.fallbacks())
            self._open(dev)
            return out
        setattr(self.module, self.name, probe)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


# ---------------------------------------------------------------------------
# gaps
# ---------------------------------------------------------------------------

#: the readings ``compare_step`` and the hand-over give every checked
#: frame: every cell's, then the dynamic step's
STEP_READINGS = ("depth_diff_share", "pose_gap", "map_diff_share",
                 "raycast_diff_share", "config_diff", "handover_diff")
DYNAMIC_READINGS = ("mask_bits_diff", "motion_gap", "instance_diff_share",
                    "cut_diff_share")
ALL_READINGS = STEP_READINGS + DYNAMIC_READINGS


def readings(dynamic: bool) -> tuple:
    """The built-in check's readings of a static or dynamic cell."""
    return ALL_READINGS if dynamic else STEP_READINGS



def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double().to(a.device)).abs().max())


#: what counts as a differing voxel, pixel or crop pixel: an sdf 1% of
#: the truncation band apart, a colour channel 2 levels apart, a depth
#: 1 cm apart
SDF_TOL, RGB_TOL, DEPTH_TOL_M = 0.01, 2, 0.01


def map_diff_share(got: dict, ref: tsdf.TsdfState) -> float:
    """Share of the map that differs: the larger of the share of voxels,
    over the rows valid on either side, whose sdf, weight or colour
    differs, and the share of those rows whose block table entry (valid,
    coords, allocation and last-seen frame) differs."""
    dev = ref.valid.device
    valid = got["valid"].to(dev) | ref.valid
    rows = int(valid.sum())
    if rows == 0:
        return 0.0
    gw, rw = got["tsdf_w"].to(dev)[valid], ref.tsdf_w[valid]
    gc, rc = got["color"].to(dev)[valid], ref.color[valid]
    sdf = ((gw >> 16).float() - (rw >> 16).float()).abs() / tsdf.SDF_SCALE
    rgb = torch.stack([((gc >> s) & 0xFF) - ((rc >> s) & 0xFF)
                       for s in (16, 8, 0)], -1).abs().amax(-1)
    vox = (sdf > SDF_TOL) | ((gw & 0xFFFF) != (rw & 0xFFFF)) \
        | (rgb > RGB_TOL)
    table = (got["valid"].to(dev) != ref.valid) \
        | (got["block_coords"].to(dev) != ref.block_coords).any(-1) \
        | (got["alloc_frame"].to(dev) != ref.alloc_frame) \
        | (got["last_seen"].to(dev) != ref.last_seen)
    return max(float(vox.sum()) / vox.numel(),
               float(table[valid].sum()) / rows)


def depth_diff_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of pixels whose depth is more than 1 cm apart (a pixel valid
    on one side only counts)."""
    return float(((got.to(ref.device) - ref).abs() > DEPTH_TOL_M)
                 .float().mean())


def raycast_diff_share(got: dict, ref) -> float:
    """Share of pixels whose render differs: hit on one side only, or a
    depth more than 1 mm apart."""
    d = got["depth"].to(ref.depth.device)
    bad = (got["hit"].to(ref.hit.device) != ref.hit) \
        | ((d - ref.depth).abs() > 1e-3)
    return float(bad.float().mean())


def motion_gap(got: torch.Tensor, ref: torch.Tensor, K: int) -> float:
    """The widest gap in the packed outputs' motions: the camera's delta
    and pose, and each object twist that both sides estimated; an object
    estimate that succeeded on one side only reads 1."""
    from benchmark.reference.step import pack_layout

    lay, _ = pack_layout(K)
    got = got.to(ref.device).double()
    ref = ref.double()

    def part(v, name):
        o, n = lay[name]
        return v[o:o + n]
    gap = max(float((part(got, k) - part(ref, k)).abs().max())
              for k in ("delta", "pose"))
    ok_g, ok_r = part(got, "obj_success") > 0.5, part(ref, "obj_success") > 0.5
    if bool((ok_g != ok_r).any()):
        return max(gap, 1.0)
    both = ok_g & ok_r
    if bool(both.any()):
        tr = (part(got, "obj_tr") - part(ref, "obj_tr")).view(K, 6)
        gap = max(gap, float(tr[both].abs().max()))
    return gap


def _config_diff(args: dict, su: replay.Setup) -> int:
    """Fields of the configurations the port handed its step that differ
    from what the reference derives from the configuration file."""
    c = su.config
    want = {"cfg": dataclasses.asdict(su.cfg),
            "stereo_params": dataclasses.asdict(c.stereo),
            "vo_params": dataclasses.asdict(c.vo),
            "decay_enabled": replay.decay_on(su, args["carry"]["frame_idx"])}
    if c.dynamic_mode:
        want.update(icfg=dataclasses.asdict(su.icfg_fuse),
                    obj_params=dataclasses.asdict(su.obj_params),
                    inst_decay=bool(c.decay.enabled), K=su.K, S=su.S,
                    fuse_from_prev=True)
        r = args["routing"]
        want_r = (float(c.decay.max_decay_weight), int(c.decay.min_decay_age))
        n = int((float(r["max_decay_weight"]), int(r["min_decay_age"]))
                != want_r)
    else:
        want.update(max_decay_weight=float(c.decay.max_decay_weight),
                    min_decay_age=int(c.decay.min_decay_age))
        n = 0
    for key, value in want.items():
        got = args[key]
        if isinstance(value, dict):
            n += sum(1 for k, v in value.items()
                     if (tuple(got[k]) if isinstance(got[k], (list, tuple))
                         else got[k]) != (tuple(v) if isinstance(v, (list, tuple))
                                          else v))
        else:
            n += int(got != value)
    cv = args["calib_vec"].tolist()
    iv = args["intr_vec"].tolist()
    want_cv = torch.tensor([su.cfg.fx, su.cfg.cx, su.cfg.cy,
                            c.calibration.baseline_m]).tolist()
    want_iv = torch.tensor([su.cfg.fx, su.cfg.fy, su.cfg.cx,
                            su.cfg.cy]).tolist()
    bf = c.calibration.baseline_m * c.calibration.focal_length_px
    n += int(cv != want_cv) + int(iv != want_iv) + int(args["bf"] != bf)
    return n


def compare_step(su: replay.Setup, args: dict, out, ref_carry, ref_out,
                 planes=None) -> Dict[str, float]:
    """The gaps between a captured step (``args``, ``out``: plain) and the
    reference's run of it."""
    got_carry, got_out = out
    g = {"depth_diff_share": depth_diff_share(got_out["depth_m"],
                                              ref_out.depth_m),
         "pose_gap": _max_abs(got_out["pose_w2c"], ref_out.pose_w2c),
         "map_diff_share": map_diff_share(got_carry["state"], ref_carry.state),
         "raycast_diff_share": raycast_diff_share(got_out["raycast"],
                                                  ref_out.raycast),
         "config_diff": float(_config_diff(args, su))}
    if su.config.dynamic_mode:
        db, cb = (torch.from_numpy(p).to(args["delete_bits"].device)
                  for p in planes)
        mism = (args["delete_bits"].long() != db) \
            | (args["copy_bits"].long() != cb)
        g["mask_bits_diff"] = float(mism.sum())
        g["motion_gap"] = motion_gap(got_out["packed"], ref_out.packed,
                                     su.K)
        g["instance_diff_share"] = map_diff_share(got_carry["inst"],
                                                  ref_carry.inst)
        g["cut_diff_share"] = depth_diff_share(got_carry["pending_depth"],
                                               ref_carry.pending_depth)
    return g


def ref_planes(cell_root: str, su: replay.Setup, frame: int):
    """The reference's (delete, copy) planes of frame ``frame``: its own
    read of the dump files, selection and packing."""
    dets = rseg.read_detections(
        cell_root, frame, su.config.tracker.min_detection_size_px)
    return rseg.pack_bits(rseg.select(dets, su.K),
                          su.config.frame_height, su.config.frame_width)


def _run_reference(su: replay.Setup, fi: int, args: dict, frames_u8,
                   seg_folder, seed: int, lowp: bool):
    """The reference's run of captured step ``fi``: (carry', outputs,
    planes). Frame 1 starts from the reference's own carry of frame 0's
    images and a generator seeded with ``seed``; later frames from a copy
    of the captured carry and generator state."""
    dev = args["carry"]["pose_w2c"].device
    if fi == 1:
        carry = replay.fresh_carry(su, replay.gray(frames_u8[0][0], dev),
                                   replay.gray(frames_u8[0][1], dev))
        gen = replay.generator(dev, seed=seed)
    else:
        carry = replay.carry_from(plain(args["carry"]),
                                  su.config.dynamic_mode)
        gen = replay.generator(dev, state=args["generator"])
    planes = routing = None
    if su.config.dynamic_mode:
        planes = ref_planes(seg_folder, su, fi)
        routing = {k: v for k, v in args["routing"].items()
                   if k not in ("max_decay_weight", "min_decay_age")}
    ref_carry, ref_out = replay.run_step(
        su, carry, frames_u8[fi][0], frames_u8[fi][1], gen, planes, routing,
        lowp=lowp)
    return ref_carry, ref_out, planes


def replay_captured(su: replay.Setup, captured: dict, frames_u8, seg_folder,
                    seed: int) -> List[Dict[str, float]]:
    """Each captured step run again by the reference and compared with
    what the port returned: one dict of gaps a frame."""
    gaps = []
    for fi in sorted(captured):
        args, out = captured[fi]
        ref_carry, ref_out, planes = _run_reference(
            su, fi, args, frames_u8, seg_folder, seed, lowp=False)
        gaps.append(compare_step(su, args, out, ref_carry, ref_out, planes))
        del ref_carry, ref_out
    return gaps


def control_gaps(su: replay.Setup, captured: dict, frames_u8, seg_folder,
                 seed: int) -> List[Dict[str, float]]:
    """The control: the reference in bfloat16 (``lowp``) put in the port's
    place, against the reference in float32, on the same captured steps."""
    gaps = []
    for fi in sorted(captured):
        args, _ = captured[fi]
        low_carry, low_out, _ = _run_reference(
            su, fi, args, frames_u8, seg_folder, seed, lowp=True)
        low = (plain(low_carry), plain(low_out))
        del low_carry, low_out
        ref_carry, ref_out, planes = _run_reference(
            su, fi, args, frames_u8, seg_folder, seed, lowp=False)
        gaps.append(compare_step(su, args, low, ref_carry, ref_out, planes))
        del ref_carry, ref_out, low
    return gaps


def merge(by_frame: Dict[int, Dict[str, float]], got: dict, names,
          frames) -> List[tuple]:
    """Adds a plug-in's gaps ``got`` ({frame: {reading: value}}) of the
    readings ``names`` to ``by_frame``; returns the (frame, reading) pairs
    of ``frames`` it gave no reading for."""
    missing = []
    for fi in frames:
        g = got.get(fi, {})
        for name in names:
            if name in g:
                by_frame.setdefault(fi, {})[name] = float(g[name])
            else:
                missing.append((fi, name))
    return missing


def judge(gaps: List[Dict[str, float]], limits: Dict[str, float]):
    """(correct, [(name, worst reading, limit)]): each number is the worst
    over the checked frames, and holds when it is at most its limit; a
    limit that no frame has a reading for fails."""
    rows = []
    for name, limit in limits.items():
        vals = [g[name] for g in gaps if name in g]
        if not vals:
            continue
        rows.append((name, max(vals), float(limit)))
    ok = bool(gaps) and len(rows) == len(limits) \
        and all(v <= lim for _, v, lim in rows) \
        and all(all(np.isfinite(list(g.values()))) for g in gaps)
    return ok, rows
