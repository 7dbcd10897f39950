"""Evaluation of the fused pipelines — the port of
``dynslam_tpu/eval/fused_eval.py``.

The reference evaluates inside its frame loop (``EvaluateFrame`` and
``LogMemoryUse``, DynSlam.cpp:154-161). Here the frame thread only
enqueues: ``submit`` hands the frame's device depth maps to one worker
thread, which reads the LIDAR scan, uploads it, computes the packed
result (``evaluate_depth_packed``) and fetches it; the frame thread
writes the CSV rows when it joins the oldest job, at most
``max_outstanding`` frames later, so rows land in frame order.

Streams: the worker launches on its current stream, which for a thread
PyTorch has not told otherwise is the device's default stream, the one
the pipelines run on. So the eval reads the depth maps after the kernels
that wrote them, in stream order, and the caching allocator reuses their
memory only after the eval ran. The only host syncs are the worker's own
(its fetch); the frame thread takes none.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dynslam_tpu_torch.eval.evaluation import (
    Evaluation, evaluate_depth_packed,
)
from dynslam_tpu_torch.eval.records import MemoryUsageEntry
from dynslam_tpu_torch.ops.tsdf import BLOCK3, BYTES_PER_VOXEL


def _stage(name: str):
    """A named range for torch.profiler (``chip_smoke.py`` tabulates
    them): ``submit`` on the frame thread, ``job`` on the worker."""
    return torch.profiler.record_function(f"fused_eval.{name}")


def _fetch(packed: torch.Tensor) -> np.ndarray:
    """The worker's device -> host fetch of the packed result: a copy into
    pinned memory and a wait on its event, which blocks only the worker
    (module-level, so that a test can make it fail)."""
    if packed.device.type != "cuda":
        return packed.numpy()
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    event.synchronize()
    return host.numpy()


class FusedEvaluation(Evaluation):
    """Per-frame evaluation and CSV logging from device-resident outputs,
    with the work and the fetch on one background thread.

    ``submit(frame, rendered, input, assoc, used, decayed)`` once per
    frame; the rows (depth results and the memory entry) are written when
    the frame's job is joined, at most ``max_outstanding`` frames later,
    and all of them by ``drain`` or ``close``."""

    #: frames in flight before the oldest job is joined
    max_outstanding = 2

    def __init__(self, dataset_root, input_config, input_, calib, config,
                 csv_out_dir: str = "csv", device=None):
        super().__init__(dataset_root, input_config, input_, calib, config,
                         csv_out_dir=csv_out_dir, device=device)
        if self.params.evaluation_delay:
            raise ValueError(
                "fused evaluation supports evaluation_delay=0 only (the "
                "staged path handles delayed evaluation)")
        self._dataset_id = input_.get_dataset_identifier()
        self._frame_offset = input_.frame_offset
        self._pending: deque = deque()
        #: one worker keeps the rows in frame order without locks
        self._exec = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="fused-eval")
        #: background fetches that failed and were retried synchronously
        self.failed_fetches = 0
        #: the worker's wall time of each LIDAR job (read, upload, eval,
        #: fetch), ms
        self.job_ms = []
        self._n_deltas = len(self._all_deltas)
        #: the all-static association map, made once on the device
        self._zero_assoc = None

    def submit(
        self,
        eval_frame: int,
        rendered_depth,  # (H, W) f32 on the device (composited render)
        input_depth,  # (H, W) f32 on the device
        assoc,  # (H, W) int8, host or device; None = all static
        used_blocks,  # host int or 0-d tensor: post-decay blocks
        decayed_blocks,  # host int or 0-d tensor: cumulative decayed
    ) -> None:
        """Evaluate one finished frame. The frame thread only enqueues;
        the LIDAR read, upload, eval and fetch run on the worker."""
        if not self.params.enabled:
            return
        with _stage("submit"):
            fut = self._exec.submit(self._eval_job, eval_frame,
                                    rendered_depth, input_depth, assoc,
                                    used_blocks, decayed_blocks)
            self._pending.append((eval_frame, fut))
            self._drain_over(self.max_outstanding)

    def _eval_job(self, *args):
        with _stage("job"):
            return self._job(*args)

    def _job(self, eval_frame, rendered_depth, input_depth, assoc,
             used_blocks, decayed_blocks):
        """Worker side: ("mem", used, decayed) for a frame without a LIDAR
        scan, else ("eval", packed numpy)."""
        input_frame_idx = self._frame_offset + eval_frame
        if not self.velodyne.frame_available(input_frame_idx):
            # no depth rows (Evaluation.cpp:54-59), but the memory entry,
            # as the reference's LogMemoryUse
            return ("mem", int(used_blocks), int(decayed_blocks))
        t0 = time.perf_counter()
        lidar = self._lidar(self.velodyne.read_frame(input_frame_idx))
        if assoc is None:
            if self._zero_assoc is None:
                self._zero_assoc = torch.zeros(
                    (self.config.frame_height, self.config.frame_width),
                    dtype=torch.int8, device=self.device)
            assoc = self._zero_assoc
        packed = evaluate_depth_packed(
            lidar, self._velo_to_cam, self._proj,
            self._on_device(rendered_depth, np.float32),
            self._on_device(input_depth, np.float32),
            self._on_device(assoc, np.int8), self._consts, used_blocks,
            decayed_blocks, self._all_deltas, self._kitti_flags)
        try:
            out = _fetch(packed)
        except Exception:
            # retry synchronously so that the frame's rows still land, but
            # loudly: a fetch that fails every frame stalls every frame
            self.failed_fetches += 1
            print(f"[WARNING: eval fetch thread failed for frame "
                  f"{eval_frame}; retrying synchronously "
                  f"({self.failed_fetches} failures so far)]",
                  file=sys.stderr)
            out = packed.cpu().numpy()
        self.job_ms.append((time.perf_counter() - t0) * 1e3)
        return ("eval", out)

    def _write_memory_row(self, eval_frame: int, used: int,
                          decayed: int) -> None:
        block_bytes = BLOCK3 * BYTES_PER_VOXEL
        self.csv_memory.write(MemoryUsageEntry(
            eval_frame, used * block_bytes, decayed * block_bytes,
            self.config.decay))

    def _join_oldest(self) -> None:
        eval_frame, fut = self._pending.popleft()
        kind, *payload = fut.result()
        if kind == "mem":
            self._write_memory_row(eval_frame, *payload)
            return
        packed = payload[0]
        nc = self._n_deltas * 3 * 2 * 4
        counts = packed[:nc].reshape(self._n_deltas, 3, 2, 4)
        epi, neg, n_ok = (int(x) for x in packed[nc:nc + 3])
        used, decayed = (int(x) for x in packed[nc + 3:nc + 5])
        self._write_memory_row(eval_frame, used, decayed)
        self.warn_gt_stats(epi, neg, n_ok)
        self.write_frame_rows(eval_frame, self._dataset_id, counts)

    def _drain_over(self, keep: int) -> None:
        while len(self._pending) > keep:
            self._join_oldest()

    def drain(self) -> None:
        """Join every outstanding job and write its rows, in frame order."""
        self._drain_over(0)

    def close(self) -> None:
        self.drain()
        self._exec.shutdown(wait=True)
        if self.failed_fetches:
            print(f"[WARNING: {self.failed_fetches} eval background "
                  f"fetches failed over the run (each degraded that "
                  f"frame to a synchronous fetch)]", file=sys.stderr)
        super().close()

