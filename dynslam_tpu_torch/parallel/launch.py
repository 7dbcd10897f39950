"""Process groups for ``torch.distributed``: gloo on the CPU, NCCL on CUDA.

``spawn(fn, world, device, *args)`` starts ``world`` processes, each in a
group of that size (rank r on ``cuda:r`` for CUDA), runs
``fn(rank, world, device, *args)`` in each and returns their results in
rank order; a failure in any process raises here. ``group(world, rank,
device, port)`` joins one process to a group for the length of a
``with`` block (world size 1 runs in the calling process). Nothing tells
a program of a cluster, so the group meets at ``tcp://localhost:<port>``
on a free port.
"""

from __future__ import annotations

import contextlib
import datetime
import queue
import socket
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dynslam_tpu_torch.device import DeviceLike, resolve_device

#: seconds a group waits for its members, and ``spawn`` for its workers
TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def group(world: int, rank: int, device: DeviceLike = None,
          port: int | None = None):
    """This process as rank ``rank`` of a group of ``world`` (a free port
    when ``port`` is None, for world size 1). Yields the rank's device
    (``cuda:rank`` for CUDA); destroys the group on exit."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    if port is None:
        if world != 1:
            raise ValueError("group: a port is needed for world size > 1")
        port = free_port()
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=dev if dev.type == "cuda" else None)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _worker(rank: int, fn, world: int, device: str, port: int, args,
            results) -> None:
    torch.set_num_threads(1)
    with group(world, rank, device, port) as dev:
        out = fn(rank, world, dev, *args)
    results.put((rank, out))


def spawn(fn: Callable[..., Any], world: int, device: DeviceLike = None,
          *args) -> List[Any]:
    """``fn(rank, world, device, *args)`` in ``world`` new processes joined
    in one group; their results (picklable) in rank order. ``fn`` must be
    importable by name (a module-level function)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"spawn: {world} processes need {world} CUDA "
                           f"devices, {torch.cuda.device_count()} found")
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(
        _worker, args=(fn, world, dev.type, free_port(), args, results),
        nprocs=world, join=False, start_method="spawn")
    out = {}
    # drain while joining: a worker blocks on a full pipe until read
    while not ctx.join(timeout=0.1):
        with contextlib.suppress(queue.Empty):
            while True:
                rank, value = results.get_nowait()
                out[rank] = value
    while len(out) < world:
        rank, value = results.get(timeout=TIMEOUT_S)
        out[rank] = value
    return [out[r] for r in range(world)]
