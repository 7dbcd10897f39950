"""Device selection: CUDA unless the caller asks for the CPU.

There is no silent CPU fallback. The CPU runs the plain PyTorch versions
of the kernels, which is what the parity tests want; it is chosen only
when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


#: ``constant``'s tensors by (values, dtype, device): a test can check that
#: none was written into (``Tensor._version`` counts in-place writes)
CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once per process and
    shared: callers must not write into it. A fresh ``torch.tensor(...,
    device="cuda")`` copies from pageable host memory, which waits for
    the stream, i.e. costs one host sync per call."""
    def freeze(v):
        return tuple(freeze(x) for x in v) if isinstance(v, (list, tuple)) \
            else v
    key = (freeze(values), dtype, torch.device(device))
    t = CONSTANTS.get(key)
    if t is None:
        t = CONSTANTS[key] = torch.tensor(key[0], dtype=dtype,
                                          device=key[2])
    return t


def upload(array, device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device`` without a host sync:
    to a CUDA device through pinned memory and a non-blocking copy (the
    caching host allocator keeps the pinned block until the copy ran);
    on the CPU a copy."""
    t = torch.from_numpy(np.array(array, copy=True))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; raises if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dynslam_tpu_torch: CUDA requested but torch.cuda.is_available() "
            "is False (pass device='cpu' to run the plain PyTorch versions)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

