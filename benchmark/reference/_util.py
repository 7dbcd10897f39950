"""Helpers of the reference: small constants on a device, host uploads."""

from __future__ import annotations

import numpy as np
import torch


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``."""
    return torch.tensor(values, dtype=dtype, device=device)


def upload(array, device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device``."""
    return torch.from_numpy(np.array(array, copy=True)).to(device)
