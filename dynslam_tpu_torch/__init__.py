"""dynslam_tpu_torch — the PyTorch + CUDA port of dynslam_tpu.

The static and dynamic fused frame steps (census stereo, sparse VO with
an ICP fallback, TSDF allocate / fuse / raycast / decay, per-object
volumes) and their in-loop LIDAR evaluation (``eval/``) run on one NVIDIA
GPU, with hand-written CUDA kernels for fusion (``ops/integrate.py``)
and raycasting (``ops/raycast.py``). Every kernel has a plain PyTorch
version in the same module; the wrappers use it only for CPU tensors.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: ``config.py`` holds its own copy of the configuration fields it
reads.
"""

from dynslam_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
