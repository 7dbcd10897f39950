"""The benchmark's plain reference: plain PyTorch and numpy that work out
again what the port's timed path derives. It imports neither ``jax`` nor
``dynslam_tpu`` nor anything of ``dynslam_tpu_torch``."""
