"""The port's command-line tools (``python -m dynslam_tpu_torch.scripts.
<name>``), counterparts of the repository's ``scripts/``."""
