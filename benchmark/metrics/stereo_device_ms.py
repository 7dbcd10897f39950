"""``stereo_device_ms``: kernel time a frame inside the ``fused_step.stereo`` range."""

LAYER = "stereo"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.stage("fused_step.stereo", "device_ms")
