"""``decay_device_ms``: kernel time a frame inside the ``fused_step.decay`` range."""

LAYER = "decay"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.stage("fused_step.decay", "device_ms")
