"""``instances_host_ms``: host time a frame of the ``fused_dyn.instances`` range."""

LAYER = "instance fusion"
UNIT = "ms"
MOVES = "frame_device_ms"


def read(s):
    return s.stage("fused_dyn.instances", "host_ms")
