"""``obj_ransac_host_ms``: host time a frame of the ``fused_dyn.obj_ransac`` range."""

LAYER = "object RANSAC"
UNIT = "ms"
MOVES = "frame_device_ms"


def read(s):
    return s.stage("fused_dyn.obj_ransac", "host_ms")
