"""``fetch_wait_ms``: host time a frame of the ``fused_dyn.fetch_wait`` range: the host tracker's wait on the event of a dispatch's packed fetch, i.e. for that dispatch's device work."""

LAYER = "host wrapper"
UNIT = "ms"
MOVES = "frame_device_ms"


def read(s):
    return s.stage("fused_dyn.fetch_wait", "host_ms")
