"""``loop_host_ms``: host time a frame of the harness's span around ``process_frame`` (``bench.loop``)."""

LAYER = "host wrapper"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.stage("bench.loop", "host_ms")
