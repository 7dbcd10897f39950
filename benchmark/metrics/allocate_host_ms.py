"""``allocate_host_ms``: host time a frame of the ``fused_step.allocate`` range."""

LAYER = "allocate and visibility"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.stage("fused_step.allocate", "host_ms")
