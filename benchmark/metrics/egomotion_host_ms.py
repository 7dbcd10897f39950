"""``egomotion_host_ms``: host time a frame of the ``fused_step.egomotion`` range."""

LAYER = "egomotion"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.stage("fused_step.egomotion", "host_ms")
