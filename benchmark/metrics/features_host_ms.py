"""``features_host_ms``: host time a frame of the ``fused_step.features`` range."""

LAYER = "features"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.stage("fused_step.features", "host_ms")
