"""``upload_host_ms``: host time a frame of the ``fused_step.upload`` range: the frame's input copies from host memory (a blocking copy each) and the RGB fill."""

LAYER = "host wrapper"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.stage("fused_step.upload", "host_ms")
