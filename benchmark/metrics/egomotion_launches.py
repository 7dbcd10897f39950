"""``egomotion_launches``: kernels launched a frame inside the ``fused_step.egomotion`` range."""

LAYER = "egomotion"
UNIT = "launches/frame"
MOVES = "fps"


def read(s):
    return s.stage("fused_step.egomotion", "launches")
