"""``device_idle``: the share of the traced window's wall time in which no kernel, copy or memset ran on the card, in %."""

LAYER = "device"
UNIT = "%"
MOVES = "fps"


def read(s):
    if not s.window_s or not s.device:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
