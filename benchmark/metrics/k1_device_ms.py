"""``k1_device_ms``: time a frame of the fusion kernel (``integrate_kernel``, every launch: the static map and the object volumes)."""

LAYER = "K1 fusion kernel"
UNIT = "ms"
MOVES = "fps"


def read(s):
    return s.kernel_ms("integrate_kernel")
