"""``k2_device_ms``: time a frame of the raycast's candidate pre-pass and march kernels (``candidates_kernel``, ``march_kernel``)."""

LAYER = "K2 raycast kernels"
UNIT = "ms"
MOVES = "fps"


def read(s):
    t = [s.kernel_ms(k) for k in ("candidates_kernel", "march_kernel")]
    t = [v for v in t if v is not None]
    return sum(t) if t else None
