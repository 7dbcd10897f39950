"""``k1_roofline``: the static map's K1 launches of the traced frames: their bound (``roofline.integrate_bound_ms`` over the distinct bytes and operations) over their kernel time inside ``fused_step.integrate``, in %."""

LAYER = "K1 fusion kernel"
UNIT = "%"
MOVES = "fps"


def read(s):
    t = s.kernel_ms("integrate_kernel", "fused_step.integrate")
    k1 = s.extra.get("k1")
    if not t or not k1 or not k1["launches"]:
        return None
    return 100.0 * k1["bound_ms"] / (t * s.n)
