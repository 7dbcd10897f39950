"""``tracker_host_ms``: host time a frame of the host tracker: the ``fused_dyn.associate`` range (association, slot actions and mask planes before the dispatch) and the ``fused_dyn.tracker`` range (``Track.update``, ProcessReconstructions, the oversize fallback and the prune after the packed fetch)."""

LAYER = "host tracker"
UNIT = "ms"
MOVES = "frame_device_ms"


def read(s):
    parts = [s.stage(f"fused_dyn.{n}", "host_ms")
             for n in ("associate", "tracker")]
    return None if None in parts else sum(parts)
