"""``loop_unspanned_ms``: host time a frame of the ``bench.loop`` ranges (the harness's span around ``process_frame``) that no ``fused_step.*``, ``fused_dyn.*`` or ``fused_eval.*`` range covers: the union of the port's ranges, nested and overlapping ones counted once, taken from each loop's length. The summary keeps no thread, so a port range of another thread would count as covering: in the cells only the frame thread opens them (the segmentation worker opens ``bench.seg_worker``; no cell runs the evaluation worker)."""

from benchmark.trace import union_us

LAYER = "host wrapper"
UNIT = "ms"
MOVES = "fps"
LOOP = "bench.loop"
PORT = ("fused_step.", "fused_dyn.", "fused_eval.")


def read(s):
    loops = [(t0, t1) for t0, t1, name in s.host_ranges if name == LOOP]
    if not loops:
        return None
    port = [(t0, t1) for t0, t1, name in s.host_ranges
            if name.startswith(PORT)]
    out = 0.0
    for a, b in loops:
        inside = [(max(t0, a), min(t1, b)) for t0, t1 in port
                  if t0 < b and t1 > a]
        out += (b - a) - union_us(inside)
    return out / 1e3 / s.n
