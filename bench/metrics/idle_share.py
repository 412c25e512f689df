"""Device: the share of the traced stretch in which no device record
ran, 1 - (union of the records' intervals) / (stretch), in %."""

from bench.devtrace import union_busy


def read(td):
    if td.window_us <= 0 or not td.device_ops:
        return None
    busy, _ = union_busy(td.device_ops, td.window_us)
    return 100.0 * (1.0 - busy / td.window_us)
