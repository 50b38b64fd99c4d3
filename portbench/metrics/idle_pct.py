"""idle_pct: the share of the traced window in which nothing ran on the
card (1 - union of kernel, copy and memset intervals / window), in %."""


def read(record):
    if record.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
