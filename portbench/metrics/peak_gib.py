"""peak_gib: torch.cuda.max_memory_allocated() over the window, reset at its
start (GiB)."""


def read(record):
    if record.get("peak_bytes") is None:
        return None
    return record["peak_bytes"] / 2**30
