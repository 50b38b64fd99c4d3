"""host_syncs: synchronising calls per set, counted in the traced window as
the warnings of torch.cuda.set_sync_debug_mode("warn"), every one of them."""


def read(record):
    if record.get("syncs") is None:
        return None
    return record["syncs"] / record["n_sets"]
