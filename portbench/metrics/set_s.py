"""set_s: the window's wall time over the image sets completed in it (s)."""


def read(record):
    return record["window_s"] / record["n_sets"]
