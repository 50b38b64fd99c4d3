"""pnp_s: the program's span `pnp` (each PnP registration, `register_view`
through its `bool(ok)`; the seed's third view inside `seed`), summed over the
window's sets and divided by their number (s). None where the window's runs
cannot be read from the program (portbench/spans.py)."""
from portbench.spans import span_per_set


def read(record):
    return span_per_set(record, "pnp")
