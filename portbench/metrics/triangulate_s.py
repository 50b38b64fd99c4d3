"""triangulate_s: the program's span `triangulate` (each
`triangulate_new_view_all` call: after a registration, in a merge, in the
rotavg re-fuse; the seed's third view inside `seed`), summed over the window's
sets and divided by their number (s). None where the window's runs cannot be
read from the program (portbench/spans.py)."""
from portbench.spans import span_per_set


def read(record):
    return span_per_set(record, "triangulate")
