"""seed_s: the program's span `seed` (each `SfMPipeline._try_seed` call: the seed
basins' two-view bootstraps and BAs and the third view's PnP, triangulation
and BA; the main seed inside `baseline`, a secondary component's inside
`components`), summed over the window's sets and divided by their number (s).
None where the window's runs cannot be read from the program
(portbench/spans.py)."""
from portbench.spans import span_per_set


def read(record):
    return span_per_set(record, "seed")
