"""ba_s: the program's span `ba` (every bundle adjustment solve with its prune,
`ba_step`: the seed's, each view's, the merge's and the final; inside `seed`,
`incremental`, `components` or `final_ba`), summed over the window's sets and
divided by their number (s). None where the window's runs cannot be read from
the program (portbench/spans.py)."""
from portbench.spans import span_per_set


def read(record):
    return span_per_set(record, "ba")
