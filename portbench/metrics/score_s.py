"""score_s: the program's span `baseline.score` (pair scoring and the epipolar
prefilter of every pair, both match tables, the scores to the host; inside
`baseline`), summed over the window's sets and divided by their number (s).
None where the window's runs cannot be read from the program (portbench/spans.py)."""
from portbench.spans import span_per_set


def read(record):
    return span_per_set(record, "baseline.score")
