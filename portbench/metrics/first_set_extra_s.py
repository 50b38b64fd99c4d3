"""first_set_extra_s: the root span `set` of the program's first
`SfMPipeline.run` in the process (the warm-up's, which pays the lazy
library loads and first calls) minus the mean `set` span of the window's
sets (s). None where either cannot be read from the program
(portbench/spans.py)."""
from portbench.spans import first_run, span_s, window_runs


def read(record):
    runs, first = window_runs(record), first_run()
    if runs is None or first is None:
        return None
    return span_s(first["spans"][0]) - sum(span_s(run["spans"][0]) for run in runs) / len(runs)
