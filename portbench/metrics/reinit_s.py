"""reinit_s: the program's span `reinit` (the rotation-averaging reinit at
16+ registered views: `_rotavg_initialize` and, where it returns a
candidate, `_accept_reinit`'s three global solves; inside `final_ba`),
summed over the window's sets and divided by their number (s). None where
the window's runs cannot be read from the program, or no run holds the span
(a program that does not trace the reinit)."""
from portbench.spans import span_s, window_runs


def read(record):
    runs = window_runs(record)
    if runs is None:
        return None
    spans = [s for run in runs for s in run["spans"] if s["name"] == "reinit"]
    return sum(span_s(s) for s in spans) / record["n_sets"] if spans else None
