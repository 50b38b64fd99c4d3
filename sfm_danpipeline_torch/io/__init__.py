"""Host-side I/O: image loading and calibration parsing (numpy copies)."""
