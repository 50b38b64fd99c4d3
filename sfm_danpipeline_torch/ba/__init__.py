"""Levenberg-Marquardt bundle adjustment with Schur elimination of points."""
