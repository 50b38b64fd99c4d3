"""Utilities: synthetic scenes and evaluation metrics."""
