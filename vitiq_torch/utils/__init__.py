"""Utilities: per-step timing and traces (`utils/profiling.py`)."""
