"""Utilities: per-step timing and traces (`utils/profiling.py`), the device
an entry point runs on (`utils/device.py`)."""
