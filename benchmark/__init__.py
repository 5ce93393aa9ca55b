"""The port's benchmark (`benchmark/run.py`); it measures `tpuasr_torch` only."""
