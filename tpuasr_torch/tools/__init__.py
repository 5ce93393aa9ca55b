"""Command-line entry points of the port (`python -m tpuasr_torch.tools.<name>`)."""
