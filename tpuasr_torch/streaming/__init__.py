from tpuasr_torch.streaming.chunkwise import chunk_windows, decoding_window, num_chunks

__all__ = ["chunk_windows", "decoding_window", "num_chunks"]
