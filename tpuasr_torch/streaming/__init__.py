from tpuasr_torch.streaming.chunkwise import chunk_windows, decoding_window, num_chunks
from tpuasr_torch.streaming.family_cache import (
    FamilyStreamState, init_family_state, rate_view, roll_cache,
)
from tpuasr_torch.streaming.prefix_recompute import chunked_prefix_encode

__all__ = ["FamilyStreamState", "chunk_windows", "chunked_prefix_encode", "decoding_window",
           "init_family_state", "num_chunks", "rate_view", "roll_cache"]
