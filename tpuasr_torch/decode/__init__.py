from tpuasr_torch.decode.rnnt_greedy import GreedyCarry, greedy_frames, rnnt_greedy_decode
from tpuasr_torch.decode.rnnt_streaming import (
    StreamingState, init_streaming_state, process_chunk, streaming_greedy_decode,
)

__all__ = ["GreedyCarry", "greedy_frames", "rnnt_greedy_decode", "StreamingState",
           "init_streaming_state", "process_chunk", "streaming_greedy_decode"]
