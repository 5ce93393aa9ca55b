from tpuasr_torch.decode.alignment import (
    ctc_forced_align, gen_ctc_peak_time, gen_timestamps_from_peak, replace_duplicates_with_blank,
    token_timestamps,
)
from tpuasr_torch.decode.attention_beam import attention_beam_search
from tpuasr_torch.decode.context_graph import ContextGraph, build_context_graph
from tpuasr_torch.decode.ctc_greedy import ctc_greedy_decode, remove_duplicates_and_blank
from tpuasr_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from tpuasr_torch.decode.rnnt_beam import (
    BeamCarry, beam_frames, init_beam_carry, rnnt_beam_decode, top_k,
)
from tpuasr_torch.decode.rnnt_greedy import GreedyCarry, greedy_frames, rnnt_greedy_decode
from tpuasr_torch.decode.rnnt_rescoring import transducer_rescoring
from tpuasr_torch.decode.rnnt_streaming import (
    StreamingBeamState, StreamingState, init_streaming_beam_state, init_streaming_state,
    process_chunk, process_chunk_beam, streaming_beam_decode, streaming_greedy_decode,
)

__all__ = ["ctc_forced_align", "gen_ctc_peak_time", "gen_timestamps_from_peak",
           "replace_duplicates_with_blank", "token_timestamps", "attention_beam_search",
           "ContextGraph", "build_context_graph", "ctc_greedy_decode",
           "remove_duplicates_and_blank", "ctc_prefix_beam_search", "BeamCarry", "beam_frames",
           "init_beam_carry", "rnnt_beam_decode", "top_k", "GreedyCarry", "greedy_frames",
           "rnnt_greedy_decode", "transducer_rescoring", "StreamingBeamState", "StreamingState",
           "init_streaming_beam_state", "init_streaming_state", "process_chunk",
           "process_chunk_beam", "streaming_beam_decode", "streaming_greedy_decode"]
