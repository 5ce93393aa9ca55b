from tpuasr_torch.eval.cer_eval import (
    MODES, EvalResult, evaluate_offline, make_offline_decoder,
)
from tpuasr_torch.eval.multihost import allreduce_cer_counts
from tpuasr_torch.eval.rtf import (
    RtfStats, first_emissions, first_token_delay_stats, measure_first_token_delay, measure_rtf,
)
from tpuasr_torch.eval.streaming_eval import StreamingEvalResult, evaluate_streaming

__all__ = ["MODES", "EvalResult", "allreduce_cer_counts", "evaluate_offline", "make_offline_decoder",
           "RtfStats", "first_emissions", "first_token_delay_stats",
           "measure_first_token_delay", "measure_rtf", "StreamingEvalResult",
           "evaluate_streaming"]
