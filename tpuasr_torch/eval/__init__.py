from tpuasr_torch.eval.cer_eval import LATER_MODES, MODES, make_offline_decoder
from tpuasr_torch.eval.rtf import (
    RtfStats, first_emissions, first_token_delay_stats, measure_first_token_delay, measure_rtf,
)

__all__ = ["LATER_MODES", "MODES", "make_offline_decoder", "RtfStats", "first_emissions",
           "first_token_delay_stats", "measure_first_token_delay", "measure_rtf"]
