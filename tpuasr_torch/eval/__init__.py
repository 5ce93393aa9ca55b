from tpuasr_torch.eval.cer_eval import make_offline_decoder
from tpuasr_torch.eval.rtf import RtfStats, measure_rtf

__all__ = ["make_offline_decoder", "RtfStats", "measure_rtf"]
