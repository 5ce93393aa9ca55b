from tpuasr_torch.models.asr_model import AEDConfig, ASRModel, attention_rescoring
from tpuasr_torch.models.ctc_model import CTCModel
from tpuasr_torch.models.paraformer import Paraformer, ParaformerConfig
from tpuasr_torch.models.transducer import (
    CTCHead, Transducer, add_blank, init_weights, stream_output_len,
)
from tpuasr_torch.models.whisper import (
    PROMPT_LEN, TASK_TRANSCRIBE, TASK_TRANSLATE, TASK_VAD, WhisperConfig, WhisperModel,
    WhisperSpecialTokens, whisper_beam_decode, whisper_greedy_decode,
)

__all__ = ["AEDConfig", "ASRModel", "CTCHead", "CTCModel", "Paraformer", "ParaformerConfig",
           "Transducer", "add_blank", "attention_rescoring", "init_weights",
           "stream_output_len", "PROMPT_LEN", "TASK_TRANSCRIBE", "TASK_TRANSLATE", "TASK_VAD",
           "WhisperConfig", "WhisperModel", "WhisperSpecialTokens", "whisper_beam_decode",
           "whisper_greedy_decode"]
