from tpuasr_torch.models.ctc_model import CTCModel
from tpuasr_torch.models.transducer import (
    CTCHead, Transducer, add_blank, init_weights, stream_output_len,
)

__all__ = ["CTCHead", "CTCModel", "Transducer", "add_blank", "init_weights",
           "stream_output_len"]
