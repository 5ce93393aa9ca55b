from tpuasr_torch.models.transducer import (
    CTCHead, Transducer, add_blank, init_weights, stream_output_len,
)

__all__ = ["CTCHead", "Transducer", "add_blank", "init_weights", "stream_output_len"]
