from tpuasr_torch.models.transducer import (
    CTCHead, Transducer, init_weights, stream_output_len,
)

__all__ = ["CTCHead", "Transducer", "init_weights", "stream_output_len"]
