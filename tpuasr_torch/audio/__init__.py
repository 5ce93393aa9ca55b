from tpuasr_torch.audio.fbank import (
    dft_matrices, fbank, fbank_batch, frame_signal, hamming_window, mel_filterbank,
)

__all__ = ["dft_matrices", "fbank", "fbank_batch", "frame_signal", "hamming_window",
           "mel_filterbank"]
