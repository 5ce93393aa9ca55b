"""CTC conformer model, the CTC workload (port of ``tpuasr/models/ctc_model.py``).

Conv2d subsampling (``conv2d8`` by default), the non-causal rel-pos macaron
conformer, a linear head and the CTC loss summed over the batch / B
(model/model.py:262-305). The model is fp32 whatever `model.compute_dtype`
or `train.dtype` say, as the JAX model never reads them; the encoder takes
the JAX defaults of `_encoder_cfg`, so `fused_attention` and `fused_ffn`
are off. On the card the loss runs the CTC lattice kernels #6/#7
(`ctc_loss_from_logits`).
"""

from __future__ import annotations

import torch
from torch import nn

from tpuasr_torch.config import CTCModelConfig, EncoderConfig
from tpuasr_torch.device import resolve_device
from tpuasr_torch.losses import ctc_loss_from_logits
from tpuasr_torch.nn.conformer import ConformerEncoder
from tpuasr_torch.nn.layers import Dense
from tpuasr_torch.nn.subsampling import subsampled_len


def encoder_config(c: CTCModelConfig) -> EncoderConfig:
    """The encoder `CTCModel` builds (tpuasr/models/ctc_model.py:23-37)."""
    return EncoderConfig(
        input_size=c.input_size, output_size=c.hidden_dim, attention_heads=c.attention_heads,
        linear_units=c.hidden_dim * c.ffn_factor, num_blocks=c.num_blocks,
        dropout_rate=c.dropout_rate, input_layer=c.subsampling, pos_enc_layer_type="rel_pos",
        macaron_style=True, use_cnn_module=True, cnn_module_kernel=c.kernel_size, causal=False)


class CTCModel(nn.Module):
    def __init__(self, cfg: CTCModelConfig, vocab_size: int, blank_id: int, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.blank_id = cfg, blank_id
        self.enc_cfg = encoder_config(cfg)
        self.encoder = ConformerEncoder(self.enc_cfg, torch.float32, dev)
        self.fc_out = Dense(cfg.hidden_dim, vocab_size, device=dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.fc_out.weight.device

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor,
               gen: torch.Generator | None = None):
        """[B, T, F] -> (logits [B, T', V], out_lens [B]); gen: the dropout
        generator, None for none."""
        ys, _ = self.encoder(feats, feat_lens, gen=gen)
        return self.fc_out(ys), subsampled_len(self.cfg.subsampling, feat_lens)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                texts: torch.Tensor | None = None, text_lens: torch.Tensor | None = None,
                dropout_gen: torch.Generator | None = None):
        """-> (log_probs fp32 [B, T', V], out_lens [B], loss | None). The loss
        is CTC summed over the batch / B (`zero_infinity`: an utterance with
        too few frames for its labels adds 0). dropout_gen: a generator on
        the model's device, used only in train() mode."""
        gen = dropout_gen if self.training else None
        if gen is None and self.training and self._has_dropout():
            raise ValueError("a model in train() mode needs a dropout generator "
                             "(or eval() for no dropout)")
        logits, out_lens = self.encode(feats, feat_lens, gen)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        loss = None
        if texts is not None:
            loss = ctc_loss_from_logits(logits, out_lens, texts, text_lens, self.blank_id,
                                        "sum_over_batch")
        return log_probs, out_lens, loss

    def _has_dropout(self) -> bool:
        e = self.enc_cfg
        return any(r > 0 for r in (e.dropout_rate, e.positional_dropout_rate,
                                   e.attention_dropout_rate))
