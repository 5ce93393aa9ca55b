"""Whisper-style AED: task and language special tokens over the attention
encoder-decoder (port of ``tpuasr/models/whisper.py``).

The prompt grammar of wenet/utils/common.py:159-230 (`add_whisper_tokens`):

    [sot] -> [lang id] -> [transcribe|translate] -> [no_timestamps]
                       -> [no_speech (vad)]      -> [no_speech]
    -> text tokens -> [eot]

Tasks and languages are integer tensors and the 4-token prompt is built by
selects, so each row of a batch carries its own task and language. The
model is the conformer encoder, the transformer decoder and, with
`ctc_weight > 0`, a linear CTC head; the encoder runs the port's kernels as
the AED model's does (#2/#3 with `encoder.fused_attention`, #10/#11 with
`encoder.fused_ffn`), the CTC loss the lattice kernels #6/#7 on the card.
Timestamp prompts and OpenAI's checkpoints are out of scope, as in the JAX
package: the architecture runs on seeded or converted weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from tpuasr_torch.config import EncoderConfig
from tpuasr_torch.decode.attention_beam import attention_beam_search
from tpuasr_torch.decode.rnnt_beam import first_argmax
from tpuasr_torch.device import resolve_device
from tpuasr_torch.losses import ctc_loss_from_logits
from tpuasr_torch.models.transducer import DTYPES
from tpuasr_torch.nn.conformer import ConformerEncoder
from tpuasr_torch.nn.decoder import TransformerDecoder, label_smoothing_loss
from tpuasr_torch.nn.layers import Dense
from tpuasr_torch.nn.subsampling import subsampled_len

TASK_TRANSCRIBE = 0
TASK_TRANSLATE = 1
TASK_VAD = 2

PROMPT_LEN = 4  # [sot, lang, task, no_timestamps|no_speech]


@dataclass
class WhisperSpecialTokens:
    """Special-token ids (whisper's sot/eot naming; the defaults fit the
    repo's 412-token vocabulary)."""

    sot: int = 2
    eot: int = 3
    transcribe: int = 6
    translate: int = 7
    no_timestamps: int = 8
    no_speech: int = 9
    lang_base: int = 10  # language id = lang_base + language index


@dataclass
class WhisperConfig:
    vocab_size: int = 412
    blank_id: int = 5
    num_languages: int = 2
    special: WhisperSpecialTokens = field(default_factory=WhisperSpecialTokens)
    lsm_weight: float = 0.1
    ctc_weight: float = 0.0  # whisper trains attention-only by default
    decoder_blocks: int = 6
    decoder_heads: int = 4
    decoder_ffn: int = 1024
    compute_dtype: str = "float32"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in {sorted(DTYPES)}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        e = cfg.encoder
        self.encoder = ConformerEncoder(e, self.dtype, dev)
        self.decoder = TransformerDecoder(
            cfg.vocab_size, e.output_size, cfg.decoder_heads, cfg.decoder_ffn,
            cfg.decoder_blocks, e.dropout_rate, e.max_len, self.dtype, dev)
        self.ctc_lo = Dense(e.output_size, cfg.vocab_size, device=dev) \
            if cfg.ctc_weight > 0 else None
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.output_layer.weight.device

    def prompt_tokens(self, langs: torch.Tensor, tasks: torch.Tensor) -> torch.Tensor:
        """[B] language indices and [B] task codes -> the [B, 4] prompt
        (`add_whisper_tokens`' grammar: VAD's task slot and tail are both
        no_speech)."""
        sp = self.cfg.special
        langs, tasks = langs.long(), tasks.long()
        sot = torch.full_like(langs, sp.sot)
        task = torch.where(tasks == TASK_TRANSCRIBE, sp.transcribe,
                           torch.where(tasks == TASK_TRANSLATE, sp.translate, sp.no_speech))
        tail = torch.where(tasks == TASK_VAD, sp.no_speech, sp.no_timestamps)
        return torch.stack([sot, sp.lang_base + langs, task, tail], dim=1)

    @torch.no_grad()
    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """-> (enc_out [B, T', D], enc_lens [B])."""
        ys, _ = self.encoder(feats, feat_lens)
        return ys, subsampled_len(self.cfg.encoder.input_layer, feat_lens)

    def ctc_logits(self, enc_out: torch.Tensor) -> torch.Tensor:
        """The CTC head in fp32, as the JAX package's dtype-less Dense."""
        if self.ctc_lo is None:
            raise ValueError("model has no CTC head (ctc_weight == 0)")
        return self.ctc_lo(enc_out.float())

    # the autoregressive surface of decode/attention_beam.py (as ASRModel's)
    @torch.no_grad()
    def decoder_project_memory(self, memory):
        return self.decoder.project_memory(memory)

    def decoder_init_cache(self, batch: int, lmax: int):
        return self.decoder.init_ar_cache(batch, lmax)

    @torch.no_grad()
    def decoder_one_step(self, tokens, pos: int, kcache, vcache, mem_k, mem_v, mem_mask):
        return self.decoder.forward_one_step(tokens, pos, kcache, vcache, mem_k, mem_v,
                                             mem_mask)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor, texts: torch.Tensor,
                text_lens: torch.Tensor, langs: torch.Tensor | None = None,
                tasks: torch.Tensor | None = None,
                dropout_gen: torch.Generator | None = None) -> dict:
        """Teacher-forced loss -> {"loss", "loss_att"} (and "loss_ctc" with
        `ctc_weight > 0`). The decoder's input is prompt + text, its target
        that shifted left with eot after the text, so every token after sot
        is supervised (whisper's convention). texts [B, U] bare ids,
        lengths [B]; langs and tasks [B] (default language 0, transcribe).
        dropout_gen: a generator on the model's device, used only in
        train() mode."""
        c = self.cfg
        b, u = texts.shape
        dev = feats.device
        gen = dropout_gen if self.training else None
        if langs is None:
            langs = torch.zeros(b, dtype=torch.long, device=dev)
        if tasks is None:
            tasks = torch.full((b,), TASK_TRANSCRIBE, dtype=torch.long, device=dev)
        texts, text_lens = texts.long(), text_lens.long()
        enc_out, _ = self.encoder(feats, feat_lens, gen=gen)
        enc_lens = subsampled_len(c.encoder.input_layer, feat_lens)

        ys_in = torch.cat([self.prompt_tokens(langs, tasks), texts], dim=1)
        ys_out = torch.nn.functional.pad(ys_in[:, 1:], (0, 1), value=0)
        eot_slot = (torch.arange(u + PROMPT_LEN, device=dev)[None, :]
                    == (PROMPT_LEN - 1 + text_lens)[:, None])
        ys_out = torch.where(eot_slot, c.special.eot, ys_out)
        dec_lens = text_lens + PROMPT_LEN

        logits = self.decoder(enc_out, enc_lens, ys_in, dec_lens, gen)
        loss_att = label_smoothing_loss(logits, ys_out, dec_lens, c.lsm_weight)
        out = {"loss_att": loss_att}
        loss = loss_att
        if c.ctc_weight > 0:
            loss_ctc = ctc_loss_from_logits(self.ctc_logits(enc_out), enc_lens, texts,
                                            text_lens, c.blank_id, "sum_over_batch")
            loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_att
            out["loss_ctc"] = loss_ctc
        out["loss"] = loss
        return out


@torch.no_grad()
def whisper_greedy_decode(model: WhisperModel, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                          langs: torch.Tensor, tasks: torch.Tensor, max_tokens: int = 100
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prompt-conditioned greedy decode -> (tokens [B, max_tokens], lens
    [B]). The 4 prompt tokens are fed through the AR cache (the last prompt
    step's log-probs give the first text token); then each step takes the
    first argmax until eot, after which a row feeds eot and emits 0. The
    JAX package scans all `max_tokens` steps; the loop here stops, one
    device sync a step, once every row has met eot, since the steps after
    that emit nothing."""
    sp = model.cfg.special
    b, t, _ = enc_out.shape
    dev = enc_out.device
    lmax = max_tokens + PROMPT_LEN + 1
    prompt = model.prompt_tokens(langs.to(dev), tasks.to(dev))
    mem_k, mem_v = model.decoder_project_memory(enc_out)
    kc, vc = model.decoder_init_cache(b, lmax)
    mem_mask = (torch.arange(t, device=dev)[None, :] < enc_lens.to(dev)[:, None])[:, None, :]
    for i in range(PROMPT_LEN):
        lp, kc, vc = model.decoder_one_step(prompt[:, i], i, kc, vc, mem_k, mem_v, mem_mask)

    tokens = torch.zeros((b, max_tokens), dtype=torch.long, device=dev)
    lens = torch.zeros(b, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_tokens):
        nxt = first_argmax(lp, 1)
        is_eot = nxt == sp.eot
        emit = ~done & ~is_eot
        tokens[:, i] = torch.where(emit, nxt, 0)
        lens += emit.long()
        done = done | is_eot
        if i == max_tokens - 1 or bool(done.all()):
            break
        feed = torch.where(done, sp.eot, nxt)
        lp, kc, vc = model.decoder_one_step(feed, PROMPT_LEN + i, kc, vc, mem_k, mem_v,
                                            mem_mask)
    return tokens, lens


@torch.no_grad()
def whisper_beam_decode(model: WhisperModel, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                        langs: torch.Tensor, tasks: torch.Tensor, beam_size: int = 10,
                        max_tokens: int = 100, length_penalty: float = 0.0, nbest: bool = False):
    """Prompt-conditioned attention beam search (wenet search.py:265-279
    decodes whisper through the attention beam with the 4-token prompt) ->
    (tokens [B, max_tokens], lens [B], n-best scores [B, N]), and the
    n-best lists with `nbest` (`attention_beam_search`)."""
    sp = model.cfg.special
    prompt = model.prompt_tokens(langs.to(enc_out.device), tasks.to(enc_out.device))
    return attention_beam_search(model, enc_out, enc_lens, sp.sot, sp.eot,
                                 beam_size=beam_size, max_len=max_tokens, prompt=prompt,
                                 length_penalty=length_penalty, nbest=nbest)
