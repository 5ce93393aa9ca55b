"""BZNSYP corpus tooling: ProsodyLabeling parser, pinyin normalization,
train/dev/test split, and wav.scp / pinyin file readers (the port's own copy
of ``tpuasr/data/bznsyp.py``).

The corpus' conventions (as its split tool applies them):

- the ProsodyLabeling transcript alternates hanzi and pinyin lines; utterance
  ids <= 8000 are train, 8001-9000 dev, > 9000 test (split rule :84-91);
- pinyin normalization (:33-53): tones stripped; erhua suffix ``r`` splits into
  the base syllable plus ``er``; the corpus artifacts ``IY`` are dropped and
  ``P`` maps to ``pi``.
"""

from __future__ import annotations

import os
import wave
from typing import Iterator

import numpy as np


def normalize_pinyin(pinyin_line: str) -> list[str]:
    """Normalize one space-separated toned pinyin line to toneless syllables."""
    out: list[str] = []
    for p in pinyin_line.split():
        if not p:
            continue
        if p[-1].isdigit():
            p = p[:-1]
        if not p:
            continue
        if p.endswith("r") and p != "er":
            base = p[:-1]
            if base:
                out.append(base)
            out.append("er")
        elif p == "IY":
            continue
        elif p == "P":
            out.append("pi")
        else:
            out.append(p)
    return out


def parse_prosody_labeling(path: str) -> dict[str, dict]:
    """Parse the alternating id<TAB>hanzi / pinyin line format."""
    res: dict[str, dict] = {}
    cur_id = None
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(l.strip() for l in f):
            if i % 2 == 0:
                utt_id, _, text = line.partition("\t")
                if not text:
                    raise ValueError(f"bad transcript line: {line!r}")
                cur_id = utt_id
                res[cur_id] = {"text": text}
            else:
                res[cur_id]["pinyin"] = normalize_pinyin(line)
    return res


def split_dataset(
    transcript: str,
    out_dir: str,
    wav_pattern: str = "Wave/{utt}.wav",
    train_max: int = 8000,
    dev_max: int = 9000,
) -> dict[str, int]:
    """Write {out_dir}/{train,dev,test}/{wav.scp,pinyin}."""
    data = parse_prosody_labeling(transcript)
    splits = {"train": {}, "dev": {}, "test": {}}
    for utt, entry in data.items():
        num = int(utt)
        name = "train" if num <= train_max else ("dev" if num <= dev_max else "test")
        splits[name][utt] = entry
    for name, entries in splits.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "wav.scp"), "w", encoding="utf-8") as f:
            for utt in entries:
                f.write(f"{utt}\t{wav_pattern.format(utt=utt)}\n")
        with open(os.path.join(d, "pinyin"), "w", encoding="utf-8") as f:
            for utt, entry in entries.items():
                f.write(f"{utt}\t{' '.join(entry['pinyin'])}\n")
    return {k: len(v) for k, v in splits.items()}


def read_scp(path: str, root: str = "") -> dict[str, str]:
    """Read id<TAB>relative-path lines into {id: abspath}."""
    out: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            utt, _, rel = line.strip().partition("\t")
            if not rel:
                raise ValueError(f"bad wav.scp line: {line!r}")
            out[utt] = os.path.join(root, rel)
    return out


def read_text(path: str) -> dict[str, list[str]]:
    """Read id<TAB>space-separated-tokens lines."""
    out: dict[str, list[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            utt, _, toks = line.strip().partition("\t")
            if not toks:
                raise ValueError(f"bad text line: {line!r}")
            out[utt] = toks.split(" ")
    return out


def read_wav(path: str, dtype: str = "float32") -> tuple[np.ndarray, int]:
    """Decode a PCM WAV file to float32 in [-1, 1] (mono: first channel).

    ``dtype="int16"`` returns 16-bit PCM files as the raw stored samples with
    no conversion: the int16 wire format (cfg.data.wire_dtype) that fbank
    decodes on the device (/32768), exact against the float path for 16-bit
    sources; other widths convert float -> int16 by rint and a clip."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2")
        if ch > 1:
            x = x.reshape(-1, ch)[:, 0]
        if dtype == "int16":
            return np.ascontiguousarray(x), sr
        return x.astype(np.float32) / 32768.0, sr
    if width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch)[:, 0]
    if dtype == "int16":
        x = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)
    return x, sr


def iter_utterances(
    wav_scp: str, text_file: str, root: str = ""
) -> Iterator[tuple[str, str, list[str]]]:
    wavs = read_scp(wav_scp, root)
    texts = read_text(text_file)
    for utt, path in wavs.items():
        if utt in texts:
            yield utt, path, texts[utt]
