"""Global CMVN: (x - mean) * istd over features (port of
``tpuasr/audio/cmvn.py``).

Parity: wenet/transformer/cmvn.py:18-40 (GlobalCMVN) and wenet/utils/cmvn.py
(the stats loaders). `compute_cmvn_stats` accumulates corpus-wide sums in
float64 on the host (the wenet tools/compute_cmvn_stats role,
`python -m tpuasr_torch.tools.compute_cmvn`); `apply_cmvn` is a tensor
function for the features' device.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def apply_cmvn(feats: torch.Tensor, mean, istd, norm_var: bool = True) -> torch.Tensor:
    """feats [..., F] -> (feats - mean) [* istd], in the features' type."""
    mean = torch.as_tensor(mean, dtype=feats.dtype, device=feats.device)
    out = feats - mean
    if norm_var:
        out = out * torch.as_tensor(istd, dtype=feats.dtype, device=feats.device)
    return out


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def compute_cmvn_stats(feature_batches, feat_lens_batches=None):
    """Corpus (mean, istd), fp32 [F] each, over [B, T, F] (or [T, F])
    feature batches; with lengths, only each utterance's first len frames
    count."""
    total = total_sq = None
    count = 0
    for i, feats in enumerate(feature_batches):
        feats = _host(feats).astype(np.float64)
        if feats.ndim == 2:
            feats = feats[None]
        if feat_lens_batches is not None:
            lens = _host(feat_lens_batches[i])
            mask = np.arange(feats.shape[1])[None, :] < lens[:, None]
            w = mask[..., None].astype(np.float64)
            s = (feats * w).sum((0, 1))
            sq = (feats * feats * w).sum((0, 1))
            count += int(mask.sum())
        else:
            s = feats.sum((0, 1))
            sq = (feats * feats).sum((0, 1))
            count += feats.shape[0] * feats.shape[1]
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
    mean = total / count
    var = np.maximum(total_sq / count - mean * mean, 1e-20)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)


def save_cmvn(path: str, mean, istd) -> None:
    with open(path, "w") as f:
        json.dump({"mean": _host(mean).tolist(), "istd": _host(istd).tolist()}, f)


def load_cmvn(path: str):
    with open(path) as f:
        d = json.load(f)
    return np.asarray(d["mean"], np.float32), np.asarray(d["istd"], np.float32)


def _stats_to_mean_istd(mean_stat, var_stat, frame_num):
    mean = np.asarray(mean_stat, np.float64) / frame_num
    var = np.maximum(np.asarray(var_stat, np.float64) / frame_num - mean * mean, 1e-20)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)


def load_cmvn_json_stats(path: str):
    """wenet json-format accumulated stats -> (mean, istd)
    (wenet/utils/cmvn.py:21-43: keys mean_stat / var_stat / frame_num)."""
    with open(path) as f:
        stats = json.load(f)
    return _stats_to_mean_istd(stats["mean_stat"], stats["var_stat"], float(stats["frame_num"]))


def load_cmvn_kaldi(path: str):
    """kaldi text-format global cmvn (`compute-cmvn-stats --binary=false`)
    -> (mean, istd) (wenet/utils/cmvn.py:46-85).

    Layout: `[ m_1 .. m_F count  v_1 .. v_F 0 ]`: accumulated sums, the
    frame count after the means, a trailing zero after the variances."""
    with open(path, "rb") as f:
        if f.read(2) == b"\0B":
            raise ValueError("kaldi binary cmvn is not supported; recompute with "
                             "compute-cmvn-stats --binary=false")
    with open(path) as f:
        arr = f.read().split()
    if arr[0] != "[" or arr[-1] != "]" or arr[-2] != "0":
        raise ValueError(f"not a kaldi text cmvn file: {path}")
    feat_dim = (len(arr) - 4) // 2
    mean_stat = [float(x) for x in arr[1:1 + feat_dim]]
    frame_num = float(arr[1 + feat_dim])
    var_stat = [float(x) for x in arr[2 + feat_dim:2 + 2 * feat_dim]]
    return _stats_to_mean_istd(mean_stat, var_stat, frame_num)
