"""Learned loop-closure embedding, inference only (port of
nautilus_tpu/loop_closure/embedding.py; the contrastive trainer stays with
the JAX package, whose weights file this module reads).

- polar occupancy histogram [RANGE_BINS, THETA_BINS] (learned.scan_descriptor);
- |rFFT| over the angle axis: a rotation of the scan is a circular shift of
  that axis, so the magnitude spectrum is rotation invariant by
  construction;
- a 2-layer MLP (528 -> 128 -> 64, tanh GELU) -> L2-normalized embedding;
  the pair score is the cosine, remapped so that the calibration scalar
  stored with the weights lands on 0.5.

The weights are the package's own copy of the JAX package's
``lc_embedding.npz`` (same bytes, same npz layout: w1, b1, w2, b2 and an
optional calib), so either package reads either file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from nautilus_tpu_torch.loop_closure.learned import (RANGE_BINS, THETA_BINS,
                                                     scan_descriptor)

EMBED_DIM = 64
HIDDEN_DIM = 128
FEAT_DIM = RANGE_BINS * (THETA_BINS // 2 + 1)

_WEIGHTS_PATH = Path(__file__).resolve().parent / "weights" / "lc_embedding.npz"
_KEYS = {"w1", "b1", "w2", "b2"}


def default_weights_path() -> Path:
    return _WEIGHTS_PATH


def spectral_features(points, mask) -> torch.Tensor:
    """[FEAT_DIM] rotation-invariant features of one scan."""
    hist = scan_descriptor(points, mask)                   # [R, T]
    return torch.abs(torch.fft.rfft(hist, dim=1)).reshape(-1)


def embed_features(params: dict, feats) -> torch.Tensor:
    """feats [..., FEAT_DIM] -> L2-normalized embeddings [..., EMBED_DIM]."""
    h = torch.matmul(feats, params["w1"]) + params["b1"]
    h = torch.nn.functional.gelu(h, approximate="tanh")
    z = torch.matmul(h, params["w2"]) + params["b2"]
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                           min=1e-9)


def embed(params: dict, points, mask) -> torch.Tensor:
    return embed_features(params, spectral_features(points, mask))


def embedding_match_score(params: dict, points_a, mask_a, points_b,
                          mask_b) -> torch.Tensor:
    """Pair score in [0, 1] (0-dim tensor), the same surface as
    learned.match_score.

    The raw cosine similarity is remapped piecewise-affinely through three
    anchors, 0 -> 0, calib -> 0.5, 1 -> 1, where calib is the near/far
    score midpoint measured after training: lc_match_threshold = 0.5 then
    sits at the decision boundary wherever training parked the cosines,
    and a scan scores exactly 1 against itself."""
    za = embed(params, points_a, mask_a)
    zb = embed(params, points_b, mask_b)
    raw = 0.5 * (torch.dot(za, zb) + 1.0)
    calib = params.get("calib")
    if calib is None:
        calib = torch.tensor(0.5, dtype=raw.dtype, device=raw.device)
    lo = 0.5 * raw / torch.clamp(calib, min=1e-6)
    hi = 0.5 + 0.5 * (raw - calib) / torch.clamp(1.0 - calib, min=1e-6)
    return torch.clamp(torch.where(raw < calib, lo, hi), 0.0, 1.0)


def save_params(params: dict, path=None) -> Path:
    path = Path(path) if path else _WEIGHTS_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})
    return path


def load_params(path=None, device="cpu", dtype=torch.float32):
    """The weights as tensors on ``device``; None when the file is absent
    (the hand descriptor then scores)."""
    path = Path(path) if path else _WEIGHTS_PATH
    if not path.exists():
        return None
    data = np.load(path)
    if not _KEYS.issubset(data.files) \
            or not set(data.files).issubset(_KEYS | {"calib"}):
        raise ValueError(f"{path} is not an lc_embedding weights file")
    return {k: torch.as_tensor(data[k], dtype=dtype, device=device)
            for k in data.files}
