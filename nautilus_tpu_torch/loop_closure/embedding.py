"""Learned loop-closure embedding and its trainer (port of
nautilus_tpu/loop_closure/embedding.py).

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

Training: NT-Xent contrastive loss plus a rotation-invariance term, with
Adam; positives are scans of one synthetic world within 1 m of each other
along the trajectory, negatives the rest of the batch.

    python -m nautilus_tpu_torch.loop_closure.embedding --out <path> \
        [--steps 300] [--seed 0] [--device cpu]

trains on the card (``--device cpu`` for the CPU) and writes the weights;
without ``--out`` it overwrites the package's shipped weights file.
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
    """[..., FEAT_DIM] rotation-invariant features of scans: points
    [..., P, 2], mask [..., P]."""
    hist = scan_descriptor(points, mask)                   # [..., R, T]
    return torch.abs(torch.fft.rfft(hist, dim=-1)).flatten(-2)


def init_params(seed: int = 0, device="cpu") -> dict:
    """He-initialized MLP parameters, drawn from the JAX package's numpy
    generator in its order, so the values are the same."""
    rng = np.random.default_rng(seed)

    def he(shape):
        return torch.as_tensor(
            rng.normal(0, np.sqrt(2.0 / shape[0]), shape).astype(np.float32),
            device=device)

    return {
        "w1": he((FEAT_DIM, HIDDEN_DIM)),
        "b1": torch.zeros((HIDDEN_DIM,), dtype=torch.float32, device=device),
        "w2": he((HIDDEN_DIM, EMBED_DIM)),
        "b2": torch.zeros((EMBED_DIM,), dtype=torch.float32, device=device),
    }


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


# ---------------------------------------------------------------------------
# Contrastive training on synthetic worlds
# ---------------------------------------------------------------------------

def _training_pairs(num_worlds: int = 18, nodes_per_world: int = 40,
                    seed: int = 0, device="cpu"):
    """(anchor, positive, rotated anchor) features [K, FEAT_DIM] on
    ``device`` from synthetic worlds.

    Positives: two scans of the same world <= 1 m apart on the trajectory.
    Worlds cycle through three kinds, 180/360/720 beams and two odometry
    noise levels, so the embedding sees sparse and dense scanners.  Each
    anchor also has a copy rotated by a random angle: the training loss
    pins the embedding of a scan to that of its rotated copy, which
    reverse-traversal closures rely on."""
    from nautilus_tpu_torch.ingest.synthetic import synthesize

    def features(points, mask):
        return spectral_features(torch.as_tensor(points, device=device),
                                 torch.as_tensor(mask, device=device))

    anchors, positives, anchors_rot = [], [], []
    for w in range(num_worlds):
        kind = ("office", "building", "room")[w % 3]
        beams = (180, 360, 720)[(w // 3) % 3]
        noise = (1.0, 2.0)[(w // 9) % 2]
        raw, gt = synthesize(num_nodes=nodes_per_world, world_kind=kind,
                             num_beams=beams, seed=seed + 17 * w,
                             odom_noise_trans=0.03 * noise,
                             odom_noise_rot=0.01 * noise)
        feats = features(raw.points, raw.points_mask)
        local_rng = np.random.default_rng(seed + 31 * w)
        ths = local_rng.uniform(0.3, 2 * np.pi - 0.3, size=len(gt))
        c, s = np.cos(ths), np.sin(ths)
        rotm = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
        rot_pts = np.einsum("npk,nkj->npj", np.asarray(raw.points),
                            rotm.astype(raw.points.dtype))
        feats_rot = features(rot_pts, raw.points_mask)
        d = np.linalg.norm(gt[:, None, :2] - gt[None, :, :2], axis=-1)
        n = len(gt)
        ia, ip = [], []
        for i in range(n):
            near = np.nonzero((d[i] <= 1.0) & (np.arange(n) != i))[0]
            if len(near):
                ia.append(i)
                ip.append(near[len(near) // 2])
        anchors.append(feats[ia])
        positives.append(feats[ip])
        anchors_rot.append(feats_rot[ia])
    return torch.cat(anchors), torch.cat(positives), torch.cat(anchors_rot)


def _ntxent_loss(params, fa, fp, temperature: float = 0.1):
    """NT-Xent over a batch of (anchor, positive) feature rows: each anchor
    against every positive, and each positive against every anchor."""
    za = embed_features(params, fa)                        # [B, D]
    zp = embed_features(params, fp)
    sims = torch.matmul(za, zp.T) / temperature
    rows = torch.diagonal(torch.log_softmax(sims, dim=1))
    cols = torch.diagonal(torch.log_softmax(sims, dim=0))
    return torch.mean(-rows - cols) * 0.5


def _train_loss(params, fa, fp, fr, inv_weight: float = 2.0):
    """NT-Xent plus the rotation-invariance term: the contrastive term alone
    pushes rotated near-duplicates apart as in-batch negatives, so the
    second term pins embed(scan) to embed(rotated scan)."""
    za = embed_features(params, fa)
    zr = embed_features(params, fr)
    inv = torch.mean(1.0 - torch.sum(za * zr, dim=-1))
    return _ntxent_loss(params, fa, fp) + inv_weight * inv


def train(num_steps: int = 300, batch: int = 128, lr: float = 1e-3,
          seed: int = 0, verbose: bool = True, device=None, losses=None):
    """Train and return the params (with calib) on ``device`` (None means
    the CUDA card and raises without one; pass "cpu" for the CPU).

    Batches are drawn from ``np.random.default_rng(seed)`` as the JAX
    trainer draws them, and Adam makes optax.adam's update.  When
    ``losses`` is a list, each step's loss is appended to it."""
    from nautilus_tpu_torch.core.problem import default_device
    device = default_device(device)
    fa, fp, fr = _training_pairs(seed=seed, device=device)
    if verbose:
        print(f"training pairs: {len(fa)}")
    params = {k: v.requires_grad_() for k, v in init_params(seed,
                                                            device).items()}
    opt = torch.optim.Adam(params.values(), lr=lr)
    rng = np.random.default_rng(seed)
    trace = []
    for it in range(num_steps):
        idx = torch.as_tensor(
            rng.choice(len(fa), size=min(batch, len(fa)), replace=False),
            device=device)
        opt.zero_grad()
        loss = _train_loss(params, fa[idx], fp[idx], fr[idx])
        loss.backward()
        opt.step()
        trace.append(loss.detach())
        if verbose and (it % 50 == 0 or it == num_steps - 1):
            print(f"step {it:4d}  loss {float(trace[-1]):.4f}")
    if losses is not None and trace:
        losses.extend(torch.stack(trace).tolist())

    # Calibration: the raw cosine score of mismatched (anchor_i,
    # positive_j) pairs at their 90th percentile maps to 0.5 (the default
    # lc_match_threshold): recall-oriented, since a false accept costs one
    # scan match and a false reject loses the closure.
    params = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        za = embed_features(params, fa).cpu().numpy()
        zp = embed_features(params, fp).cpu().numpy()
    near = 0.5 * ((za * zp).sum(-1) + 1.0)
    perm = rng.permutation(len(fa))
    far = 0.5 * ((za * zp[perm]).sum(-1) + 1.0)
    far = far[perm != np.arange(len(fa))]
    calib = float(np.percentile(far, 90))
    if verbose:
        print(f"calibration: near q5 {np.percentile(near, 5):.3f}, far "
              f"q90 {np.percentile(far, 90):.3f} -> calib {calib:.3f}")
    params["calib"] = torch.tensor(calib, dtype=torch.float32, device=device)
    return params


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Train the loop-closure embedding and write its weights.")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="weights file to write (default: the package's "
                         "shipped weights, which this overwrites)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card, so the CPU runs only with --device cpu)")
    args = ap.parse_args(argv)
    params = train(num_steps=args.steps, seed=args.seed, device=args.device)
    path = save_params(params, args.out or None)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
