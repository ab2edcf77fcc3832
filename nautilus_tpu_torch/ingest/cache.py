"""Ingest result caching: bag -> RawNodes arrays, cached as npz (port of
nautilus_tpu/ingest/cache.py).

Bag replay is deterministic given the bag file and the ingest-relevant
config keys, so the padded arrays are cached keyed by a digest of (bag
path, size, mtime, ingest keys), in ``~/.cache/nautilus_tpu_torch/ingest``.
A repeat curation session then starts without replaying the bag.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from nautilus_tpu_torch.core.problem import RawNodes

_INGEST_KEYS = (
    "lidar_topic", "odom_topic", "differential_odom", "max_lidar_range",
    "rotation_change_for_lidar", "translation_change_for_lidar",
    "pose_number",
)


def _digest(bag_path: Path, config) -> str:
    st = bag_path.stat()
    payload = {
        "bag": str(bag_path), "size": st.st_size, "mtime": st.st_mtime,
        **{k: config.get(k) for k in _INGEST_KEYS},
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:24]


def cache_dir() -> Path:
    d = Path.home() / ".cache" / "nautilus_tpu_torch" / "ingest"
    d.mkdir(parents=True, exist_ok=True)
    return d


def cache_path(bag_path, config) -> Path:
    """The npz file that holds (or will hold) this bag's ingest."""
    return cache_dir() / f"{_digest(Path(bag_path), config)}.npz"


def load_or_ingest(bag_path, config, verbose: bool = True,
                   pad_multiple: int = 128) -> RawNodes:
    """process_bag_file with a transparent npz cache."""
    from nautilus_tpu_torch.ingest.builder import process_bag_file
    path = cache_path(bag_path, config)
    if path.exists():
        if verbose:
            print(f"(ingest cache hit: {path.name})")
        z = np.load(path)
        return RawNodes(**{k: z[k] for k in RawNodes._fields})
    raw = process_bag_file(Path(bag_path), config, verbose=verbose,
                           pad_multiple=pad_multiple)
    np.savez_compressed(path, **raw._asdict())
    return raw
