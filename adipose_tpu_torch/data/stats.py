"""Dataset intensity statistics: a copy of ``adipose_tpu/data/stats.py``.

``compute_mean_std`` scans every train tile's pixels for the global mean and
std persisted to ``normalization_stats.json``, as a streaming two-moment
accumulator in path order.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

from adipose_tpu_torch.core.hostio import thread_map


def compute_mean_std(image_paths, max_samples: int | None = None) -> tuple:
    """Streaming global mean/std over grayscale images; (127.5, 50.0) fallback
    for an empty set (``src/utils/data.py:453-454``)."""
    paths = list(image_paths)
    if max_samples is not None:
        paths = paths[:max_samples]

    def moments(p):
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if img is None:
            return 0, 0.0, 0.0
        x = img.astype(np.float64)
        return x.size, float(x.sum()), float((x * x).sum())

    count = 0
    total = 0.0
    total_sq = 0.0
    # thread-parallel decode (cv2 releases the GIL); thread_map preserves
    # path order, so the accumulation — and the result — stay deterministic
    for n, s, sq in thread_map(moments, paths):
        count += n
        total += s
        total_sq += sq
    if count == 0:
        return 127.5, 50.0
    mean = total / count
    var = max(total_sq / count - mean * mean, 0.0)
    return float(mean), float(np.sqrt(var))


def compute_dataset_statistics(image_paths, max_samples: int = 100) -> tuple:
    """Sampled variant (``src/utils/data.py:432-457``)."""
    return compute_mean_std(image_paths, max_samples=max_samples)


def dataset_image_paths(images_dir: str | Path):
    return sorted(Path(images_dir).glob("*.jpg"))
