"""Bootstrap confidence intervals over slides (``adipose_tpu/eval/bootstrap.py``).

Behavioral spec: ``bootstrap_confidence_interval`` / ``safe_bootstrap_ci``
(``full_evaluation_enhanced.py:983-1018``): 10 000 resamples with
replacement, percentile CI at alpha = 0.05, seed 42; a NaN-safe wrapper.

The resample indices are drawn on a CPU generator, so a run on a card and a
run on the CPU give the same intervals; the resamples are reduced on the
device in one batched op. The JAX package draws them from ``jax.random``,
whose stream is not reproduced here.
"""

from __future__ import annotations

import numpy as np
import torch


def _draw_indices(n: int, n_bootstrap: int, seed: int = 42) -> torch.Tensor:
    """(n_bootstrap, n) int64 resample indices in [0, n), on the CPU."""
    return torch.randint(0, n, (n_bootstrap, n), generator=torch.Generator().manual_seed(seed))


def _median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.median``, its 'midpoint' quantile: ``(lo + hi) * 0.5`` of the
    two middle values (one value when the count is odd); ``torch.median``
    returns the lower one."""
    s = x.sort(dim).values
    k = x.shape[dim]
    return (s.select(dim, (k - 1) // 2) + s.select(dim, k // 2)) * 0.5


def _bootstrap_stats(data: torch.Tensor, idx: torch.Tensor, statistic: str) -> torch.Tensor:
    """The statistic of each resample ``data[idx[i]]``: (n_bootstrap,)."""
    samples = data[idx]
    if statistic == "mean":
        return samples.mean(1)
    if statistic == "median":
        return _median(samples, 1)
    raise ValueError(statistic)


def bootstrap_confidence_interval(data, statistic: str = "mean", n_bootstrap: int = 10000,
                                  alpha: float = 0.05, seed: int = 42, device="cuda"):
    """(point estimate, ci_lower, ci_upper) of float32 ``data``."""
    values = torch.from_numpy(np.asarray(data, dtype=np.float32)).to(device)
    idx = _draw_indices(values.shape[0], n_bootstrap, seed).to(device)
    stats = _bootstrap_stats(values, idx, statistic).cpu().numpy()
    point = float(values.mean() if statistic == "mean" else _median(values))
    lo, hi = np.percentile(stats, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return point, float(lo), float(hi)


def safe_bootstrap_ci(data, statistic: str = "mean", **kw):
    """NaN/inf-safe variant (``full_evaluation_enhanced.py:1013-1018``):
    (point, (lo, hi)), all NaN when no value is finite."""
    arr = np.asarray(data, dtype=np.float64)
    valid = arr[np.isfinite(arr)]
    if len(valid) == 0:
        return np.nan, (np.nan, np.nan)
    point, lo, hi = bootstrap_confidence_interval(valid, statistic, **kw)
    return point, (lo, hi)
