"""Central seeding with the reference's ``seed.csv`` contract
(``adipose_tpu/core/seeding.py``).

The project seed (865 by default) roots every random stream: a consumer
derives its own ``torch.Generator`` from (domain string, seed, index) with
:func:`generator_for`, as the JAX package derives a key with ``key_for``.
The domain is hashed with sha256 (stable across runs, unlike Python's salted
``hash``), so streams of different domains and indices are independent, and
any one is reproducible in isolation.

torch's generators cannot reproduce ``jax.random``'s streams: the same seed
gives other numbers here than in the JAX package. Tests that compare the two
feed both the same draws.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import torch

DEFAULT_SEED = 865  # reference seed.csv:1

_REPO_ROOT = Path(__file__).resolve().parents[2]


def load_seed(path: str | os.PathLike | None = None) -> int:
    """The project seed from a one-line CSV file; a missing or corrupt file
    gives the default."""
    if path is None:
        path = _REPO_ROOT / "seed.csv"
    try:
        text = Path(path).read_text().strip()
        return int(text.splitlines()[0].split(",")[0].strip())
    except (OSError, ValueError, IndexError):
        return DEFAULT_SEED


def get_project_seed(path: str | os.PathLike | None = None) -> int:
    """Project-wide seed."""
    return load_seed(path)


def seed_for(domain: str, seed: int | None = None, index: int | None = None) -> int:
    """The 63-bit generator seed of (domain, seed, index): the first four
    bytes of sha256(domain), as ``key_for`` folds them, hashed again with
    the seed and the index."""
    if seed is None:
        seed = get_project_seed()
    fold = int.from_bytes(hashlib.sha256(domain.encode("utf-8")).digest()[:4], "little")
    tail = "" if index is None else f":{int(index)}"
    digest = hashlib.sha256(f"{int(seed)}:{fold}{tail}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator_for(domain: str, seed: int | None = None, index: int | None = None,
                  device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for a named domain (and optional
    element index), seeded by :func:`seed_for`."""
    return torch.Generator(device=device).manual_seed(seed_for(domain, seed, index))
