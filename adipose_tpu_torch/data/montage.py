"""ISBI-style montage assembly for sampling during training: a copy of
``adipose_tpu/data/montage.py`` (numpy and PIL, no device work).

Behavioral spec: ``src/utils/isbi_utils.py:8-27`` — read an image stack and a
mask stack, shuffle the page order with the caller's RNG, and arrange the
first ``nb_rows * nb_cols`` pages into one large 2-D montage pair
(images float32; masks divided by 255 and cast to int8). Legacy utility kept
for parity; the main pipeline samples tiles directly (``data/tiling.py``).

The montage is pure host-side data plumbing, so it stays numpy, vectorized
(one reshape/transpose instead of the reference's per-cell Python loop). The
reference reads stacks with ``tifffile``; :func:`load_tiff_stack` covers
multi-page TIFFs through PIL.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_tiff_stack(path: str | Path) -> np.ndarray:
    """Read a (possibly multi-page) TIFF into an (N, H, W) array."""
    from PIL import Image

    pages = []
    with Image.open(path) as im:
        for frame in range(getattr(im, "n_frames", 1)):
            im.seek(frame)
            pages.append(np.asarray(im))
    return np.stack(pages, axis=0)


def montage_pairs(
    imgs: np.ndarray,
    msks: np.ndarray,
    nb_rows: int,
    nb_cols: int,
    rng: np.random.RandomState,
):
    """Arrange shuffled stack pages into one (rows·H, cols·W) montage pair.

    ``imgs``/``msks``: (N, H, W) stacks; masks are 0/255 as in the reference
    stacks and come back as int8 0/1 (``isbi_utils.py:13-14`` divides by 255
    before placement). Requires ``nb_rows * nb_cols <= N`` (the reference
    raises ``StopIteration`` from its index iterator otherwise).
    """
    n, h, w = imgs.shape
    cells = nb_rows * nb_cols
    if cells > n:
        raise ValueError(f"montage needs {cells} pages, stack has {n}")
    idxs = np.arange(n)
    rng.shuffle(idxs)
    pick = idxs[:cells]

    def assemble(stack, dtype):
        grid = stack[pick].astype(dtype).reshape(nb_rows, nb_cols, h, w)
        return grid.transpose(0, 2, 1, 3).reshape(nb_rows * h, nb_cols * w)

    return assemble(imgs, np.float32), assemble(msks / 255, np.int8)


def isbi_get_data_montage(imgs_path, msks_path, nb_rows, nb_cols, rng):
    """File-path entry point matching the reference signature
    (``isbi_utils.py:8``)."""
    return montage_pairs(
        load_tiff_stack(imgs_path), load_tiff_stack(msks_path),
        nb_rows, nb_cols, rng,
    )
