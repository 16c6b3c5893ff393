"""Export JAX U-Net weights (orbax) to ``params.npz`` for the PyTorch port.

    python scripts/export_flax_params_npz.py <weights> [<weights> ...]

``<weights>`` is a weights entry (e.g. ``<run>/weights_best_overall``) or a
checkpoint dir, resolved as ``adipose segment --weights`` resolves it. The
Flax param tree is written as ``params.npz`` beside the orbax files, where
``adipose-torch segment --weights <run>`` reads it.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def export(weights: str | Path) -> Path:
    import jax
    import numpy as np

    from adipose_tpu.train import checkpoint as ckpt
    from adipose_tpu_torch.models.convert import save_flax_npz
    from adipose_tpu_torch.train.checkpoint import PARAMS_NPZ

    path = ckpt.resolve_weights_path(weights)
    tree = jax.tree.map(np.asarray, ckpt.load_params(path))
    return save_flax_npz(tree, path / PARAMS_NPZ)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("weights", nargs="+", help="weights entry or checkpoint dir")
    for w in parser.parse_args(argv).weights:
        print(export(w))


if __name__ == "__main__":
    main()
