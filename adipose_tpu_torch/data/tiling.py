"""Dataset build directories (``adipose_tpu/data/tiling.py``): the one
helper the trainer's command line needs."""

from __future__ import annotations

import re
from pathlib import Path


def find_most_recent_build_dir(base: str | Path) -> Path:
    """The newest ``_build_<YYYYmmdd_HHMMSS>`` (or ``_build_ecm_...``) under
    ``base``, else ``base/_build`` (``train_adipose_unet_v3.py:128-165``)."""
    base = Path(base)
    builds = []
    for p in base.glob("_build*"):
        m = re.search(r"_build(?:_ecm)?_(\d{8}_\d{6})$", p.name)
        if m:
            builds.append((m.group(1), p))
    if builds:
        return sorted(builds, reverse=True)[0][1]
    if (base / "_build").exists():
        return base / "_build"
    raise FileNotFoundError(f"No build directories found in {base}")
