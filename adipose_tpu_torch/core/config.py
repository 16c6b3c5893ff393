"""The U-Net's architecture config, framework-free.

A copy of ``adipose_tpu/core/config.py`` ``UNetConfig`` with the fields a
checkpoint's ``training_settings.log`` records; the compute, remat, lane
padding and head knobs are chosen by the caller. ``from_json`` ignores keys
it does not know, so a config written by the JAX package loads here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path


class _JsonMixin:
    def to_json(self, path: str | Path | None = None) -> str:
        text = json.dumps(dataclasses.asdict(self), indent=2, default=str)
        if path is not None:
            Path(path).write_text(text)
        return text

    @classmethod
    def from_json(cls, path: str | Path):
        data = json.loads(Path(path).read_text())
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


@dataclass
class UNetConfig(_JsonMixin):
    """Architecture of the dilated-bottleneck U-Net: 3-level encoder from
    ``init_nb`` filters, six summed dilated convs, skip-concat decoder,
    two-class softmax head, optional deep-supervision heads."""

    tile_size: int = 1024
    init_nb: int = 44
    dropout_rate: float = 0.3
    use_deep_supervision: bool = False
    dilation_rates: tuple = (1, 2, 4, 8, 16, 32)
