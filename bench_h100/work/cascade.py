"""FLOPs of one request of the dual-model cascade: the gate's forward on
every tile (``work/inception.py``, at 299^2 whatever the tile) and the
U-Net's on the positive tiles only (``work/unet.py``, at the tile size).
Padded batch slots are not counted: they are not the request's work."""

from __future__ import annotations

from bench_h100.work import inception, unet


def request_flops(gate: dict, segmenter: dict, tiles: int, positive: int) -> float:
    return (tiles * inception.forward_flops(gate)
            + positive * unet.forward_flops(segmenter, segmenter["tile_size"]))
