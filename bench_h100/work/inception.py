"""FLOPs of InceptionV3 at 299^2, conv by conv, walking the reference's
graph (``reference/inception.py:topology``) on shapes; the Dense head is
counted, BatchNorm, ReLU, pools and the sigmoid are not."""

from __future__ import annotations

from bench_h100.reference.inception import SIZE, topology


def _side(n: int, k: int, stride: int, valid: bool) -> int:
    return (n - k) // stride + 1 if valid else n


def forward_macs(config: dict | None = None, size: int = SIZE) -> float:
    """Multiply-adds of one forward pass over one size x size view."""
    macs = 0.0

    def conv_bn(shape, filters, kh, kw, stride=1, valid=False):
        nonlocal macs
        c, h, w = shape
        oh, ow = _side(h, kh, stride, valid), _side(w, kw, stride, valid)
        macs += kh * kw * c * filters * oh * ow
        return (filters, oh, ow)

    def max_pool(shape):
        c, h, w = shape
        return (c, (h - 3) // 2 + 1, (w - 3) // 2 + 1)

    def cat(shapes):
        return (sum(s[0] for s in shapes),) + shapes[0][1:]

    channels, _, _ = topology((3, size, size), conv_bn, lambda s: s, max_pool, cat)
    return macs + channels  # the Dense(2048 -> 1) head


def forward_flops(config: dict | None = None, size: int = SIZE) -> float:
    return 2.0 * forward_macs(config, size)
