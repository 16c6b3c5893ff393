"""Can a hand-written kernel sit between two cuDNN convs without a relayout?

The port of ``scripts/exp_layout_probe.py``. cuDNN's bf16 convs read and
write channels-last (B, C, H, W) activations; ``y.permute(2, 3, 0, 1)`` of
one is the logical (H, W, B, C) view that the JAX probe hands its Pallas
identity, in the conv's own byte order. Kernel I (``ops/cuda/layout.py``)
copies that view and keeps its strides, so the next conv sees the same bytes
with the same strides. The probe times

    x -> 3x3 SAME conv -> relu -> (H, W, B, C) view -> kernel I -> back
      -> 3x3 SAME conv -> max

against the same chain without the identity, at the JAX probe's shape: B 16,
H = W 1024, C 64, bf16. Each chain is timed over 6 calls after a warm-up, by
CUDA events on the card.

    python -m adipose_tpu_torch.scripts.exp_layout_probe    # one CUDA GPU
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
import torch.nn.functional as F

from adipose_tpu_torch.ops.cuda.layout import ident_hwbc

BATCH, SIZE, CHANNELS = 16, 1024, 64
ITERS = 6
SEED = 0


def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of a channels-last (B, C, H, W) ``x`` with a
    channels-last OIHW weight ``w``, no bias."""
    return F.conv2d(x, w, padding=1)


def chain_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return conv(torch.relu(conv(x, w1)), w2).amax()


def chain_kernel(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """:func:`chain_plain` with kernel I on the (H, W, B, C) view between the
    convs; nothing else copies."""
    y = torch.relu(conv(x, w1))
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"chain_kernel: conv1 gave strides {y.stride()}, not channels-last; "
                         "the probe would time a relayout")
    t = ident_hwbc(y.permute(2, 3, 0, 1))
    return conv(t.permute(2, 3, 0, 1), w2).amax()


def probe_inputs(batch: int, size: int, channels: int, device,
                 generator: torch.Generator) -> tuple[torch.Tensor, ...]:
    """x ~ N(0, 1) as (B, C, H, W) and two 3x3 weights ~ 0.05 N(0, 1) as
    OIHW, all bf16 and channels-last, drawn from ``generator``."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.bfloat16)

    x = normal(batch, size, size, channels).permute(0, 3, 1, 2)
    w1, w2 = ((0.05 * normal(channels, 3, 3, channels)).permute(0, 3, 1, 2) for _ in range(2))
    return x, w1, w2


def _time_ms(fn, args: tuple, device: torch.device) -> tuple[float, torch.Tensor]:
    """Mean time of ``fn(*args)`` over ``ITERS`` calls after one warm-up, by
    CUDA events on a GPU and by the host clock on the CPU; the last output."""
    out = fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn(*args)
        return (time.perf_counter() - t0) * 1e3 / ITERS, out
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS, out


def run(device, batch: int = BATCH, size: int = SIZE,
        channels: int = CHANNELS) -> dict[str, float]:
    """Time both chains on seeded inputs and print one line each; returns
    ms per call by chain name."""
    device = torch.device(device)
    x, w1, w2 = probe_inputs(batch, size, channels, device,
                             torch.Generator(device=device).manual_seed(SEED))
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    times = {}
    for name, fn in (("plain", chain_plain), ("kernel-ident", chain_kernel)):
        times[name], out = _time_ms(fn, (x, w1, w2), device)
        print(f"{name:<12}: {times[name]:9.4f} ms ({clock}, {ITERS} calls after a warm-up; "
              f"(B, C, H, W) = ({batch}, {channels}, {size}, {size}) bf16 channels-last); "
              f"max {out.item()}")
    return times


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) runs kernel I; cpu runs its plain version, "
                        "slowly at this shape")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("exp_layout_probe: torch.cuda.is_available() is false; this needs "
                             "a CUDA GPU (or --device cpu)")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"device: {smi}")
    else:
        print(f"device: {device}")
    return run(device)


if __name__ == "__main__":
    main()
