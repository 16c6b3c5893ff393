"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` source compiles to an object file in its own ``nvcc``
process, all started together; the objects link into one shared library
with a plain C interface, ``build/kernels/libadipose_tpu_torch.so`` under
the repository root. It is built on first use and rebuilt when the hash of
the sources or the flags changes. Nothing here runs at import: the package
imports on a machine with no ``nvcc`` and no GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libadipose_tpu_torch.so"
# No --use_fast_math: the kernels' division and expf must be IEEE so they
# match their plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # device, x, in_u8, out, out_bf16, acc, stats, batch, n, mean, denom, thresh, stream
    "adipose_zscore": (_I, _P, _I, _P, _I, _P, _P, _I, _LL, _F, _F, _F, _P),
    # device, x, x_bf16, w, bias, out, npix, channels, stream
    "adipose_sigmoid_head": (_I, _P, _I, _P, _P, _P, _LL, _I, _P),
    # device, x, x_bf16, w, g, p, dx, partial, partial_rows, dw, dbias, npix,
    # channels, stream
    "adipose_sigmoid_head_bwd": (_I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _LL, _I, _P),
    # device, x, in_u8, hist, low_scale, out, batch, n, rank_lo, frac_lo,
    # rank_hi, frac_hi, stream
    "adipose_percentile": (_I, _P, _I, _P, _P, _P, _I, _LL, _F, _F, _F, _F, _P),
    # device, x, ids, out, batch, n, stream
    "adipose_d4": (_I, _P, _P, _P, _I, _I, _P),
    # device, x, out, n_h, n_w, n_b, n_c, s_h, s_w, s_b, s_c, stream
    "adipose_layout_ident": (_I, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return str(nvcc)


def build() -> Path:
    """Compile the kernels unless the library on disk matches the sources.

    Returns the library's path. Raises with nvcc's output if it fails.
    """
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f".{src.stem}.{pid}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{src.name} (code {p.returncode}):\n{log[-8000:]}"
              for src, p, log in zip(_sources(), procs, logs) if p.returncode != 0]
    tmp = BUILD_DIR / f".{LIB_NAME}.{pid}"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link (code {link.returncode}):\n{link.stderr[-8000:]}")
    (BUILD_DIR / "nvcc.log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's C signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.adipose_error_string.argtypes = (ctypes.c_int,)
    lib.adipose_error_string.restype = ctypes.c_char_p
    return lib


def launch_target(device) -> tuple[int, int]:
    """(device index, handle of its current stream) for a launch on ``device``:
    kernels run on PyTorch's current stream and never synchronize."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = library().adipose_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
