"""The port's layout probe (``adipose_tpu_torch/scripts/exp_layout_probe.py``)
and kernel I's plain version against the JAX probe's own code,
``scripts/exp_layout_probe.py``, unedited: the functions nested in its
``main()`` are taken out with ``ast`` and run with ``pl.pallas_call`` in
interpret mode. An identity is exact, so the identities are compared bit for
bit; the chains run bf16 convs that XLA and PyTorch sum in other orders, so
they are held to one bf16 ulp of the max. Kernel I itself is compared with
its plain version on the card by chip_smoke.py."""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from adipose_tpu_torch.models.convert import hwio_to_oihw, oihw_to_hwio
from adipose_tpu_torch.ops.cuda.layout import ident_hwbc, ident_hwbc_plain
from adipose_tpu_torch.scripts import exp_layout_probe as probe

ROOT = Path(__file__).resolve().parents[1]
JAX_PROBE = ROOT / "scripts" / "exp_layout_probe.py"
JAX_FUNCTIONS = ("conv", "ident_kernel", "pallas_ident_hwbc", "chain_plain", "chain_pallas")
B, H, C = 2, 16, 8


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_probe() -> types.SimpleNamespace:
    """The JAX probe's nested functions, with Pallas in interpret mode."""
    tree = ast.parse(JAX_PROBE.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in JAX_FUNCTIONS]
    assert [d.name for d in defs] == list(JAX_FUNCTIONS)
    interpret = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                      BlockSpec=pl.BlockSpec)
    namespace = {"jax": jax, "jnp": jnp, "pl": interpret}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(JAX_PROBE), "exec"), namespace)
    return types.SimpleNamespace(**{name: namespace[name] for name in JAX_FUNCTIONS})


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("layout", ["channels_last_view", "contiguous"])
def test_ident_hwbc_bit_equal_to_pallas_and_keeps_strides(jax_probe, layout):
    rs = np.random.RandomState(5)
    if layout == "channels_last_view":  # the probe's y.permute(2, 3, 0, 1)
        bhwc = rs.randn(B, H, H, C).astype(np.float32)
        hwbc = bhwc.transpose(1, 2, 0, 3)
        t = torch.from_numpy(bhwc).to(torch.bfloat16).permute(1, 2, 0, 3)
        assert t.stride() == (H * C, C, H * H * C, 1)
    else:
        hwbc = rs.randn(H, H, B, C).astype(np.float32)
        t = torch.from_numpy(hwbc).to(torch.bfloat16)
    want = np.asarray(jax_probe.pallas_ident_hwbc(jnp.asarray(hwbc, jnp.bfloat16)))
    before = ident_hwbc.launches
    got = ident_hwbc(t)
    assert ident_hwbc.launches == before  # a CPU tensor launches nothing
    assert got.stride() == t.stride() and got.data_ptr() != t.data_ptr()
    assert np.array_equal(_bits(got), want.view(np.int16))
    assert np.array_equal(_bits(got), _bits(ident_hwbc_plain(t)))


@pytest.mark.parametrize("case", ["float32", "3-d", "c_stride", "overlapping", "gapped",
                                  "not_cuda"])
def test_ident_hwbc_rejects_what_the_kernel_does_not_take(case):
    """Off the CPU the wrapper checks its input before it launches; a meta
    tensor runs those checks here."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    t, error, match = {
        "float32": (meta(4, 4, 2, 8, dtype=torch.float32), TypeError, "bfloat16"),
        "3-d": (meta(4, 2, 8), ValueError, r"\(H, W, B, C\)"),
        "c_stride": (meta(4, 4, 8, 2).transpose(2, 3), ValueError, "C's stride"),
        "overlapping": (meta(4, 4, 1, 8).expand(4, 4, 2, 8), ValueError, "dense"),
        "gapped": (meta(4, 4, 2, 16)[..., :8], ValueError, "dense"),
        "not_cuda": (meta(4, 4, 2, 8), ValueError, "CUDA device"),
    }[case]
    with pytest.raises(error, match=match):
        ident_hwbc(t)


@pytest.mark.parametrize("seed", [0, 1])
def test_chains_match_the_jax_probe_within_one_bf16_ulp(jax_probe, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, H, C).astype(np.float32)
    w1, w2 = ((0.05 * rs.randn(3, 3, C, C)).astype(np.float32) for _ in range(2))
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w2)]
    want_plain = float(jax_probe.chain_plain(*jargs))
    want_pallas = float(jax_probe.chain_pallas(*jargs))

    tx = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    tw = [torch.from_numpy(hwio_to_oihw(w)).to(torch.bfloat16)
          .contiguous(memory_format=torch.channels_last) for w in (w1, w2)]
    assert np.array_equal(oihw_to_hwio(tw[0].float().numpy()), np.asarray(jargs[1], np.float32))
    got_plain = probe.chain_plain(tx, *tw)
    got_kernel = probe.chain_kernel(tx, *tw)

    assert np.array_equal(_bits(got_plain), _bits(got_kernel))
    assert want_plain == want_pallas
    ulp = 2.0 ** (np.floor(np.log2(abs(want_plain))) - 7)  # bf16: 8 significant bits
    assert abs(got_plain.item() - want_plain) <= ulp, (got_plain.item(), want_plain)
    assert abs(got_kernel.item() - want_pallas) <= ulp, (got_kernel.item(), want_pallas)


def test_probe_inputs_are_bf16_channels_last_and_the_kernel_chain_refuses_a_relayout():
    x, w1, w2 = probe.probe_inputs(B, H, C, "cpu", torch.Generator().manual_seed(3))
    assert x.shape == (B, C, H, H) and w1.shape == w2.shape == (C, C, 3, 3)
    for t in (x, w1, w2):
        assert t.dtype == torch.bfloat16 and t.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="not channels-last"):
        probe.chain_kernel(x.contiguous(), w1.contiguous(), w2.contiguous())


def test_probe_run_prints_both_chains_and_main_needs_a_gpu(capsys):
    times = probe.run("cpu", batch=B, size=H, channels=C)
    lines = capsys.readouterr().out.splitlines()
    assert list(times) == ["plain", "kernel-ident"] and all(v > 0 for v in times.values())
    assert [line.split(":")[0] for line in lines] == ["plain       ", "kernel-ident"]
    assert all("host clock" in line and f"({B}, {C}, {H}, {H}) bf16" in line for line in lines)
    with pytest.raises(SystemExit, match="is_available"):
        probe.main([])  # the card by default; no fallback to the CPU
