"""Operations and bytes from shapes."""

import pytest

from bench_h100 import common
from bench_h100.work import inception, kernels, unet

UNET = common.load_json(common.BENCH_DIR / "configs" / "dilated-unet-nb44.json")


def test_unet_forward_count_at_1024():
    assert unet.forward_macs(UNET, 1024) == pytest.approx(4.481e11, rel=1e-3)
    assert unet.forward_flops(UNET, 1024) == pytest.approx(0.896e12, rel=1e-3)


@pytest.mark.parametrize("scale,macs", [(1, 1.100e11), (2, 1.188e11), (4, 1.188e11),
                                        (8, 1.005e11)])
def test_unet_count_by_level(scale, macs):
    layers = unet.conv_layers(44, 6, False)
    got = sum(k * k * cin * cout * (1024 // s) ** 2 for _, cin, cout, k, s in layers
              if s == scale)
    assert got == pytest.approx(macs, rel=2e-3)


def test_unet_aux_heads_add_little():
    plain, ds = unet.forward_macs(UNET, 1024), unet.forward_macs(UNET, 1024, True)
    assert 0 < ds - plain < 1e-3 * plain


def test_inception_count():
    assert inception.forward_macs() == pytest.approx(5.71e9, rel=1e-2)


@pytest.mark.parametrize("kernel,shape,nbytes", [
    ("A", (16, 1024 * 1024), 50.3e6), ("B", (16, 44, 1024 * 1024), 1.54e9),
    ("P", (16, 1024 * 1024), 83.9e6), ("D", (2, 1024 * 1024), 16.8e6),
    ("P", (512, 1024 * 1024, 4), 4.29e9), ("D", (512, 1024 * 1024), 4.29e9)])
def test_kernel_bytes_match_the_kernel_table(kernel, shape, nbytes):
    work = kernels.launch_work(kernel, *shape)
    assert work["bytes"] == pytest.approx(nbytes, rel=5e-3)
    assert work["bound_by"] == "bytes"
    assert work["bound_s"] == pytest.approx(work["bytes"] / 3.35e12)
