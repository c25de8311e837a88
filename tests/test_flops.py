"""utils/flops: published peaks keyed on device_kind; no silent default."""

from types import SimpleNamespace

import pytest

from colmap_pcd_tpu.utils import flops


@pytest.mark.parametrize("precision,tflops", [("fp32", 67), ("tf32", 495), ("bf16", 989)])
def test_h100_peak_resolves(precision, tflops):
    dev = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert flops.peak_flops_per_s(dev, precision) == tflops * 1e12


def test_counted_work_divides_by_tf32():
    dev = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert flops.peak_flops_per_s(dev) == 495e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peak"):
        flops.peak_flops_per_s(SimpleNamespace(device_kind=kind))
