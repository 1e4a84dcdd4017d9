"""The kernels' bounds (qvz_tpu_torch.roofline): the card's peak rates and
the least time of a kernel's bytes and operations."""

import types

import pytest

from qvz_tpu_torch import roofline

H100 = roofline.Card("NVIDIA H100 80GB HBM3, 700.00 W", 132, 1.98e9)


def test_bound_is_the_larger_time():
    assert roofline.bound(3.35e9, 1, 1e12) == (pytest.approx(1.0), "bytes")
    assert roofline.bound(0, 2e12, 1e12) == (pytest.approx(2e3),
                                             "operations")


def test_card_rates():
    """SMs x lanes x the top SM clock: 64 ALU and 64 IMAD lanes, 128
    issued instructions and 32 shared words an SM and clock."""
    assert H100.per_s(roofline.ALU_LANES_PER_SM) == pytest.approx(16.727e12,
                                                                  rel=1e-4)
    assert H100.int32_per_s == pytest.approx(33.454e12, rel=1e-4)
    assert H100.per_s(roofline.SHARED_WORDS_PER_SM) == pytest.approx(
        8.364e12, rel=1e-4)


@pytest.mark.parametrize("pipe,lanes", [
    ("alu", roofline.ALU_LANES_PER_SM), ("fma", roofline.FMA_LANES_PER_SM),
    ("issue", roofline.ISSUE_LANES_PER_SM),
    ("shared", roofline.SHARED_WORDS_PER_SM)])
def test_pipe_bound_is_the_slowest_pipe(pipe, lanes):
    per_elem = {"alu": 1, "fma": 1, "issue": 2, "shared": 0.5}
    per_elem[pipe] = 10
    elems = 1e9
    ms, by, got = roofline.pipe_bound(H100, per_elem, elems, 1e6)
    assert (got, by) == (pipe, "operations")
    assert ms == pytest.approx(10 * elems / H100.per_s(lanes) * 1e3)
    ms, by, got = roofline.pipe_bound(H100, per_elem, elems, 1e12)
    assert (got, by) == ("memory", "bytes")
    assert ms == pytest.approx(1e12 / roofline.HBM_BYTES_PER_S * 1e3)


def test_card_reads_nvidia_smi(monkeypatch):
    answers = {"clocks.max.sm": "1980 MHz",
               "name,power.limit": "NVIDIA H100 80GB HBM3, 700.00 W"}
    monkeypatch.setattr(roofline, "smi", answers.__getitem__)
    monkeypatch.setattr(roofline.torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    assert roofline.card(0) == H100
