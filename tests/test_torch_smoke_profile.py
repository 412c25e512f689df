"""`chip_smoke.py`'s profile sums (`device_averages`, `host_averages`,
read from the profiler's raw records) against `torch.profiler`'s own
`key_averages`, name by name: the same names, counts and times.

The host cases run on the CPU; the card case is marked ``cuda`` and
skips without a card.
"""

import importlib.util
import pathlib

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ops(dev):
    """Nested aten ops, some calling an op of their own name."""
    x = torch.randn(64, 64, device=dev)
    for _ in range(100):
        y = torch.nn.functional.linear(x, x).relu().sum(0)
        torch.stack([y, y]).mean().item()


def _backward(dev):
    """Records on the autograd engine's thread as well."""
    x = torch.randn(32, 32, device=dev, requires_grad=True)
    for _ in range(100):
        (x @ x).tanh().sum().backward()


def _same_name_chain(dev):
    """A record whose only child has its name, twice over."""
    x = torch.randn(16, 16, device=dev)
    for _ in range(100):
        with record_function("outer"):
            with record_function("outer"):
                with record_function("outer"):
                    x = (x * 0.5).exp()
                (x + 1).sum()


def _reference(prof, device_type, attr):
    sums = {}
    for ev in prof.key_averages():
        if ev.device_type == device_type:
            count, us = sums.get(ev.key, (0, 0.0))
            sums[ev.key] = (count + ev.count, us + getattr(ev, attr))
    return sums


def _assert_same(mine, ref, attr):
    got = {a.key: (a.count, getattr(a, attr)) for a in mine}
    assert sorted(got) == sorted(ref)
    for key, (count, us) in ref.items():
        assert got[key][0] == count, key
        assert got[key][1] == pytest.approx(us, rel=1e-9, abs=1e-6), key


@pytest.mark.parametrize("work", [_ops, _backward, _same_name_chain])
def test_host_averages_equal_key_averages(smoke, work):
    work("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work("cpu")
    _assert_same(smoke.host_averages(prof),
                 _reference(prof, DeviceType.CPU, "self_cpu_time_total"),
                 "self_cpu_time_total")
    assert smoke.device_averages(prof) == []


@pytest.mark.cuda
@pytest.mark.parametrize("work", [_ops, _backward])
def test_card_profile_averages_equal_key_averages(smoke, work):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    work("cuda")
    torch.cuda.synchronize()
    with smoke.profiled(torch) as prof:
        work("cuda")
    device = _reference(prof, DeviceType.CUDA, "self_device_time_total")
    assert device, "the profiler saw no device record"
    _assert_same(smoke.device_averages(prof), device,
                 "self_device_time_total")
    _assert_same(smoke.host_averages(prof),
                 _reference(prof, DeviceType.CPU, "self_cpu_time_total"),
                 "self_cpu_time_total")
