"""walk_waits_per_call: the device walk route's waits a call, from the
port's counters; nothing to read without walk_device_calls (the host
route, or a program that does not count them)."""

import os

import pytest

from portbench import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Ctx:
    def __init__(self, counters):
        self.counters = counters


@pytest.mark.parametrize("counters, want", [
    ({"walk_device_calls": 40, "walk_waits": 80}, 2.0),
    ({"walk_device_calls": 3, "walk_waits": 450}, 150.0),
    ({"walk_device_calls": 40}, None),
    ({"walk_waits": 80}, None),
    ({"walk_device_calls": 0, "walk_waits": 0}, None),
    ({}, None),
])
def test_walk_waits_per_call(counters, want):
    man = manifest.Manifest(ROOT)
    assert man.reader("walk_waits_per_call").read(Ctx(counters)) == want
    entry = next(m for m in man.data["per_layer"] if m["name"] == "walk_waits_per_call")
    assert set(entry["workloads"]) == {"device.short-100x10", "device-pcc.long-200x200"}
