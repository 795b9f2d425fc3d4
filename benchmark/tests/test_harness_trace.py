"""The trace's reading over the window: busy time as a union, device
seconds clipped to the window, idle gaps named by the host's events."""

import numpy as np
import pytest

from benchmark.harness import trace as T


class Ev:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def is_dev(e):
    return str(e.device_type()).endswith("CUDA")


EVENTS = [
    Ev(T.OPEN, 1000, 0, False), Ev(T.CLOSE, 2000, 0, False),
    Ev("void (anonymous namespace)::fill_tiled<2, 128>(int*)", 900, 300,
       True),                                   # 1000-1200 inside
    Ev("fill_wide<8>(int*)", 1100, 200, True),    # overlaps: union 1000-1300
    Ev("Memcpy HtoD (Pageable -> Device)", 1500, 100, True),
    Ev("k", 1950, 200, True),                     # 1950-2000 inside
    Ev("aten::copy_", 1300, 150, False),
    Ev("cudaStreamSynchronize", 1620, 300, False),
]


def test_busy_union_and_clipped_kernel_seconds():
    s = T.summarize(EVENTS, is_dev)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(450e-9)      # 300 + 100 + 50
    assert s.seconds_of("fill_tiled", "fill_wide") == pytest.approx(400e-9)
    assert dict(s.device_ops)["fill_tiled<2, 128>"] == pytest.approx(200e-9)
    assert dict(s.device_ops)["Memcpy HtoD"] == pytest.approx(100e-9)


def test_idle_gaps_longest_first_named_by_host_events():
    s = T.summarize(EVENTS, is_dev)
    gaps = s.idle_gaps
    assert [round(x[1] * 1e9) for x in gaps] == [350, 200]
    assert gaps[0][0] == "cudaStreamSynchronize"   # 1600-1950
    assert gaps[1][0] == "aten::copy_"             # 1300-1500


def test_wall_clock_edges_stand_in_for_markers():
    evs = [e for e in EVENTS if e.name() not in (T.OPEN, T.CLOSE)]
    s = T.summarize(evs, is_dev, (1000, 2000))
    assert s.busy_s == pytest.approx(450e-9)
    assert s.notes and "no markers" in s.notes[0]
    with pytest.raises(RuntimeError):
        T.summarize(evs, is_dev)


def test_merge():
    iv = np.array([[5, 7], [1, 3], [2, 4], [6, 9], [10, 11]])
    assert T.merge(iv).tolist() == [[1, 4], [5, 9], [10, 11]]
    assert T.merge(np.zeros((0, 2), dtype=np.int64)).shape == (0, 2)
