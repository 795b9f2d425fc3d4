"""The faults benchmark/calibrate.py plants act where the program produces
its answers: a band narrowed in the native wave's launch as in the Python
wave's dispatch, and a read's supplementary records dropped at the SAM
writer."""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import calibrate as C


@pytest.fixture
def planted(monkeypatch):
    """plant_faults() over recorders in the program's place, undone after
    the test; returns what each recorder saw."""
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.out import sam
    from ngmlr_tpu_torch.pipeline import native_engine
    seen = {"launch": [], "dispatch": [], "write": []}

    def launch(self, apk_p, na, spk_p, ns):
        seen["launch"].append(np.ctypeslib.as_array(
            ctypes.cast(apk_p, ctypes.POINTER(ctypes.c_int32)),
            shape=(na, 12)).copy())

    def dispatch(self, pk_all, *a, **k):
        seen["dispatch"].append(pk_all.copy())

    def write_read(self, read, records, mapped):
        seen["write"].append((records, mapped))
    monkeypatch.setattr(native_engine.NativeWave, "launch", launch)
    monkeypatch.setattr(device_engine.DeviceContext, "align_dispatch_pk",
                        dispatch)
    monkeypatch.setattr(sam.SamWriter, "write_read", write_read)
    monkeypatch.setitem(C.ACTIVE, "fault", "none")
    C.plant_faults()
    return seen


def test_narrow_acts_on_both_waves(planted):
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.pipeline import native_engine
    rows = np.arange(36, dtype=np.int32).reshape(3, 12)
    ptr = ctypes.c_void_p(rows.ctypes.data)
    wave = object.__new__(native_engine.NativeWave)
    for fault in ("none", "narrow50"):
        C.ACTIVE["fault"] = fault
        native_engine.NativeWave.launch(wave, ptr, 3, None, 0)
        device_engine.DeviceContext.align_dispatch_pk(None, rows)
    for plain, cut in (planted["launch"], planted["dispatch"]):
        assert np.array_equal(plain, rows)
        assert np.array_equal(cut[:, 9], rows[:, 9] // 2)
        assert np.array_equal(np.delete(cut, 9, 1), np.delete(rows, 9, 1))
    assert rows[0, 9] == 9          # the engine's own rows are untouched


def test_nosupp_keeps_the_primary_record_alone(planted):
    from ngmlr_tpu_torch.out import sam
    recs = [SimpleNamespace(align=SimpleNamespace(primary=p))
            for p in (False, True, False)]
    read = SimpleNamespace(name=b"r6")
    for fault in ("none", "nosupp"):
        C.ACTIVE["fault"] = fault
        sam.SamWriter.write_read(None, read, recs, True)
    assert planted["write"] == [(recs, True), ([recs[1]], True)]
