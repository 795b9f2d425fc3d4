"""The split path's, the supplementary records' and DIRS_CAP's metric
readers on synthetic windows: a value from the counters' deltas, and None
where the program has no such counter (as at a program that predates it)
or nothing to divide by."""

from types import SimpleNamespace

import pytest

from benchmark.harness.spec import Spec


def window(opened, closed, mbp=2.0):
    def delta(*keys):
        return sum(closed.get(k, 0) - opened.get(k, 0) for k in keys)
    return SimpleNamespace(stats_open=opened, stats_close=closed,
                           delta=delta, mbp=mbp)


OPEN = {"cells_align_useful": 1000, "cells_sv_useful": 100,
        "sv_align_rows": 10, "align_rows_refused": 1, "sv_probes": 30,
        "sv_realign_tries": 5, "records_supplementary": 7}
CLOSE = {"cells_align_useful": 5000, "cells_sv_useful": 1100,
         "sv_align_rows": 50, "align_rows_refused": 4, "sv_probes": 130,
         "sv_realign_tries": 25, "records_supplementary": 57}


@pytest.mark.parametrize("name,want", [
    ("sv.realign_cell_share", 25.0),         # 100 * 1000 / 4000
    ("sv.align_rows_per_Mbp", 20.0),         # 40 rows over 2 Mbp
    ("waves.rows_refused_per_Mbp", 1.5),     # 3 rows over 2 Mbp
    ("sv.probes_per_Mbp", 50.0),             # 100 rows over 2 Mbp
    ("sv.realign_tries_per_Mbp", 10.0),      # 20 tries over 2 Mbp
    ("sam.supplementary_per_Mbp", 25.0),     # 50 records over 2 Mbp
])
def test_reader_reads_the_deltas(name, want):
    assert Spec().reader(name)(window(OPEN, CLOSE)) == pytest.approx(want)


@pytest.mark.parametrize("name,key", [
    ("sv.realign_cell_share", "cells_sv_useful"),
    ("sv.align_rows_per_Mbp", "sv_align_rows"),
    ("waves.rows_refused_per_Mbp", "align_rows_refused"),
    ("sv.probes_per_Mbp", "sv_probes"),
    ("sv.realign_tries_per_Mbp", "sv_realign_tries"),
    ("sam.supplementary_per_Mbp", "records_supplementary"),
])
def test_reader_without_its_counter_reads_none(name, key):
    read = Spec().reader(name)
    without = {k: v for k, v in CLOSE.items() if k != key}
    assert read(window({}, without)) is None


@pytest.mark.parametrize("name,run", [
    ("sv.realign_cell_share", window(OPEN, dict(CLOSE, cells_align_useful=
                                                 1000))),
    ("sv.align_rows_per_Mbp", window(OPEN, CLOSE, mbp=0.0)),
    ("waves.rows_refused_per_Mbp", window(OPEN, CLOSE, mbp=0.0)),
    ("sv.probes_per_Mbp", window(OPEN, CLOSE, mbp=0.0)),
    ("sv.realign_tries_per_Mbp", window(OPEN, CLOSE, mbp=0.0)),
    ("sam.supplementary_per_Mbp", window(OPEN, CLOSE, mbp=0.0)),
])
def test_reader_with_nothing_to_divide_by_reads_none(name, run):
    assert Spec().reader(name)(run) is None


def test_a_window_with_no_refusal_reads_zero():
    read = Spec().reader("waves.rows_refused_per_Mbp")
    assert read(window(OPEN, dict(CLOSE, align_rows_refused=1))) == 0.0
