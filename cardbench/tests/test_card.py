"""On the card: the control, the program built and run with its float32
products in TF32, comes out not correct, and the program correct, in
every cell, at a size a test run holds (1,024 lanes, a
window of one second, three seeds).  The limits were set from the same
readings at the cells' own sizes (cardbench.readings; PERF.md).

    python -m pytest cardbench/tests -q -m card   # on a machine with a card
"""

import pytest

from cardbench import run as CR
from cardbench.readings import readings

CELLS = [w['name'] for w in CR.load_json(CR.ROOT / 'BENCHMARK.json')
         ['workloads']]


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_and_program_passes(card, cell):
    recs = readings(cell, [2**31 + 11, 2**31 + 12, 2**31 + 13], 1.0,
                    mix_update={'batch': 1024})
    for rec in recs:
        limits = rec['limits']
        assert all(rec['program'][k] <= v for k, v in limits.items()), rec
        assert any(rec['control'][k] > v for k, v in limits.items()), rec
