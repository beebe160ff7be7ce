"""The control, the reference in bfloat16 in the program's place, has to
fail each cell's judgement: small here on the CPU, at the cell's own size
on the card."""

import json

import pytest

from portbench import control
from portbench.tests.cells import CELLS, kind_of, small, spec_of

# the number each kind's control fails on every seed tried
FAILS = {"sweep": "replay_err", "trading": "decide_size_err"}


def _fails(numbers: dict, limits: dict) -> list:
    return sorted(k for k, v in numbers.items() if not v <= limits[k])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_the_control_fails_the_judgement_at_a_small_size(cell, seed):
    spec = small(cell)
    if kind_of(cell) == "sweep":
        spec["config"]["candles"], spec["traffic"]["strategies"] = 4000, 32
    else:
        spec["config"]["window"] = 256
    numbers = control.control_numbers(spec, seed, "cpu")
    assert FAILS[kind_of(cell)] in _fails(numbers, spec["config"]["limits"]), numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_judgement_at_the_cells_size(card, cell):
    spec = spec_of(cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers = control.control_numbers(spec, seed, "cuda")
        assert _fails(numbers, spec["config"]["limits"]), json.dumps(numbers)
