"""The control (the reference in TF32, in the program's place) comes
out not correct, on the card at a size a test run holds; ``control.py``
runs it at each cell's own size."""

import pytest

from benchmark import control


@pytest.mark.gpu
@pytest.mark.parametrize("workload,overrides", [
    ("legal-2620.search64", {"n_chunks": 600}),
    ("legal-2620.query-open", {"n_chunks": 600}),
])
def test_control_is_not_correct(card, workload, overrides):
    for seed in (1, 2, 3):
        numbers, limits, correct = control.control_numbers(
            workload, seed, card, overrides=overrides,
            mix_overrides={"judged": 2} if "search" in workload else
            {"judged": 16})
        assert not correct, numbers
