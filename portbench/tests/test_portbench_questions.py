"""Each question of each task on the port (CPU, small sizes) against its
plain reference, held to the check's limits."""

import pytest
import torch

from portbench import check, harness
from portbench.tasks import groupby, join

CASES = [("g1_sort_questions", q) for q in groupby.QUESTIONS] + \
        [("j1_join_questions", q) for q in join.QUESTIONS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from portbench.tests.conftest import small_spec

    spec = small_spec(tmp_path_factory.mktemp("spec"))
    out = {}
    for name in ("g1_sort_questions", "j1_join_questions"):
        cell = harness.load_cell(name, spec)
        cell.mix = dict(cell.mix, questions=list(cell.task.QUESTIONS))
        r = harness.Run(cell, 2 ** 35 + 11, "cpu")
        r.setup()
        out[name] = r
    return out


@pytest.mark.parametrize("cell,q", CASES)
def test_question_matches_reference(runs, cell, q):
    r = runs[cell]
    answer = check.columns(r.fn(q)(r.frames), getattr(r.cell.task, "ANSWER_INDEX", {}).get(q, 0))
    numbers = check.compare(q, r.cell.reference.expected(q, r.data), answer, r.device, {})
    limits = {k: v for k, v in r.cell.task.LIMITS.items() if k.startswith(q + ".")}
    ok, shown = check.judge(numbers, limits)
    assert ok, shown
    assert set(numbers) == set(limits), (sorted(numbers), sorted(limits))


@pytest.mark.parametrize("cell,q", CASES)
def test_control_reads_above_program(runs, cell, q):
    """float32 in the reference's place: every float number reads above
    the program's, and above its limit."""
    r = runs[cell]
    exp = r.cell.reference.expected(q, r.data)
    low = r.cell.reference.expected(q, r.data, torch.float32)
    answer = [(n, v() if callable(v) else v) for n, v in low.items()]
    numbers = check.compare(q, exp, answer, r.device, {})
    gaps = {k: v for k, v in numbers.items() if k.endswith(".gap")}
    limits = r.cell.task.LIMITS
    for k, v in gaps.items():
        assert v > limits[k], (k, v, limits[k])
