"""The control at small sizes on the CPU, judged as ``run.py`` judges the
program: the reference run in fp8 in the program's place comes out not
``correct`` where the program's own run is, on the same inputs; so does a
step that leaves half the batch out."""
import pytest

from bench.harness import cell
from bench.tests import smoke


def run(name, seconds):
    return cell.run(name, smoke.SEED, seconds, False, smoke.CPU,
                    t_process=0.0, config=smoke.config(name),
                    mix=smoke.mix(name), lim=smoke.limits(name),
                    control=True)


@pytest.mark.parametrize("name", [smoke.SERVE])
def test_serving_control_fails_where_the_program_passes(name):
    line = run(name, smoke.SECONDS)
    assert line["correct"] is True, line["checks"]
    assert line["controls"]["fp8"]["correct"] is False
    assert line["readings"]["fp8"]["widest_gap_std"] \
        > line["readings"]["program"]["widest_gap_std"]
    assert list(line)[-1] == "checks"


def test_training_control_and_half_batch_fail_where_the_program_passes():
    line = run(smoke.TRAIN, 1.0)
    assert line["correct"] is True, line["checks"]
    for control in ("fp8", "half_batch"):
        assert line["controls"][control]["correct"] is False, \
            line["controls"][control]["checks"]
