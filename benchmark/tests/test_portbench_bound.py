"""The frozen bound model reads chip_smoke.py's published bounds
(PERF.md section 6, at 132 SMs and 1980 MHz) for the same shapes."""

import pytest

from portbench import bound

SMS, MHZ = 132, 1980.0


def _us(stage):
    _, nbytes, ops = stage
    return bound.least_seconds(nbytes, ops, SMS, MHZ) * 1e6


def test_a1_inverse_ntt_at_2e16():
    stage = bound.proof_stages(2 ** 16, 8, 64, 16)[0]
    assert stage[0] == "inverse NTT over the trace"
    assert round(_us(stage), 3) == 5.430


def test_a3_lde_at_2e19_points():
    stage = bound.proof_stages(2 ** 16, 8, 64, 16)[1]
    assert stage[0] == "LDE"
    assert round(_us(stage), 3) == 41.123


@pytest.mark.parametrize("steps, folds", [(2 ** 16, 7), (2 ** 20, 9),
                                          (128, 2)])
def test_one_fold_per_fri_round(steps, folds):
    names = [s[0] for s in bound.proof_stages(steps, 8, 64, 16)]
    assert sum(n.startswith("fold") for n in names) == folds


def test_proof_least_time_sums_its_stages():
    cfg = {"steps": 2 ** 16, "extension_factor": 8,
           "round_constants": list(range(64)), "fri_base_cutoff": 16}
    want = sum(_us(s) for s in bound.proof_stages(2 ** 16, 8, 64, 16))
    assert bound.proof_least_seconds(cfg, SMS, MHZ) * 1e6 == \
        pytest.approx(want)
