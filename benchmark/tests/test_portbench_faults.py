"""A run drives the program on the CPU at a small size (the look for a
card skipped) and comes out correct; with the timed path broken
underneath, once for each fault a cell can have, it comes out not
correct. The control (benchmark/control.py: the program with half the
spot checks) comes out not correct too."""

import time

import pytest

import _small
from portbench import runner
from portbench.drivers import sharded

SEED = 2 ** 31 + 77


def _run(cell, overrides=None, seconds=1.0):
    return runner.run_cell(cell, SEED, seconds, False, "cpu", time.time(),
                           overrides)


def _batch():
    return _small.small_cell("mimc16.batch", claims_per_call=4, chunk=2,
                             check_claims=8, check_group=4)


def _altered(proofs):
    """The first proof's main root with one bit flipped."""
    first = list(proofs[0])
    first[0] = bytes([first[0][0] ^ 1]) + first[0][1:]
    return [first] + list(proofs[1:])


def test_sound_batch_run_is_correct():
    res = _run(_batch())
    assert res["correct"]
    assert res["checks"]["sections_differing"]["value"] == 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from starks_tpu_torch import prover
    real = prover.mk_mimc_proof_batch_fused
    monkeypatch.setattr(prover, "mk_mimc_proof_batch_fused",
                        lambda *a, **k: _altered(real(*a, **k)))
    res = _run(_batch())
    assert not res["correct"]
    assert res["checks"]["proofs_differing"]["value"] >= 1


def test_half_the_batch_left_out(monkeypatch):
    """Only the first half of each call's claims proved; their proofs
    stand in for the rest."""
    from starks_tpu_torch import prover
    real = prover.mk_mimc_proof_batch_fused

    def half(inps, *a, **k):
        got = real(list(inps)[:len(inps) // 2], *a, **k)
        return got + got
    monkeypatch.setattr(prover, "mk_mimc_proof_batch_fused", half)
    res = _run(_batch())
    assert not res["correct"]


def test_a_proof_altered_on_one_card(monkeypatch):
    from starks_tpu_torch import prover
    real = prover.mk_mimc_proof
    monkeypatch.setattr(prover, "mk_mimc_proof",
                        lambda *a, **k: _altered([real(*a, **k)])[0])
    res = _run(_small.small_cell("mimc20.single", check_claims=2))
    assert not res["correct"]


def test_sound_sharded_run_is_correct():
    res = _run(_small.small_cell("mimc20.shard4", check_claims=2))
    assert res["correct"]
    assert res["checks"]["rank_proofs_differing"]["value"] == 0


def test_the_exchange_between_ranks_left_out(monkeypatch):
    monkeypatch.setattr(sharded, "rank_main", _small.exchange_left_out)
    res = _run(_small.small_cell("mimc20.shard4", check_claims=2))
    assert not res["correct"]
    assert res["checks"]["sections_differing"]["value"] > 0


@pytest.mark.parametrize("cell, traffic", [
    ("mimc16.batch", dict(claims_per_call=4, chunk=2, check_claims=4,
                          check_group=4)),
    ("mimc20.single", dict(check_claims=2))])
def test_the_control_is_not_correct(cell, traffic):
    import control
    c = _small.small_cell(cell, **traffic)
    res = _run(c, control.control_overrides(c.config))
    assert not res["correct"]
    # Each proof lacks half its spot-check branches.
    assert res["checks"]["sections_differing"]["value"] >= 60
