"""A whole run on the card, at the tiny size: the same judge, the device
named as the card.  Skips without a CUDA card."""

import pytest

from .conftest import last_json, run_cell


@pytest.mark.card
@pytest.mark.parametrize("workload", ["tiny-proteome", "tiny-reads"])
def test_a_run_on_the_card(card, cache_root, tiny_db, workload):
    rc, out, err = run_cell(workload, 2**31 + 7, cache_root, trace=1,
                            device="cuda")
    assert rc == 0, "\n".join(err[-30:])
    res = last_json(out)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
