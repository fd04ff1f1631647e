"""The reference-format parser (harness/stats.py) on old-format records.

A record of the 2017 format with split ``Logical Errors X/Z`` lines gets a
derived ``Logical Errors`` (the X+Z sum, as the JAX parser gives it) and a
marker entry saying so; every key the JAX parser returns has the same value
in the port's record.  Records that carry their own ``Logical Errors`` get
no marker.
"""

import pytest

from qec_ldpc_tpu.harness import stats as jax_stats
from qec_ldpc_tpu_torch.harness import stats

OLD = ("Code: code: J=2,K=3,L=6,P=7,sigma=2,tau=3 [[n=42,k=7]]\n"
       "Rand Seed: 5\nErrors Tested: 100\nError Weight: 3\nCorrected: 90\n"
       "Logical Errors X: 3\nLogical Errors Z: 4\n")
OLD_X_ONLY = "Code: code: J=2,K=3,L=6,P=7,sigma=2,tau=3 [[n=42,k=7]]\nLogical Errors X: 6\n"
NEW = ("Code: [J=3,K=3,L=6,P=7,s=2,t=3][[n=42,k=0]]\nErrors With X: 60\n"
       "Errors With Z: 61\nLogical Errors: 7\n")


@pytest.mark.parametrize("text,derived", [
    (OLD, "7"), (OLD_X_ONLY, "6"), (OLD + "\n" + OLD_X_ONLY, None)],
    ids=["x-and-z", "x-only", "two-records"])
def test_old_format_is_marked_and_shares_jax_values(text, derived):
    ported = stats.parse_reference_text(text)
    reference = jax_stats.parse_reference_text(text)
    assert len(ported) == len(reference) >= 1
    for rec, want in zip(ported, reference):
        assert rec[stats.DERIVED_MARKER[0]] == stats.DERIVED_MARKER[1]
        assert {k: rec[k] for k in want} == want
        assert set(rec) - set(want) == {stats.DERIVED_MARKER[0]}
    if derived is not None:
        assert ported[0]["Logical Errors"] == derived


def test_records_with_their_own_count_are_not_marked():
    both = OLD.replace("Logical Errors X: 3", "Logical Errors: 9\nLogical Errors X: 3")
    for text in (NEW, both):
        (rec,) = stats.parse_reference_text(text)
        assert stats.DERIVED_MARKER[0] not in rec
        assert rec == jax_stats.parse_reference_text(text)[0]
