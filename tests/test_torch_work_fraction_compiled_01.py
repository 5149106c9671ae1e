"""Fault F4, the compiled form at min work 0.1: ``partial_work``'s linspace
as the reference's scanned driver's compiled chunk computes it, bit for
bit, for every N from 2 to 1,024 and N = 10^6.  One XLA compilation a
value, so each min work has a file of its own and the test workers share
the time (tests/test_torch_work_fraction.py holds the eager form and the
drivers)."""
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_work_fraction import check_grid


def test_compiled_work_fraction_matches_reference_bitwise():
    check_grid(0.1, compiled=True)
