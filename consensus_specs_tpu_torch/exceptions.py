"""Shared control-flow exceptions."""


class SkippedTest(Exception):
    """A test case that is deliberately not applicable (wrong preset/fork).

    pytest mode converts it to a pytest.skip; generator mode counts it as
    skipped (ref gen_runner.py skip semantics)."""
