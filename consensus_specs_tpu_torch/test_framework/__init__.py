"""Test framework: decorator DSL, state factories, and per-domain helpers
(ref: tests/core/pyspec/eth2spec/test/{context.py,utils/,helpers/}).

Tests written against this DSL run in two modes:
- pytest mode: yields are drained, assertions checked (ref utils.py:63-69);
- generator mode: yielded (name, kind, value) parts become conformance
  test-vector files (ref gen_helpers/, see generators package).
"""
