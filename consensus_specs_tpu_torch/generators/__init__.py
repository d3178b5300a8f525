"""Test-vector generation (ref: tests/core/pyspec/eth2spec/gen_helpers/ and
tests/generators/): run the dual-mode test cases in generator mode and
write conformance vectors in the canonical
``preset/fork/runner/handler/suite/case`` layout — on the card's BLS
backend and hasher unless the caller asks for the CPU (gen_runner.py)."""
