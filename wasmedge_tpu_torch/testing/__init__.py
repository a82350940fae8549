"""Test harnesses shipped with the package (testing/faults.py: the
deterministic fault seams of supervised execution)."""
