"""The benchmark's harness: what `run.py` drives a cell with."""
