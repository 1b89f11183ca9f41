"""Experiment harnesses of the port (not imported by the package)."""
