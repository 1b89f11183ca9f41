"""Runnable demos of the port (not imported by the package):
`single_obstacle` and `multi_obstacle`, the JAX package's test_scripts/."""
