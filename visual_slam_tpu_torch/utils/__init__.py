"""NumPy utilities: evaluation, synthetic scene, stage timers."""
