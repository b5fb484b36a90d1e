"""Utilities: evaluation, synthetic scene and BA problems, stage timers."""
