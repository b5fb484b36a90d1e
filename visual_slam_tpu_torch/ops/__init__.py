"""Tensor ops of the port: descriptors, matching, geometry, RANSAC, PnP."""
