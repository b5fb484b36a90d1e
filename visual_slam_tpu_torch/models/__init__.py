"""Front-end, map state, and bundle adjustment (online and large-map)."""
