"""Front-end and map state."""
