"""Device ops: XLA array programs and their host (numpy) counterparts."""
