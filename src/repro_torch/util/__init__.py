"""Small dependency-free utilities shared across the repro packages."""
