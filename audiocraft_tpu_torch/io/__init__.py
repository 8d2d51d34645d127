"""Audio input and output helpers."""
