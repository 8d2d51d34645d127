"""Residual vector quantization."""
