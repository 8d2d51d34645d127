"""Compression models."""
