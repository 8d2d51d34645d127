"""Utilities and the embedding and batch caches."""
