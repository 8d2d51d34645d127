"""Command-line programs."""
