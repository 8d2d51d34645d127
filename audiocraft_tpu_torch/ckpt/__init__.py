"""Weight conversion."""
