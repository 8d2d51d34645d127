"""Generation facades."""
