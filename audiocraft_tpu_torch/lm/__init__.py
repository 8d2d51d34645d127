"""Language models over codebook streams."""
