"""Conditioning: attributes, tokenizers, conditioners and the fuser."""
