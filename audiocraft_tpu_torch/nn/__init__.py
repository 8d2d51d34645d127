"""Layers: convs, LSTM, SEANet."""
