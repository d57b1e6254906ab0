"""The LM substrate: configuration, layers, the dense transformer, weights."""
