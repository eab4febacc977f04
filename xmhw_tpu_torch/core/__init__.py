"""Numerical core in torch, operating on dense (time, cell) tensors."""
