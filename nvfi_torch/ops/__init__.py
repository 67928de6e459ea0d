"""Numeric ops of the port: encodings, plane sampling (kernel K1) and compositing (kernel K2)."""
