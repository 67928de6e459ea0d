"""Numeric ops of the port: encodings, plane sampling (kernels K1, K1d), compositing (K2),
the alpha-mask lookups (K3, K4), the row gather (K5) and the mask dilation."""
