"""Numeric ops of the port: encodings, plane sampling (kernels K1, K1d), the static
plane x line lookup (K6, K6d, K6b), compositing (K2),
the alpha-mask lookups (K3, K4), the row gather (K5), the mask dilation and
the segmentation's KNN."""
