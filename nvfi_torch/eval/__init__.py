"""Evaluation of the port: image metrics and the split-render harness."""
