"""Rendering of the port: host-side rays and the chunked image renderer."""
