"""Helpers of the port: image and GIF writers, visualization and PLY export
(numpy), and the segmentation losses (torch)."""
