"""Fields of the port: the keyframe K-plane model, its velocity field, MLPs,
shader and the segmentation MaskField."""
