"""Fields of the port: the keyframe K-plane model, its velocity field, MLPs,
shader, the segmentation MaskField and the static TensoRF (VM / CP) field."""
