"""Fields of the port: the keyframe K-plane model, its velocity field, MLPs and shader."""
