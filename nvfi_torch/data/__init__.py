"""Host-side data of the port: the synthetic scenes, the blender loaders and the
samplers."""

from .blender import (load_blender_data, load_blender_data_dynamic, load_blender_data_nosegm,
                      load_blender_data_segm)
from .synthetic import make_synthetic_scene, write_blender_dataset
from .sampler import PatchSampler, RayImportanceSampler, SimpleSampler
