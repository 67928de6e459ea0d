"""nvfi_torch — the PyTorch/CUDA port of ``nvfi_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package module for module (``nvfi_torch/fields/
kplane.py`` <-> ``nvfi_tpu/fields/kplane.py`` and so on), and params keep the
JAX pytree layout, so both packages read the same checkpoints.  The port
imports ``torch`` and numpy/yaml only: never ``jax``, never ``nvfi_tpu``.

Ported so far: the dense-exact eval render (``render.renderer.render_image``
-> ``fields.kplane.render_rays``), with two hand-written CUDA kernels for
``sm_90a`` on its hot path (``csrc/plane_product.cu``, ``csrc/composite.cu``).
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""
