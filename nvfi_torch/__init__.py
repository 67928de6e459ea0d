"""nvfi_torch — the PyTorch/CUDA port of ``nvfi_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package module for module (``nvfi_torch/fields/
kplane.py`` <-> ``nvfi_tpu/fields/kplane.py`` and so on), and params keep the
JAX pytree layout, so both packages read the same checkpoints.  The port
imports ``torch`` and numpy/yaml only: never ``jax``, never ``nvfi_tpu``.

Ported so far: the dense-exact eval render (``render.renderer.render_image``
-> ``fields.kplane.render_rays``) and the alpha-mask eval path that scores a
model (``eval.harness.render_split`` -> ``fields.kplane.update_alpha_mask``
-> ``render_image(alpha_state=...)`` -> ``eval.metrics.estim_error``), one
training iteration (``train.trainer.make_train_step``: the render batches,
the L1 / TV / PDE regularizers, per-group Adam) and the stage loop around it
(``train.trainer.Trainer``, driven by ``python -m nvfi_torch.train_nvfi``:
upsamples, alpha-mask events and shrinks, turbo's probes, checkpoints, the
synthetic and blender data of ``nvfi_torch.data``), segmentation
(``train.segm.SegmTrainer``, driven by ``python -m nvfi_torch.train_segm``,
scored by ``python -m nvfi_torch.test_segm_render``) and motion transfer
(``python -m nvfi_torch.test_transfer_vel``), multi-frame ray batches and
the supervised, profiled training CLI (``--supervise``, ``--profile``), and
the scoring scripts ``python -m nvfi_torch.render_video`` and ``python -m
nvfi_torch.eval_all`` (``eval.velocity_eval``), and the static TensoRF
models (``fields.tensorf_vm``, ``train.static.StaticTrainer``: a
``model_name`` without ``Keyframe``), with hand-written CUDA kernels for
``sm_90a`` (``csrc/plane_product.cu``, ``csrc/plane_product_bwd.cu``,
``csrc/plane_line.cu``, ``csrc/plane_line_bwd.cu``, ``csrc/composite.cu``,
``csrc/composite_bwd.cu``, ``csrc/occupancy.cu``, ``csrc/row_gather.cu``).
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""
