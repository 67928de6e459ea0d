"""Data-parallel training over ``torch.distributed`` ranks and the
multi-scene trainer (port of ``nvfi_tpu/parallel/``)."""
