"""Physics losses (port of ``nvfi_tpu/physics``)."""
