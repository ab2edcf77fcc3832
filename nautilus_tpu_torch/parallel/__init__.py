"""Factor-parallel solve and CSM batch over a gloo process group
(port of nautilus_tpu/parallel)."""
