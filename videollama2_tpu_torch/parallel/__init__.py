"""Device mesh and sharding (port of videollama2_tpu/parallel/)."""
