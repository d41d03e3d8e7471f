"""Neural-net building blocks (gencast_tpu.nn.nnx modules)."""
