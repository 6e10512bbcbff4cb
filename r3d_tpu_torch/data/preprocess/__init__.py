"""Data preparation of the port (counterpart of ``r3d_tpu/data/preprocess``)."""
