"""Losses of the port's loops (counterpart of ``r3d_tpu/losses``)."""
