"""Losses of the ``proposed_depth`` loop (counterpart of ``r3d_tpu/losses``)."""
