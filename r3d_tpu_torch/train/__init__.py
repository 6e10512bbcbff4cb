"""Training: optimizer, state and the ``proposed_depth`` loop."""
