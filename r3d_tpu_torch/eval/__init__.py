"""Evaluation helpers of the port."""
