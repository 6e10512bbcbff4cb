"""Run bookkeeping: the metrics stream and a step timer."""
