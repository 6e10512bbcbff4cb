"""Command line of the port: ``python -m r3d_tpu_torch.cli --config NAME ...``
(``opts.py``: the flags; ``run.py``: train, predict, train_eval)."""
