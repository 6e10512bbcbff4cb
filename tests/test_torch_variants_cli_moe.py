"""MoE and the depth query source through the port's CLI against the JAX
CLI, on the CPU: the runs and bounds of ``tests/test_torch_variants_cli.py``
(``moe_experts=2`` on the utkinects model over its utkinect-layout dataset,
``--model futr_unsupervised_depth`` under ``darai``), in a file of their own
so that ``--dist loadfile`` spreads them."""

import pytest

from test_torch_variants_cli import train_eval_matches_jax_cli


@pytest.mark.parametrize("variant", ["moe", "depth"])
def test_train_eval_matches_jax_cli(variant, tmp_path, monkeypatch, capsys):
    train_eval_matches_jax_cli(variant, tmp_path, monkeypatch, capsys)
