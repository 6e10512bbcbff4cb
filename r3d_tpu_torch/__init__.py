"""r3d_tpu_torch — the PyTorch / CUDA port of ``r3d_tpu`` for one NVIDIA H100.

It imports ``torch`` and never JAX, and nothing of ``r3d_tpu``. The JAX
package stays the reference: each module here sits at the path of its
counterpart there and is tested equal to it on the CPU.

- ``r3d_tpu_torch.serving``    — ``InferenceSession`` (int8 weights, uint8
  depth, ``export``), ``ExportedSession`` and ``ServingQueue``, the serving
  entry points (CUDA unless the caller passes ``device="cpu"``).
- ``r3d_tpu_torch.train.loop`` — ``Trainer`` (``init_state``, ``fit``,
  ``train_step``, ``make_eval_step``): the ``proposed_depth``, ``futr``,
  ``proposed``, ``unsupervised``, ``unimodal`` and ``tcn`` training loops,
  CUDA unless the caller passes ``device="cpu"``; ``train.checkpoint``, the
  best and last checkpoints and resume.
- ``r3d_tpu_torch.cli``        — ``python -m r3d_tpu_torch.cli --config NAME
  ...``: train, validate, checkpoint and sweep the MoC protocol
  (``eval.predict.Predictor``, ``eval.moc``) over on-disk datasets
  (``data.datasets``), CUDA unless ``--cpu``.
- ``r3d_tpu_torch.models``     — every model of the JAX registry as an
  ``nn.Module`` (the fusion FUTRs, ``futr``, the query family, the
  ``rnn``/``cnn``/``tcn`` baselines), with MoE feed-forwards as an option.
- ``r3d_tpu_torch.data``, ``losses`` — collate, loader, synthetic and on-disk videos;
  the loop's losses.
- ``r3d_tpu_torch.ops``        — the hand-written Hopper kernels (CUDA C++
  in ``csrc/``, built with nvcc at first use), their plain PyTorch versions
  and the ``autograd.Function``s around them; effective rank.
- ``r3d_tpu_torch.convert``    — flax ``{"params", "batch_stats"}`` (or a
  gradient pytree) to a ``state_dict``.
"""

__version__ = "0.1.0"
