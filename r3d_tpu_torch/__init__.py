"""r3d_tpu_torch — the PyTorch / CUDA port of ``r3d_tpu`` for one NVIDIA H100.

It imports ``torch`` and never JAX, and nothing of ``r3d_tpu``. The JAX
package stays the reference: each module here sits at the path of its
counterpart there and is tested equal to it on the CPU.

- ``r3d_tpu_torch.serving`` — ``InferenceSession`` and ``ServingQueue``, the
  serving entry points (CUDA unless the caller passes ``device="cpu"``).
- ``r3d_tpu_torch.models``  — ``futr_fusion_bn``: embeds, the BN token
  fuser, the FUTR decoder and the heads, as ``nn.Module``s.
- ``r3d_tpu_torch.ops``     — the hand-written Hopper kernels (CUDA C++ in
  ``csrc/``, built with nvcc at first use) and their plain PyTorch versions.
- ``r3d_tpu_torch.convert`` — flax ``{"params", "batch_stats"}`` to a
  ``state_dict``.
"""

__version__ = "0.1.0"
