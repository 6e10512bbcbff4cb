"""Checkpointing with ``torch.save``.

Counterpart of ``r3d_tpu/train/checkpoint.py``. The reference saves only
``model.state_dict()`` on a validation improvement, as
``seed_{s}_checkpoint{e}`` and ``seed_{s}_best``; here, as in the JAX
package, the whole train state is saved (the model's ``state_dict`` with
its BatchNorm buffers, the optimizer's ``state_dict`` and the step
counts), so a resume is exact, and a rolling ``seed_{s}_last`` is kept every
epoch. Each checkpoint is a directory of that name holding ``state.pt``.
``restore_model`` loads the model alone (serving and the sweep), reading
nothing of the optimizer's state.

On a process group every rank calls ``save`` and ``restore``: the file
holds the whole train state (FSDP's shards gathered), written by rank 0
alone, the same tensors a one-process run writes, and it restores into a
state of any world size, each rank taking its shards of it.
"""

from __future__ import annotations

import os

import torch

from r3d_tpu_torch.parallel.mesh import barrier, full_tensors, is_writer, like, load_full_optimizer
from r3d_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


class Checkpointer:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    def save(self, state: TrainState, name: str) -> None:
        """Write ``state`` as checkpoint ``name``, replacing one of that name;
        the file appears whole or not at all."""
        blob = {"model": full_tensors(state.model.state_dict()),
                "optimizer": full_tensors(state.optimizer.state_dict()),
                "step": int(state.step), "extra_batches": int(state.extra_batches)}
        if is_writer():
            path = self._path(name)
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, STATE_FILE + ".tmp")
            torch.save(blob, tmp)
            os.replace(tmp, os.path.join(path, STATE_FILE))
        barrier()

    def save_best(self, state: TrainState, seed: int, epoch: int) -> None:
        self.save(state, f"seed_{seed}_checkpoint{epoch}")
        self.save(state, f"seed_{seed}_best")

    def save_last(self, state: TrainState, seed: int) -> None:
        """The rolling full-state checkpoint an exact resume starts from."""
        self.save(state, f"seed_{seed}_last")

    def restore(self, name: str, template: TrainState) -> TrainState:
        """Load checkpoint ``name`` into ``template`` (a state built for the
        same config, e.g. by ``Trainer.init_state``), onto the device its
        model lives on, and return it."""
        device = next(template.model.parameters()).device
        blob = torch.load(os.path.join(self._path(name), STATE_FILE), map_location=device,
                          weights_only=True)
        current = template.model.state_dict()
        template.model.load_state_dict({k: like(v, current[k]) for k, v in blob["model"].items()})
        load_full_optimizer(template.optimizer, blob["optimizer"])
        template.step = int(blob["step"])
        template.extra_batches = int(blob.get("extra_batches", 0))
        return template

    def restore_model(self, name: str, model: torch.nn.Module) -> torch.nn.Module:
        """Load the model of checkpoint ``name`` (parameters and BatchNorm
        buffers) into ``model`` and return it. The file is mapped, not read
        whole, so the optimizer's moments are neither read nor copied to the
        card."""
        blob = torch.load(os.path.join(self._path(name), STATE_FILE), map_location="cpu",
                          weights_only=True, mmap=True)
        model.load_state_dict(blob["model"])
        return model

    def restore_best(self, seed: int, template: TrainState) -> TrainState:
        return self.restore(f"seed_{seed}_best", template)

    def restore_last(self, seed: int, template: TrainState) -> TrainState:
        return self.restore(f"seed_{seed}_last", template)

    def has(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self._path(name), STATE_FILE))
