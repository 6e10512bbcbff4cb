"""``chip_smoke.py``'s measurement helpers, on the CPU.

What reaches the card's busy time and launch counts is chosen by
``chip_smoke.card_events``: the profiler's events on the card, but not its
user annotations. torch.optim wraps every step in a ``record_function``
range, ``Optimizer.step#AdamW.step``, which the profiler also places on the
card's timeline over the kernels it enqueued; counted, it would count those
kernels twice, the gaps between them as busy, and one launch too many.
Stand-in events with the attributes the profiler's averages carry show what
counts.
"""

import types

import pytest
import torch

import chip_smoke

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(key, device_type, us, count=1, annotation=False):
    return types.SimpleNamespace(key=key, device_type=device_type, self_device_time_total=us,
                                 count=count, is_user_annotation=annotation)


class _Profile:
    def __init__(self, events):
        self.events = events

    def key_averages(self):
        return self.events


EVENTS = [
    _event("void fuser_tail_tf32_kernel<true, false, 64>(TailArgs)", CUDA, 30.0),
    _event("Memcpy HtoD (Pageable -> Device)", CUDA, 12.0, count=2),
    _event("Optimizer.step#AdamW.step", CUDA, 1300.0, annotation=True),
    _event("aten::mm", CPU, 0.0, count=4),
]


def test_card_events_leave_out_user_annotations():
    kept = chip_smoke.card_events(_Profile(EVENTS))
    assert [e.key for e in kept] == [EVENTS[0].key, EVENTS[1].key]
    assert sum(e.self_device_time_total for e in kept) == 42.0
    assert sum(e.count for e in kept) == 3


@pytest.mark.parametrize("annotation", [False, True])
def test_an_annotation_that_matches_a_kernel_name_is_still_left_out(annotation):
    """A range named like a kernel counts only if it is not an annotation."""
    e = _event("fuser_tail_tf32_kernel range", CUDA, 5.0, annotation=annotation)
    assert chip_smoke.card_events(_Profile([e])) == ([] if annotation else [e])


def test_own_kernels_name_every_kernel_of_the_sources_and_no_other():
    """``OWN_KERNELS`` (what the breakdowns count as the port's own) holds a
    fragment of every ``__global__`` function in ``r3d_tpu_torch/csrc`` and
    no fragment that names none, and the fp32 K6/K7 names that
    ``time_cross_fp32`` times are kernels there."""
    import pathlib
    import re

    csrc = pathlib.Path(chip_smoke.__file__).parent / "r3d_tpu_torch" / "csrc"
    text = "\n".join(re.sub(r"//[^\n]*", "", p.read_text()) for p in sorted(csrc.iterdir()))
    kernels = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(", text))
    assert "attention_fwd_cluster_kernel" in kernels and "attention_bwd_cluster_kernel" in kernels
    for k in kernels:
        assert any(f in k for f in chip_smoke.OWN_KERNELS), k
    for f in chip_smoke.OWN_KERNELS:
        assert any(f in k for k in kernels), f
    for name in chip_smoke.cross_fp32_kernel_names(16):
        assert name.split("<")[0] in kernels
