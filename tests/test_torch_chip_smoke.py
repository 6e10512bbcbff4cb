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
