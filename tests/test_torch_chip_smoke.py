"""``chip_smoke.py``'s measurement helpers, on the CPU.

What reaches the card's busy time and launch counts is chosen by
``chip_smoke.card_events``: the profiler's events on the card, but not its
user annotations. torch.optim wraps every step in a ``record_function``
range, ``Optimizer.step#AdamW.step``, which the profiler also places on the
card's timeline over the kernels it enqueued; counted, it would count those
kernels twice, the gaps between them as busy, and one launch too many.
Stand-in events with the attributes the profiler's averages carry show what
counts.

``chip_smoke.MoERouting`` gives a compared route the card's expert choices
and fails where rounding cannot explain a differing choice: held here on a
MoE layer, the CPU standing in for the card.
"""

import types

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

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


@pytest.mark.parametrize("mangled,name", [
    ("_ZN54_GLOBAL__N__16262854_21_attention_many_f32_cu_a16103b229attention_fwd_many_f32_"
     "kernelILi16ELb1EEEvPKfS2_S2_S2_Pfiiifjjf", "attention_fwd_many_f32_kernel<16, 1>"),
    ("_ZN3r3d28attention_fwd_cluster_kernelILi64ELb0ELb1EEEvPKfS2_",
     "attention_fwd_cluster_kernel<64, 0, 1>"),
    ("_Z22fuser_tail_tf32_kernelPKfS0_", "fuser_tail_tf32_kernel")])
def test_ptxas_entry_names_the_kernel_and_its_template_arguments(mangled, name):
    """What ``chip_smoke.py`` prints beside each instantiation's registers."""
    assert chip_smoke.ptxas_entry(mangled) == name


def _moe_routes(monkeypatch, card_select=None, noise=0.0, compared_calls=2):
    """A MoE layer's calls under ``MoERouting``: two on the card's route
    (here: outside ``plain_attention_route``, the CPU standing in for the
    card), through ``card_select`` if given, then ``compared_calls`` on a
    compared route whose router weight is off by ``noise``."""
    from r3d_tpu_torch.models import layers
    from r3d_tpu_torch.models.moe import MoEFeedForward

    monkeypatch.setattr(chip_smoke.MoERouting, "card_route",
                        lambda self, probs: layers.attention_kernel_eligible is self.kernel_route)
    gen = torch.Generator().manual_seed(0)
    m = MoEFeedForward(16, 32, 4, 2)
    m.router.weight.data = 0.3 * torch.randn(4, 16, generator=gen)
    x = torch.randn(2, 50, 16, generator=gen)
    with chip_smoke.MoERouting("test") as pin:
        own = pin.orig
        if card_select is not None:
            pin.orig = lambda module, probs: card_select(own(module, probs))
        for _ in range(2):
            m(x)
        pin.orig = own
        m.router.weight.data += noise * torch.randn(4, 16, generator=gen)
        with chip_smoke.plain_attention_route():
            for _ in range(compared_calls):
                m(x)
    return pin


def test_moe_routing_takes_explained_choices(monkeypatch):
    """A compared route whose router probabilities sit within
    ``ROUTER_PROB_TOL`` of the card's takes the card's choices; the tokens
    whose own choices differ lie within twice that difference of the top-K
    boundary."""
    pin = _moe_routes(monkeypatch, noise=0.01)
    assert 0 < pin.eps <= chip_smoke.ROUTER_PROB_TOL
    assert 0 < pin.differ < pin.total == 200


@pytest.mark.parametrize("fault", ["probabilities", "order", "replay"])
def test_moe_routing_fails_what_rounding_cannot_explain(monkeypatch, fault):
    """The pin fails on router probabilities off by more than
    ``ROUTER_PROB_TOL``, on card choices that are not the top K of the
    card's own probabilities (here its first and second choice swapped),
    and on a compared route that replays part of the recording."""
    with pytest.raises(AssertionError):
        if fault == "probabilities":
            _moe_routes(monkeypatch, noise=0.5)
        elif fault == "order":
            _moe_routes(monkeypatch, card_select=lambda c: c.flip(-1))
        else:
            _moe_routes(monkeypatch, compared_calls=1)
