"""Time K3, K4 and K5 in bf16 with S queries against S keys (the gt-query
FUTR's decoder attention) and in fp32 (the utkinects decoder's attention
forward, dropout forward and backward), K1 and K2 (the fuser tail and its
backward), K7 in bf16 and K6 and K7 in fp32 (the native cross-attention) of
this checkout against another checkout's, on one card, in turns.

    python3 kernel_ab.py OTHER_CHECKOUT      # from the root of a checkout, on a CUDA host

Builds ``attention.cu``, ``attention_bwd.cu``, ``fuser_tail.cu``,
``fuser_tail_bwd.cu``, ``cross_attention.cu`` and
``cross_attention_bwd.cu`` of the other checkout's ``r3d_tpu_torch/csrc``
with nvcc (the flags of ``r3d_tpu_torch/ops/build.py``) into ``build/ab/``,
loads them beside this checkout's, and times both on the same inputs in the
order other, this, this, other (three times over for K6 and K7 in fp32,
whose device times spread more from turn to turn): CUDA events around
back-to-back calls and the profiler's device time of all of a call's
launches, each the mean of a side's turns, and each turn's device time.
Where an entry point's signature changed, the other checkout's is read off
its source.

- K3, K4 and K5 in bf16 at Lq = Lk = S on full rows (``chip_smoke.SELF_TIMED``:
  S = 3,100 at D = 64, 2,000 at D = 16): this checkout's many-query bodies
  (``r3d_attention_fwd_many_bf16``, its dropout twin with the fp32 output
  and keep bits a training call asks for, ``r3d_attention_bwd_many_bf16``)
  against the
  other checkout's ``r3d_attention_fwd_bf16``, ``..._dropout_bf16`` and
  ``r3d_attention_bwd_bf16``, which run the few-query bodies there. Each
  side is held to the plain version (1e-2 of each tensor's own largest
  entry).
- K3 and K5 in fp32: ``r3d_attention_fwd`` and ``r3d_attention_bwd`` (rate
  0.1, as ``chip_smoke.py`` times it) at B = H = 8, Lq = 8, D = 16, Lk = 256
  and 512. The cluster bodies take the keys per block
  (``fp32_split_keys``); the bodies before them did not. Every output is
  held to the plain version (2e-5; K5 relative to each gradient's largest
  entry).
- K4 in fp32: ``r3d_attention_fwd_dropout`` (rate 0.1) at the same shapes.
  The cluster body takes the keys per block; the body before it did not.
  Held to the plain version (2e-5).
- K3, K4 and K5 in fp32 with S queries against S keys (the encoder's
  self-attention), B = H = 8, D = 16, S = 512 and 2,000: this checkout's
  many-query forward (``r3d_attention_fwd_many_f32``, its dropout twin;
  without gradients and keeping what the backward takes) against the
  other checkout's many-query forward where it has one, else its
  ``r3d_attention_fwd`` and ``r3d_attention_fwd_dropout``; this
  checkout's many-query backward (``r3d_attention_bwd_many_f32``) against
  the other's ``r3d_attention_bwd`` at Lq = Lk, its cluster body. Held to
  the plain version (2e-5; K5 relative to each gradient's largest entry,
  1e-4 at 2,000).
- K2: ``r3d_fuser_tail_bwd`` at the utkinects buckets' N = 8 x 256, 512,
  1,024 and 2,000 rows. The two-phase body takes its scratch and launch
  plan from ``bwd_plan``; the body before it took a block count and one
  [blocks, P] slice of scratch a block (zeroed by its own memset, which the
  device time counts). Every output is held to the plain version (1e-4 of
  each gradient's largest entry).
- K1: both C entry points (``r3d_fused_bn_blend_tail``,
  ``r3d_fused_safuser_tail``; both checkouts share their signatures) at the
  utkinects buckets' N = 8 x 256, 512, 1,024 and 2,000 rows. Every output
  is held to the plain version (1e-4).
- K7: ``r3d_cross_attention_bwd`` in bf16 at B = 8, Lq = 20, S = 3,100,
  C = 512, H = 8 (the 50salads decoder's training step). The split body
  takes keys per block from ``bwd_split_keys``; the body before it took the
  count of 64-key blocks, its scratch one fp32 dq slice a block. Every
  output is held to the plain version (2e-2 of each gradient's largest
  entry).
- K6 and K7 in fp32: ``r3d_cross_attention_fwd`` (rate 0) and
  ``r3d_cross_attention_bwd`` (rate 0 and 0.1) with dtype 0 at B = 8,
  Lq = 8, C = 128, H = 8, S = 1,024 and 2,000 (the utkinects 1024 and 2000
  buckets under R3D_CROSS_NATIVE=1). Both checkouts share the signatures;
  the cluster bodies take the keys per block (``fp32_split_keys``) and K7
  no scratch, where the first K6 body ignored the keys per block and the
  first K7 body took 64 keys a block and one fp32 dq slice a block. Held to the plain versions (out, m and l 2e-5; the gradients
  1e-4 of each one's largest entry).
- One encoder train step at the 2000 bucket, epoch 0 and sticky
  (``ENCODER_STEP``, ``chip_smoke.train_breakdown``), in a process of its
  own in each checkout, in the same turns: step ms, card-busy ms and
  launches.

Prints one line per kernel and shape and, as the last line, one JSON object
of the times in ms ([events, device] per side). Exits non-zero where CUDA is
missing.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke

N_ROWS = chip_smoke.K1_ROWS


@functools.lru_cache(maxsize=None)
def other_library(checkout: Path, source: str) -> ctypes.CDLL:
    """The other checkout's ``source``, built into build/ab/ here (once: a
    library in use is not written over)."""
    from r3d_tpu_torch.ops import build

    out = Path(__file__).resolve().parent / "build" / "ab" / f"{Path(source).stem}_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = checkout / "r3d_tpu_torch" / "csrc" / source
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out))


def bind(lib, kernel, argtypes=None):
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = argtypes or kernel.argtypes, ctypes.c_int
    return fn


def has(checkout: Path, source: str, marker: str) -> bool:
    """Whether the other checkout's ``source``, or a header it includes
    (``#include "..."``, followed on; the fp32 attention bodies live in
    ``*.cuh``), holds ``marker``: which body, and so which entry-point
    signature, it has."""
    csrc = checkout / "r3d_tpu_torch" / "csrc"
    seen, todo = set(), [source]
    while todo:
        name = todo.pop()
        if name in seen or not (csrc / name).is_file():
            continue
        seen.add(name)
        text = (csrc / name).read_text()
        if marker in text:
            return True
        todo += re.findall(r'^#include "([^"]+)"', text, re.MULTILINE)
    return False


def in_turns(label, calls, check, result, rounds=1):
    """Time ``calls`` {"this", "other"} as other, this, this, other,
    ``rounds`` times; run ``check(who)`` after each side's first call of a
    turn. Prints the means and each turn's device time."""
    import torch

    times = {who: [] for who in calls}
    for who in ("other", "this", "this", "other") * rounds:
        if calls[who]() != 0:
            raise RuntimeError(f"{label} ({who}) failed to launch")
        torch.cuda.synchronize()
        check(who)
        times[who].append((chip_smoke.time_ms(calls[who], iters=20),
                           chip_smoke.device_ms(calls[who], None)))
    # a trace now and then holds no device events (device_ms gives None):
    # such a turn counts for the events time only, and is reported as left out
    mean = {who: [sum(v) / len(v) for v in ([x for x in col if x is not None] for col in zip(*t))]
            for who, t in times.items()}
    result[label] = mean
    turns = lambda who: ", ".join("none" if t[1] is None else f"{t[1]:.4f}" for t in times[who])
    dropped = lambda who: sum(t[1] is None for t in times[who])
    print(f"{label}: other {mean['other'][0]:.4f} ms by events, {mean['other'][1]:.4f} on the "
          f"device ({dropped('other')} of {len(times['other'])} turns without device events "
          f"left out); this {mean['this'][0]:.4f} / {mean['this'][1]:.4f} ({dropped('this')} of "
          f"{len(times['this'])} left out); other / this by device "
          f"{mean['other'][1] / mean['this'][1]:.2f} (device, each turn: other {turns('other')}; "
          f"this {turns('this')})")


def attention_bf16_many(checkout, device, gen, stream, result, rate=0.1):
    """bf16 K3, K4 and K5 with S queries against S keys on full rows, at
    ``chip_smoke.SELF_TIMED`` (B = H = 8, S = 3,100, D = 64; B = 16, H = 8,
    S = 2,000, D = 16): this checkout's many-query bodies, launched as its
    wrappers launch them (K4 with the fp32 output and keep bits a training
    call asks for, K5 from what that K4 kept), against the other checkout's entry points
    at the same shapes, which run the few-query bodies. Each side held to
    the plain version within ``chip_smoke.SELF_TOL`` of each tensor's own
    largest entry."""
    import torch

    from r3d_tpu_torch.ops import attention as att

    fwd_lib = other_library(checkout, "attention.cu")
    old = {"K3": bind(fwd_lib, att.KERNEL_BF16), "K4": bind(fwd_lib, att.DROPOUT_KERNEL_BF16),
           "K5": bind(other_library(checkout, "attention_bwd.cu"), att.BWD_KERNEL_BF16)}
    new = {"K3": att.KERNEL_BF16_MANY.load(), "K4": att.DROPOUT_KERNEL_BF16_MANY.load(),
           "K5": att.BWD_KERNEL_BF16_MANY.load()}
    for B, H, S, D in chip_smoke.SELF_TIMED:
        q, k, v, bias = chip_smoke.attention_inputs(B, H, S, S, D, gen, device)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        bias = torch.zeros_like(bias)   # full rows
        g = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
        scale = 1.0 / math.sqrt(D)
        seed = 3000 + S
        drop = (seed, att.dropout_threshold(rate), 1.0 / (1.0 - rate))
        split, nkb = att.fwd_split_keys(S), -(-S // att.BWD_BLOCK_KEYS)
        label = f"B={B} H={H} Lq=Lk={S} D={D} bf16, full rows"
        qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr())
        outs = {who: torch.empty_like(q) for who in ("this", "other")}
        out32 = torch.empty(q.shape, device=device)
        stats = torch.empty(2, B * H, S, device=device)
        keep_bits = torch.empty(att.keep_bits_shape(B, H, S, S), dtype=torch.int32, device=device)

        def hold(name, got, want):
            def check(who):
                rel = chip_smoke.errs_own(got(who), want)[1]
                if not rel <= chip_smoke.SELF_TOL:
                    raise AssertionError(f"{name} bf16 ({who}) disagrees with its plain version "
                                         f"at {label}: {rel:.3e}")
            return check

        fwd = lambda who: [outs[who]]
        calls = {"this": lambda: new["K3"](*qkv, outs["this"].data_ptr(), None, stats.data_ptr(),
                                           B, H, S, S, D, scale, stream),
                 "other": lambda: old["K3"](*qkv, outs["other"].data_ptr(), B, H, S, S, D, split,
                                            scale, stream)}
        in_turns(f"attention_fwd bf16 {label}", calls, hold(
            "K3", fwd, [att.composed_attention(q, k, v, bias, scale)]), result)
        calls = {"this": lambda: new["K4"](*qkv, outs["this"].data_ptr(), out32.data_ptr(),
                                           stats.data_ptr(), keep_bits.data_ptr(), B, H, S, S, D,
                                           scale, *drop, stream),
                 "other": lambda: old["K4"](*qkv, outs["other"].data_ptr(), B, H, S, S, D, split,
                                            scale, *drop, stream)}
        in_turns(f"attention_fwd_dropout bf16 {label} p={rate} (this: with out32)", calls, hold(
            "K4", fwd, [att.composed_attention_dropout(q, k, v, bias, seed, scale, rate)]), result)
        grads = {who: tuple(torch.empty_like(t) for t in (q, k, v)) for who in outs}
        delta = torch.empty(B * H, S, device=device)
        block_stats = torch.empty(3 * nkb * B * H * S, device=device)
        part = torch.empty(nkb * B * H * S * D, device=device)
        ptrs = lambda who: tuple(t.data_ptr() for t in grads[who]) + (None,)
        calls = {"this": lambda: new["K5"](*qkv, g.data_ptr(), out32.data_ptr(), stats.data_ptr(),
                                           keep_bits.data_ptr(), delta.data_ptr(), *ptrs("this"),
                                           B, H, S, S, D, scale, 1, drop[2], stream),
                 "other": lambda: old["K5"](*qkv, g.data_ptr(), *ptrs("other"),
                                            block_stats.data_ptr(), part.data_ptr(), B, H, S, S,
                                            D, nkb, scale, 1, *drop, stream)}
        want = att.composed_attention_bwd(q, k, v, bias, seed, scale, rate, g, False)[:3]
        in_turns(f"attention_bwd bf16 {label} p={rate}", calls,
                 hold("K5", lambda who: grads[who], want), result)
        del want, block_stats, part
        torch.cuda.empty_cache()


def fuser_tail(other, device, gen, stream, result):
    import torch

    from r3d_tpu_torch.ops import fuser_kernel as fk

    libs = {kernel.name: {"this": kernel.load(), "other": bind(other, kernel)}
            for kernel in (fk.KERNEL, fk.TAIL_KERNEL)}
    for N in N_ROWS:
        r, d, blend, params = chip_smoke.fuser_inputs(N, gen, device)
        args = {fk.KERNEL.name: (r.data_ptr(), d.data_ptr(), *(t.data_ptr() for t in blend)),
                fk.TAIL_KERNEL.name: (r.data_ptr(), d.data_ptr())}
        plain = {fk.KERNEL.name: fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params),
                 fk.TAIL_KERNEL.name: fk.composed_tail(r, d, params)}
        for name, fns in libs.items():
            out = torch.empty_like(r)
            calls = {who: (lambda fn=fn: fn(*args[name], *(t.data_ptr() for t in params),
                                            out.data_ptr(), N, 128, 512, 0, stream))
                     for who, fn in fns.items()}

            def check(who, name=name):
                err = float((out - plain[name]).abs().max())
                if not err <= chip_smoke.K1_TOL:
                    raise AssertionError(f"{name} ({who}) disagrees with its plain version at "
                                         f"N={N}: {err:.3e}")

            in_turns(f"{name} N={N}", calls, check, result)


def fuser_tail_bwd(checkout, device, gen, stream, result):
    """K2 at the utkinects buckets' N."""
    import torch

    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    first_body = has(checkout, "fuser_tail_bwd.cu", "sum_partials_kernel")
    old_argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fns = {"this": fkb.KERNEL.load(),
           "other": bind(other_library(checkout, "fuser_tail_bwd.cu"), fkb.KERNEL,
                         old_argtypes if first_body else None)}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    layout, P = fkb.grad_layout(128, 512)
    for N in N_ROWS:
        r, d, _, params = chip_smoke.fuser_inputs(N, gen, device)
        g = torch.randn(N, 128, generator=gen).to(device)
        want = fkb.composed_tail_bwd(r, d, g, params, False)
        want = (want[0], want[1], *want[2])
        outs, calls = {}, {}
        for who, fn in fns.items():
            plan = fkb.bwd_plan(N, 512, sms)
            if who == "other" and first_body:
                blocks = max(1, min(-(-N // 16), sms))   # its 16 rows a tile
                scratch, ints = torch.empty(blocks * P, device=device), (blocks,)
            else:
                scratch = torch.empty(fkb.scratch_floats(128, 512, plan), device=device)
                ints = (plan.tile_rows, plan.split_rows)
            dr, dd, flat = torch.empty_like(r), torch.empty_like(d), torch.empty(P, device=device)
            outs[who] = (dr, dd, flat)
            calls[who] = (lambda fn=fn, dr=dr, dd=dd, flat=flat, scratch=scratch, ints=ints: fn(
                r.data_ptr(), d.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in params),
                dr.data_ptr(), dd.data_ptr(), scratch.data_ptr(), flat.data_ptr(), N, 128, 512,
                *ints, 0, stream))

        def check(who):
            dr, dd, flat = outs[who]
            got = (dr, dd, *(flat[off:off + torch.Size(sh).numel()].view(sh)
                             for off, sh in layout))
            rel = chip_smoke.errs(got, want)[1]
            if not rel <= chip_smoke.K2_TOL:
                raise AssertionError(f"K2 ({who}) disagrees with its plain version at N={N}: "
                                     f"{rel:.3e}")

        in_turns(f"fused_tail_bwd N={N}", calls, check, result)


def attention_fp32(checkout, device, gen, stream, result, B=8, H=8, Lq=8, D=16, rate=0.1):
    """K3, K4 and K5 in fp32 at the utkinects decoder's shape, Lk = 256 and 512."""
    import torch

    from r3d_tpu_torch.ops import attention as att

    scale = 1.0 / math.sqrt(D)
    fwd_split = has(checkout, "attention.cu", "attention_fwd_cluster_kernel")
    bwd_split = has(checkout, "attention_bwd.cu", "attention_bwd_cluster_kernel")
    drop_split = not has(checkout, "attention.cu", "launch_fp32_dropout")
    unsplit = lambda argtypes, at: argtypes[:at] + argtypes[at + 1:]   # without the split int
    fwd = {"this": att.KERNEL.load(),
           "other": bind(other_library(checkout, "attention.cu"), att.KERNEL,
                         None if fwd_split else unsplit(att.KERNEL.argtypes, 10))}
    drop = {"this": att.DROPOUT_KERNEL.load(),
            "other": bind(other_library(checkout, "attention.cu"), att.DROPOUT_KERNEL,
                          None if drop_split else unsplit(att.DROPOUT_KERNEL.argtypes, 10))}
    bwd = {"this": att.BWD_KERNEL.load(),
           "other": bind(other_library(checkout, "attention_bwd.cu"), att.BWD_KERNEL,
                         None if bwd_split else unsplit(att.BWD_KERNEL.argtypes, 14))}
    for Lk in (256, 512):
        q, k, v, bias = chip_smoke.attention_inputs(B, H, Lq, Lk, D, gen, device)
        g = torch.randn(q.shape, generator=gen).to(device)
        split = att.fp32_split_keys(Lk)
        seed, thr = 1000 + Lk, att.dropout_threshold(rate)
        want = att.composed_attention(q, k, v, bias, scale)
        want_b = att.composed_attention_bwd(q, k, v, bias, seed, scale, rate, g, False)[:3]
        outs = {who: torch.empty_like(q) for who in fwd}
        grads = {who: tuple(torch.empty_like(t) for t in (q, k, v)) for who in bwd}
        shape = lambda who, taken: (B, H, Lq, Lk, D) + ((split,) if taken else ())
        calls = {who: (lambda fn=fn, who=who: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), outs[who].data_ptr(),
            *shape(who, who == "this" or fwd_split), scale, stream)) for who, fn in fwd.items()}

        def check(who):
            err = float((outs[who] - want).abs().max())
            if not err <= chip_smoke.K3_TOL:
                raise AssertionError(f"K3 fp32 ({who}) disagrees with its plain version at "
                                     f"Lk={Lk}: {err:.3e}")

        in_turns(f"attention_fwd fp32 B={B} H={H} Lq={Lq} Lk={Lk} D={D}", calls, check, result)
        want_d = att.composed_attention_dropout(q, k, v, bias, seed, scale, rate)
        calls = {who: (lambda fn=fn, who=who: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), outs[who].data_ptr(),
            *shape(who, who == "this" or drop_split), scale, seed, thr, 1.0 / (1.0 - rate),
            stream)) for who, fn in drop.items()}

        def check_drop(who):
            err = float((outs[who] - want_d).abs().max())
            if not err <= chip_smoke.K3_TOL:
                raise AssertionError(f"K4 fp32 ({who}) disagrees with its plain version at "
                                     f"Lk={Lk}: {err:.3e}")

        in_turns(f"attention_fwd_dropout fp32 B={B} H={H} Lq={Lq} Lk={Lk} D={D} p={rate}", calls,
                 check_drop, result)
        calls = {who: (lambda fn=fn, who=who: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in grads[who]), None,
            *shape(who, who == "this" or bwd_split), scale, 1, seed, thr,
            1.0 / (1.0 - rate), stream)) for who, fn in bwd.items()}

        def check_bwd(who):
            rel = chip_smoke.errs(grads[who], want_b)[1]
            if not rel <= chip_smoke.K3_TOL:
                raise AssertionError(f"K5 fp32 ({who}) disagrees with its plain version at "
                                     f"Lk={Lk}: {rel:.3e}")

        in_turns(f"attention_bwd fp32 B={B} H={H} Lq={Lq} Lk={Lk} D={D} p={rate}", calls,
                 check_bwd, result)


def attention_fp32_many(checkout, device, gen, stream, result, B=8, H=8, D=16, rate=0.1):
    """fp32 K3, K4 and K5 (K4 and K5 at p = 0.1) with S queries against S
    keys (the encoder's self-attention), S = 512 and 2,000, this checkout's
    many-query bodies against the other checkout's entry points at Lq = Lk:
    K3 and K4 without gradients and as a training call runs them (keeping
    the statistics and, K4, the keep bits for K5) against the other's
    many-query forward where it has one (its entry point without the
    statistics where its source keeps none), else its
    ``r3d_attention_fwd`` and ``r3d_attention_fwd_dropout``; K5 from what
    this K4 kept (``r3d_attention_bwd_many_f32``) against the other's
    ``r3d_attention_bwd``, the cluster body. Each side held to the plain
    version (forward 2e-5; K5 ``chip_smoke.K3_TOL`` to 512 and
    ``SELF32_BWD_TOL`` past it, of each gradient's max(1, largest entry))."""
    import torch

    from r3d_tpu_torch.ops import attention as att

    scale = 1.0 / math.sqrt(D)
    if (checkout / "r3d_tpu_torch" / "csrc" / "attention_many_f32.cu").is_file():
        lib = other_library(checkout, "attention_many_f32.cu")
        kept = has(checkout, "attention_many_f32.cu", "kStats")   # takes the statistics
        old = {"K3": (bind(lib, att.KERNEL_MANY, None if kept else
                           att.KERNEL_MANY.argtypes[:5] + att.KERNEL_MANY.argtypes[6:]),
                      (None,) if kept else ()),
               "K4": (bind(lib, att.DROPOUT_KERNEL_MANY, None if kept else
                           att.DROPOUT_KERNEL_MANY.argtypes[:5]
                           + att.DROPOUT_KERNEL_MANY.argtypes[7:]),
                      (None, None) if kept else ())}
        other_body, split_arg = "its many-query forward", False
    else:
        lib = other_library(checkout, "attention.cu")
        old = {"K3": (bind(lib, att.KERNEL), ()), "K4": (bind(lib, att.DROPOUT_KERNEL), ())}
        other_body, split_arg = "its cluster body", True
    old_bwd = bind(other_library(checkout, "attention_bwd.cu"), att.BWD_KERNEL)
    new = {"K3": att.KERNEL_MANY.load(), "K4": att.DROPOUT_KERNEL_MANY.load()}
    for S in (512, 2000):
        q, k, v, bias = chip_smoke.attention_inputs(B, H, S, S, D, gen, device)
        g = torch.randn(q.shape, generator=gen).to(device)
        seed = 4000 + S
        drop = {"K3": (), "K4": (seed, att.dropout_threshold(rate), 1.0 / (1.0 - rate))}
        want = {"K3": att.composed_attention(q, k, v, bias, scale),
                "K4": att.composed_attention_dropout(q, k, v, bias, seed, scale, rate)}
        outs = {who: torch.empty_like(q) for who in ("this", "other")}
        stats = torch.empty((2, B * H, S), device=device)
        bits = torch.empty(att.keep_bits_shape(B, H, S, S), dtype=torch.int32, device=device)
        qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr())
        split = (att.fp32_split_keys(S),) if split_arg else ()
        for name in ("K3", "K4"):
            fn, none = old[name]
            for train in (False, True):
                keep = ((stats.data_ptr(),) + ((bits.data_ptr(),) if name == "K4" else ())
                        if train else (None,) * (1 + (name == "K4")))
                calls = {"this": lambda name=name, keep=keep: new[name](
                             *qkv, outs["this"].data_ptr(), *keep, B, H, S, S, D, scale,
                             *drop[name], stream),
                         "other": lambda name=name, fn=fn, none=none: fn(
                             *qkv, outs["other"].data_ptr(), *none, B, H, S, S, D, *split,
                             scale, *drop[name], stream)}

                def check(who, name=name):
                    err = float((outs[who] - want[name]).abs().max())
                    if not err <= chip_smoke.K3_TOL:
                        raise AssertionError(f"{name} fp32 ({who}) disagrees with its plain "
                                             f"version at Lq=Lk={S}: {err:.3e}")

                label = "attention_fwd" if name == "K3" else "attention_fwd_dropout"
                in_turns(f"{label} fp32 B={B} H={H} Lq=Lk={S} D={D}"
                         f"{f' p={rate}' if name == 'K4' else ''} (this: the many-query "
                         f"forward{', as a training call runs it' if train else ''}; other: "
                         f"{other_body})", calls, check, result)
        del want
        want_b = att.composed_attention_bwd(q, k, v, bias, seed, scale, rate, g, False)[:3]
        grads = {who: tuple(torch.empty_like(t) for t in (q, k, v)) for who in outs}
        delta = torch.empty((B * H, S), device=device)
        new_bwd = att.BWD_KERNEL_MANY.load()
        calls = {"this": lambda: new_bwd(
                     *qkv, g.data_ptr(), stats.data_ptr(), bits.data_ptr(), delta.data_ptr(),
                     *(t.data_ptr() for t in grads["this"]), None, B, H, S, S, D, scale, 1,
                     1.0 / (1.0 - rate), stream),
                 "other": lambda: old_bwd(
                     *qkv, g.data_ptr(), *(t.data_ptr() for t in grads["other"]), None, B, H,
                     S, S, D, att.fp32_split_keys(S), scale, 1, *drop["K4"], stream)}
        tol = chip_smoke.K3_TOL if S <= 512 else chip_smoke.SELF32_BWD_TOL

        def check_bwd(who):
            rel = chip_smoke.errs(grads[who], want_b)[1]
            if not rel <= tol:
                raise AssertionError(f"K5 fp32 ({who}) disagrees with its plain version at "
                                     f"Lq=Lk={S}: {rel:.3e}")

        in_turns(f"attention_bwd fp32 B={B} H={H} Lq=Lk={S} D={D} p={rate} (this: the "
                 "many-query backward; other: its cluster body)", calls, check_bwd, result)
        del want_b, grads, outs
        torch.cuda.empty_cache()


def cross_attention_bwd(checkout, device, gen, stream, result, B=8, Lq=20, S=3100, C=512, H=8):
    import torch

    from r3d_tpu_torch.ops import cross_attention as ca

    D = C // H
    scale = 1.0 / math.sqrt(D)
    q, k, v, bias = chip_smoke.cross_inputs(B, Lq, S, C, gen, device, torch.bfloat16)
    g = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 0, scale, 0.0, H)
    want = ca.composed_cross_attention_bwd(q, k, v, bias, 0, scale, 0.0, H, g, out, m, l, False)
    split_keys = ca.bwd_split_keys(
        S, B * H, torch.cuda.get_device_properties(device).multi_processor_count)
    n_blocks = -(-S // ca.BWD_TILE_KEYS)
    split_side = (split_keys, ca.bwd_scratch_shape(S, B, Lq, C, H, split_keys, False))
    other = bind(other_library(checkout, "cross_attention_bwd.cu"), ca.BWD_KERNEL)
    sides = {"this": (ca.BWD_KERNEL.load(), *split_side),
             "other": (other, *(split_side if has(checkout, "cross_attention_bwd.cu",
                                                  "cross_bwd_bf16_kernel")
                                else (n_blocks, (n_blocks * B * Lq * C,))))}
    grads = {}
    calls = {}
    for who, (fn, keys_arg, part_shape) in sides.items():
        part = torch.empty(part_shape, device=device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        grads[who] = (dq, dk, dv)
        calls[who] = (lambda fn=fn, part=part, dq=dq, dk=dk, dv=dv, keys_arg=keys_arg: fn(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), None, B, Lq, S, H, D, keys_arg, scale, 0, 0, 0, 1.0,
            stream))

    def check(who):
        rel = chip_smoke.errs(grads[who], want[:3])[1]
        if not rel <= chip_smoke.BF16_TOL:
            raise AssertionError(f"K7 bf16 ({who}) disagrees with its plain version: {rel:.3e}")

    in_turns(f"cross_attention_bwd bf16 B={B} Lq={Lq} S={S} C={C} H={H}", calls, check, result)


def cross_attention_fp32(checkout, device, gen, stream, result, B=8, Lq=8, C=128, H=8):
    """fp32 K6 (rate 0) and K7 (rate 0 and 0.1) at the utkinects 1024 and
    2000 buckets' shape under R3D_CROSS_NATIVE=1."""
    import torch

    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca

    D = C // H
    scale = 1.0 / math.sqrt(D)
    first_bwd = has(checkout, "cross_attention_bwd.cu", "dq_reduce_kernel")   # split 64, a dq scratch
    fwd = {"this": ca.FWD_KERNEL.load(),
           "other": bind(other_library(checkout, "cross_attention.cu"), ca.FWD_KERNEL)}
    bwd = {"this": ca.BWD_KERNEL.load(),
           "other": bind(other_library(checkout, "cross_attention_bwd.cu"), ca.BWD_KERNEL)}
    for S in (1024, 2000):
        q, k, v, bias = chip_smoke.cross_inputs(B, Lq, S, C, gen, device, torch.float32)
        g = torch.randn(q.shape, generator=gen).to(device)
        want = ca.composed_cross_attention(q, k, v, bias, 0, scale, 0.0, H)
        outs = {who: (torch.empty_like(q), torch.empty_like(want[1]), torch.empty_like(want[2]))
                for who in fwd}
        split = att.fp32_split_keys(S)   # the first body ignores it
        calls = {who: (lambda fn=fn, o=outs[who]: fn(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), *(t.data_ptr() for t in o),
            None, split, B, Lq, S, H, D, scale, 0, 0, 0, 1.0, stream)) for who, fn in fwd.items()}

        def check(who):
            err = chip_smoke.errs(outs[who], want)[1]
            if not err <= chip_smoke.CROSS_FWD_TOL:
                raise AssertionError(f"K6 fp32 ({who}) disagrees with its plain version at "
                                     f"S={S}: {err:.3e}")

        in_turns(f"cross_attention_fwd fp32 B={B} Lq={Lq} S={S} C={C} H={H}", calls, check, result,
                 rounds=3)
        out, m, l = want
        for rate in (0.0, 0.1):
            seed, thr = 2000 + S, att.dropout_threshold(rate)
            want_b = ca.composed_cross_attention_bwd(q, k, v, bias, seed, scale, rate, H, g, out,
                                                     m, l, False)[:3]
            grads, calls = {}, {}
            for who, fn in bwd.items():
                old = who == "other" and first_bwd
                keys = ca.BWD_TILE_KEYS if old else att.fp32_split_keys(S)
                part = torch.empty(-(-S // keys) * B * Lq * C, device=device) if old else None
                grads[who] = tuple(torch.empty_like(t) for t in (q, k, v))
                calls[who] = (lambda fn=fn, part=part, gr=grads[who], keys=keys: fn(
                    0, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
                    out.data_ptr(), m.data_ptr(), l.data_ptr(),
                    None if part is None else part.data_ptr(), *(t.data_ptr() for t in gr), None,
                    B, Lq, S, H, D, keys, scale, int(rate > 0), seed, thr, 1.0 / (1.0 - rate),
                    stream))

            def check_bwd(who):
                rel = chip_smoke.errs(grads[who], want_b)[1]
                if not rel <= chip_smoke.CROSS_BWD_TOL:
                    raise AssertionError(f"K7 fp32 ({who}) disagrees with its plain version at "
                                         f"S={S} rate={rate}: {rel:.3e}")

            in_turns(f"cross_attention_bwd fp32 B={B} Lq={Lq} S={S} C={C} H={H} p={rate}", calls,
                     check_bwd, result, rounds=3)


# One encoder train step at the 2000 bucket (``futr_fusion_bn`` with
# ``use_encoder=True`` at the utkinects widths, the seeded init, the
# encoder fit's videos), epoch 0 and sticky, through ``chip_smoke.train_breakdown``
# of the checkout it runs in: only what both checkouts have.
ENCODER_STEP = """
import dataclasses
import torch
import chip_smoke as c
from r3d_tpu_torch.config import get_config
from r3d_tpu_torch.models import build_model, init_weights
torch.backends.cuda.matmul.allow_tf32 = False
base = get_config("utkinects")
cfg = base.replace(model=dataclasses.replace(base.model, use_encoder=True))
model = init_weights(build_model(cfg.model, c.N_CLASS, cfg.data.depth_shape),
                     torch.Generator().manual_seed(c.SEED))
c.train_breakdown(cfg, model.state_dict(), c.train_loaders(cfg, **c.ENCODER_FIT)[1],
                  min_len=1024, label=" (encoder, 2000)")
"""
STEP_LINE = re.compile(r"train step \(encoder, 2000\) \((.*?)\), bucket (\d+): .* median "
                       r"([\d.]+) ms .* card busy ([\d.]+) ms in (\d+) kernel launches")


def encoder_steps(checkout, result):
    """``ENCODER_STEP`` in a process of its own in each checkout (each builds
    its kernels there at first use), other, this, this, other: each turn's
    median step ms, card-busy ms and launches, epoch 0 and sticky."""
    here = Path(__file__).resolve().parent
    runs = {"this": [], "other": []}
    for who in ("other", "this", "this", "other"):
        root = here if who == "this" else checkout.resolve()
        done = subprocess.run([sys.executable, "-c", ENCODER_STEP], cwd=root, text=True,
                              capture_output=True, env={**os.environ, "PYTHONPATH": str(root)})
        if done.returncode != 0:
            raise RuntimeError(f"encoder step ({who}) failed:\n{done.stdout[-3000:]}"
                               f"{done.stderr[-3000:]}")
        steps = {m[0]: (float(m[2]), float(m[3]), int(m[4]))
                 for m in STEP_LINE.findall(done.stdout)}
        if len(steps) != 2:
            raise RuntimeError(f"encoder step ({who}): no step lines in\n{done.stdout[-3000:]}")
        runs[who].append(steps)
        print(f"encoder 2000 step ({who}): " + "; ".join(
            f"{mode}: median {ms:.2f} ms, card busy {busy:.2f} ms in {n} launches"
            for mode, (ms, busy, n) in steps.items()))
    result["encoder 2000 step"] = runs


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) != 2 else "kernel_ab: CUDA is not available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    checkout = Path(sys.argv[1])
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    attention_bf16_many(checkout, device, gen, stream, result)
    attention_fp32(checkout, device, gen, stream, result)
    attention_fp32_many(checkout, device, gen, stream, result)
    fuser_tail_bwd(checkout, device, gen, stream, result)
    fuser_tail(other_library(checkout, "fuser_tail.cu"), device, gen, stream, result)
    cross_attention_bwd(checkout, device, gen, stream, result)
    cross_attention_fp32(checkout, device, gen, stream, result)
    encoder_steps(checkout, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
