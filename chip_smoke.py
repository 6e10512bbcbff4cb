"""Drive the PyTorch port on one NVIDIA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA host

Phases, each of which fails the run (non-zero exit) if it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``r3d_tpu_torch/csrc`` (one nvcc per source,
   all in parallel) and print what ptxas says of each;
3. hold each kernel against its plain PyTorch version on the card, fp32
   with TF32 off, at the model's shapes: the fuser tail forward on both
   routes and its backward at N = 8*256, 8*512 and a ragged N (the no-blend
   route and the backward with the outer residual off and on); attention
   forward, dropout forward and backward (rate 0 and 0.1) at B = 8, H = 8,
   Lq = 8, D = 16, Lk = 256, 512 and a ragged 300 with a fully masked row.
   Time each at the 512-bucket shape: kernel, plain version, bound and,
   where one exists, one PyTorch library call as the yardstick;
4. serving: build an ``InferenceSession`` for ``utkinects`` at full width
   (n_class 17, max_batch 8) from the port's seeded init, set every launch
   count to 0, answer requests through ``ServingQueue`` in the 256, 512 and
   1024 buckets, read the counts, and check shapes, finite outputs and that
   the serving kernels were launched; time the parts of one 512-bucket
   chunk, and compare the card's logits with the same session on the CPU;
5. training: build a ``Trainer`` for ``utkinects`` at full width from the
   same init, set every count to 0, ``fit`` 2 epochs of 3 batch-8 steps of
   synthetic videos of the utkinects layout (256 and 512 buckets) with
   validation, read the counts per epoch: epoch 0 (train mode, dropout 0.1)
   must launch the no-blend tail, its backward, the dropout attention and
   the attention backward; epoch 1 (sticky eval) the blend tail, attention
   and the attention backward. Then one dropout-off train step from the
   same weights and batch on the card and on the CPU (loss, every
   gradient, BN statistics), and the parts of one train step;
6. print per-bucket request latency, one ``{"kernels": [...]}`` line and, as
   the last line, ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero and prints no result where CUDA is
missing or the port is not importable.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_CLASS = 17            # UTKinect: 16 L2 actions + NONE
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, SXM, 700 W
K1_TOL = 1e-4            # fp32 on both sides; sums of up to 512 terms in another order
K2_TOL = 1e-4            # as K1, relative to each gradient's largest entry (row sums grow)
K3_TOL = 2e-5            # fp32; online vs two-pass softmax
E2E_TOL = 5e-2           # logits, card vs CPU: cuBLAS and the CPU may round a
                         # bf16 embed output to neighbouring bf16 values
GRAD_TOL = 2e-2          # a gradient, card vs CPU, over its largest entry: the bf16
                         # embeds as above; 6.2e-3 read on an H100, a margin of 3x
STAT_TOL = 2e-4          # BN running statistics after the step: 1.7e-5 read, a margin of 12x
# Gradients that are only rounding noise: softmax is invariant to a shift
# shared by all keys (k_proj.bias), and the duration head's bias feeds a
# normalisation over slots (fc_len.bias).
GRAD_NOISE_ONLY = ("k_proj.bias", "fc_len.bias")


def fuser_inputs(N, gen, device, C=128, Ch=512):
    """Random raw streams and fuser parameters of a realistic scale."""
    import torch

    from r3d_tpu_torch.models.fuser import bottomk_mask
    from r3d_tpu_torch.ops.fuser_kernel import BlendParams, FuserTailParams

    def f(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    gamma_r, gamma_d = torch.randn(C, generator=gen), torch.randn(C, generator=gen)
    blend = BlendParams(
        scale_r=f(C, scale=0.3, shift=1.0), shift_r=f(C, scale=0.3),
        scale_d=f(C, scale=0.3, shift=1.0), shift_d=f(C, scale=0.3),
        mask_r=bottomk_mask(gamma_r.abs(), C // 10).float().to(device),
        mask_d=bottomk_mask(gamma_d.abs(), C // 10).float().to(device),
        alpha=torch.rand(C, generator=gen).to(device),
    )
    params = FuserTailParams(
        norm1_scale=f(C, scale=0.1, shift=1.0), norm1_bias=f(C, scale=0.1),
        wvp=f(C, C, scale=C ** -0.5), proj_bias=f(C, scale=0.1),
        norm2_scale=f(C, scale=0.1, shift=1.0), norm2_bias=f(C, scale=0.1),
        mlp1_weight=f(Ch, C, scale=C ** -0.5), mlp1_bias=f(Ch, scale=0.1),
        mlp2_weight=f(C, Ch, scale=Ch ** -0.5), mlp2_bias=f(C, scale=0.1),
        norm_out_scale=f(C, scale=0.1, shift=1.0), norm_out_bias=f(C, scale=0.1),
    )
    return f(N, C), f(N, C), blend, params


def attention_inputs(B, H, Lq, Lk, D, gen, device, all_masked_row=False):
    """Random q, k, v and a key-padding bias: row b keeps a random length
    (key 0 always), optionally one row with every key masked."""
    import torch

    from r3d_tpu_torch.models.layers import attention_bias_from_padding

    q, k, v = (torch.randn(B, H, L, D, generator=gen).to(device) for L in (Lq, Lk, Lk))
    lengths = torch.randint(1, Lk + 1, (B,), generator=gen)
    lengths[0] = Lk
    pad = torch.arange(Lk)[None, :] >= lengths[:, None]
    if all_masked_row:
        pad[-1] = True
    return q, k, v, attention_bias_from_padding(pad.to(device))


def fuser_bound_ms(N, C=128, Ch=512, with_blend=True):
    """Least time: bytes (streams in and out once, the tail's parameters
    once, with 8 [C] vectors, and the blend's 7 [C] vectors on its route)
    over HBM rate, or fp32 flops of the three products over the CUDA-core
    rate."""
    n_bytes = 4 * (3 * N * C + C * C + 2 * C * Ch + Ch + (15 if with_blend else 8) * C)
    flops = N * 2 * (2 * C * C + 4 * C * Ch)
    return _bound(n_bytes, flops)


def fuser_bwd_bound_ms(N, C=128, Ch=512):
    """Streams r, d, g in and dr, dd out once, parameters in and their
    gradients out once; about 6 * N * (2*C*C + 4*C*Ch) flops (forward
    recomputed, the backward's products)."""
    n_params = C * C + 2 * C * Ch + Ch + 8 * C
    return _bound(4 * (5 * N * C + 2 * n_params), 6 * N * (2 * C * C + 4 * C * Ch))


def attention_bound_ms(B, H, Lq, Lk, D):
    n_bytes = 4 * (2 * B * H * Lq * D + 2 * B * H * Lk * D + B * Lk)
    flops = 4 * B * H * Lq * Lk * D
    return _bound(n_bytes, flops)


def attention_bwd_bound_ms(B, H, Lq, Lk, D):
    """q, g, k, v, bias in and dq, dk, dv out once (the kernel recomputes
    rowsum(g * out) and reads no ``out``; no dbias on the path); the
    backward's five [Lq, Lk, D] products."""
    n_bytes = 4 * (3 * B * H * Lq * D + 4 * B * H * Lk * D + B * Lk)
    return _bound(n_bytes, 10 * B * H * Lq * Lk * D)


def _bound(n_bytes, flops):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters=50, warmup=3):
    """Device time per call: CUDA events around ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name, iters=20):
    """Device time per launch of the kernels whose name holds ``name``,
    from a torch.profiler trace of ``iters`` calls; None where the profiler
    sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key]
    total_us = sum(getattr(e, "device_time_total", 0.0) for e in events)
    count = sum(e.count for e in events)
    return total_us / count / 1e3 if count and total_us > 0 else None


def raw_launcher(kernel, *args):
    """The kernel's C launcher with its arguments bound, for timing without
    the wrapper's checks (and without counting)."""
    fn = kernel.load()
    return lambda: fn(*args)


def check_fuser_kernel(gen, device):
    import torch

    from r3d_tpu_torch.ops import fuser_kernel as fk

    worst, timing = 0.0, None
    for N in (8 * 256, 8 * 512, 8 * 256 + 5):
        r, d, blend, params = fuser_inputs(N, gen, device)
        got = fk.fused_bn_blend_tail(r, d, blend, params)
        want = fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"fused_bn_blend_tail N={N}: max|kernel - plain| = {err:.3e} (tol {K1_TOL})")
        if not (err <= K1_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"fused_bn_blend_tail disagrees with its plain version at N={N}")
        worst = max(worst, err)
        if N == 8 * 512:   # the 512-bucket chunk of the serving path
            out = torch.empty_like(r)
            stream = torch.cuda.current_stream().cuda_stream
            launch = raw_launcher(fk.KERNEL, r.data_ptr(), d.data_ptr(),
                                  *(t.data_ptr() for t in blend),
                                  *(t.data_ptr() for t in params), out.data_ptr(),
                                  N, 128, 512, 0, stream)
            plain = lambda: fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params)
            bound, bound_by = fuser_bound_ms(N)
            timing = {"shape": f"N={N} C=128 Ch=512", "ms": time_ms(launch),
                      "device_ms": device_ms(launch, "fused_tail_kernel<true"),
                      "plain_ms": time_ms(plain), "library_ms": None,
                      "bound_ms": bound, "bound_by": bound_by}
    return worst, timing


def errs(got, want):
    """(max|got - want|, the same over max(1, max|want|)) over tensor pairs."""
    a = r = 0.0
    for x, y in zip(got, want):
        e = float((x - y).abs().max())
        a, r = max(a, e), max(r, e / max(1.0, float(y.abs().max())))
    return a, r


def check_tail_kernels(gen, device):
    """K1's no-blend route and K2 (the fuser-tail backward)."""
    import torch

    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    worst_fwd = 0.0
    worst_bwd = (0.0, 0.0)
    t_fwd = t_bwd = None
    for N in (8 * 256, 8 * 512, 8 * 256 + 5):
        r, d, _, params = fuser_inputs(N, gen, device)
        g = torch.randn(N, 128, generator=gen).to(device)
        for outer in (False, True):
            got = fk.fused_safuser_tail(r, d, params, outer)
            want = fk.composed_tail(r, d, params, outer)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            print(f"fused_safuser_tail N={N} outer_residual={outer}: "
                  f"max|kernel - plain| = {err:.3e} (tol {K1_TOL})")
            if not (err <= K1_TOL and torch.isfinite(got).all()):
                raise AssertionError(f"fused_safuser_tail disagrees at N={N}")
            worst_fwd = max(worst_fwd, err)
            got = fkb.fused_tail_bwd(r, d, g, params, outer)
            want = fkb.composed_tail_bwd(r, d, g, params, outer)
            torch.cuda.synchronize()
            ea, er = errs((got[0], got[1], *got[2]), (want[0], want[1], *want[2]))
            print(f"fused_tail_bwd N={N} outer_residual={outer}: over dr, dd and 12 "
                  f"gradients max|kernel - plain| = {ea:.3e}, relative {er:.3e} (tol {K2_TOL})")
            if not er <= K2_TOL:
                raise AssertionError(f"fused_tail_bwd disagrees at N={N}")
            worst_bwd = (max(worst_bwd[0], ea), max(worst_bwd[1], er))
        if N == 8 * 512:
            stream = torch.cuda.current_stream().cuda_stream
            out = torch.empty_like(r)
            launch = raw_launcher(fk.TAIL_KERNEL, r.data_ptr(), d.data_ptr(),
                                  *(t.data_ptr() for t in params), out.data_ptr(),
                                  N, 128, 512, 0, stream)
            bound, bound_by = fuser_bound_ms(N, with_blend=False)
            t_fwd = {"shape": f"N={N} C=128 Ch=512", "ms": time_ms(launch),
                     "device_ms": device_ms(launch, "fused_tail_kernel<false"),
                     "plain_ms": time_ms(lambda: fk.composed_tail(r, d, params)),
                     "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
            layout, P = fkb.grad_layout(128, 512)
            blocks = max(1, min(-(-N // fkb.TILE_ROWS),
                                torch.cuda.get_device_properties(device).multi_processor_count))
            dr, dd = torch.empty_like(r), torch.empty_like(d)
            partial = torch.empty(blocks * P, device=device)
            flat = torch.empty(P, device=device)
            launch = raw_launcher(fkb.KERNEL, r.data_ptr(), d.data_ptr(), g.data_ptr(),
                                  *(t.data_ptr() for t in params), dr.data_ptr(),
                                  dd.data_ptr(), partial.data_ptr(), flat.data_ptr(),
                                  N, 128, 512, blocks, 0, stream)
            bound, bound_by = fuser_bwd_bound_ms(N)
            t_bwd = {"shape": f"N={N} C=128 Ch=512", "ms": time_ms(launch, iters=20),
                     "device_ms": device_ms(launch, "fuser_tail_bwd_kernel"),
                     "plain_ms": time_ms(lambda: fkb.composed_tail_bwd(r, d, g, params, False),
                                         iters=20),
                     "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
    return (worst_fwd, t_fwd), (worst_bwd, t_bwd)


def check_attention_train_kernels(gen, device):
    """K4 (dropout forward) and K5 (backward, rate 0 and 0.1)."""
    import torch
    import torch.nn.functional as F

    from r3d_tpu_torch.ops import attention as att

    B, H, Lq, D, rate = 8, 8, 8, 16, 0.1
    scale = 1.0 / math.sqrt(D)
    worst4 = 0.0
    worst5 = (0.0, 0.0)
    t4 = t5 = None
    for Lk, all_masked in ((256, False), (512, False), (300, True)):
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device, all_masked)
        g = torch.randn(q.shape, generator=gen).to(device)
        seed = 1000 + Lk
        got = att.flash_attention_dropout(q, k, v, bias, seed, scale, rate)
        want = att.composed_attention_dropout(q, k, v, bias, seed, scale, rate)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        kept = float((att.dropout_keep(seed, rate, (B, H, Lq, Lk), device) > 0).float().mean())
        print(f"flash_attention_dropout Lk={Lk}{' (one row fully masked)' if all_masked else ''}:"
              f" max|kernel - plain| = {err:.3e} (tol {K3_TOL}), keep rate {kept:.4f}")
        if not (err <= K3_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention_dropout disagrees at Lk={Lk}")
        worst4 = max(worst4, err)
        for r_ in (0.0, rate):
            got = att.attention_bwd(q, k, v, bias, seed, scale, r_, g, need_dbias=True)
            want = att.composed_attention_bwd(q, k, v, bias, seed, scale, r_, g)
            torch.cuda.synchronize()
            ea, er = errs(got, want)
            print(f"attention_bwd Lk={Lk} rate={r_}: over dq, dk, dv, dbias "
                  f"max|kernel - plain| = {ea:.3e}, relative {er:.3e} (tol {K3_TOL})")
            if not er <= K3_TOL:
                raise AssertionError(f"attention_bwd disagrees at Lk={Lk}, rate={r_}")
            worst5 = (max(worst5[0], ea), max(worst5[1], er))
        if Lk == 512:
            stream = torch.cuda.current_stream().cuda_stream
            out = torch.empty_like(q)
            launch = raw_launcher(att.DROPOUT_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), B, H, Lq, Lk, D, scale,
                                  seed, att.dropout_threshold(rate), 1.0 / (1.0 - rate), stream)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                             dropout_p=rate, scale=scale)
            bound, bound_by = attention_bound_ms(B, H, Lq, Lk, D)
            t4 = {"shape": f"B={B} H={H} Lq={Lq} Lk={Lk} D={D} p={rate}", "ms": time_ms(launch),
                  "device_ms": device_ms(launch, "attention_fwd_kernel<16, true"),
                  "plain_ms": time_ms(lambda: att.composed_attention_dropout(
                      q, k, v, bias, seed, scale, rate)),
                  "library_ms": time_ms(library), "bound_ms": bound, "bound_by": bound_by}
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            launch = raw_launcher(att.BWD_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(), None, B, H, Lq, Lk, D, scale, 1, seed,
                                  att.dropout_threshold(rate), 1.0 / (1.0 - rate), stream)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]

            def library_bwd():
                o = F.scaled_dot_product_attention(*leaves, attn_mask=bias, dropout_p=rate,
                                                   scale=scale)
                torch.autograd.grad(o, leaves, g)

            bound, bound_by = attention_bwd_bound_ms(B, H, Lq, Lk, D)
            t5 = {"shape": f"B={B} H={H} Lq={Lq} Lk={Lk} D={D} p={rate}", "ms": time_ms(launch),
                  "device_ms": device_ms(launch, "attention_bwd_kernel"),
                  "plain_ms": time_ms(lambda: att.composed_attention_bwd(
                      q, k, v, bias, seed, scale, rate, g, False)),
                  "library_ms": time_ms(library_bwd), "bound_ms": bound, "bound_by": bound_by}
    return (worst4, t4), (worst5, t5)


def check_attention_kernel(gen, device):
    import torch
    import torch.nn.functional as F

    from r3d_tpu_torch.ops import attention as att

    B, H, Lq, D = 8, 8, 8, 16
    scale = 1.0 / math.sqrt(D)
    worst, timing = 0.0, None
    for Lk, all_masked in ((256, False), (512, False), (300, True)):
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device, all_masked)
        got = att.flash_attention(q, k, v, bias, scale)
        want = att.composed_attention(q, k, v, bias, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"flash_attention B={B} H={H} Lq={Lq} Lk={Lk} D={D}"
              f"{' (one row fully masked)' if all_masked else ''}: "
              f"max|kernel - plain| = {err:.3e} (tol {K3_TOL})")
        if not (err <= K3_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention disagrees with its plain version at Lk={Lk}")
        worst = max(worst, err)
        if Lk == 512:   # the 512-bucket cross-attention of the serving path
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            launch = raw_launcher(att.KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), B, H, Lq, Lk, D,
                                  scale, stream)
            plain = lambda: att.composed_attention(q, k, v, bias, scale)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                             scale=scale)
            lib_err = float((library() - want).abs().max())
            print(f"  scaled_dot_product_attention (yardstick only): max|lib - plain| = {lib_err:.3e}")
            bound, bound_by = attention_bound_ms(B, H, Lq, Lk, D)
            timing = {"shape": f"B={B} H={H} Lq={Lq} Lk={Lk} D={D}", "ms": time_ms(launch),
                      "device_ms": device_ms(launch, "attention_fwd_kernel"),
                      "plain_ms": time_ms(plain), "library_ms": time_ms(library),
                      "bound_ms": bound, "bound_by": bound_by}
    # the routing question (PERF.md): wrapper call vs plain call, as the
    # decoder's cross-attention would pay them, on both sides of the TPU's
    # [256, 512] window
    for Lk in (128, 256, 512, 1024, 2000):
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device)
        t_k = time_ms(lambda: att.flash_attention(q, k, v, bias, scale))
        t_p = time_ms(lambda: att.composed_attention(q, k, v, bias, scale))
        print(f"routing A/B Lq={Lq} Lk={Lk}: kernel wrapper {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, plain/kernel {t_p / t_k:.2f}")
    return worst, timing


def make_videos(rng, lengths, cfg):
    D = cfg.model.input_dim
    return [{"features": rng.standard_normal((n, D), dtype=np.float32),
             "depth": rng.random((n,) + tuple(cfg.data.depth_shape), dtype=np.float32)}
            for n in lengths]


def serve(session, kernels, cfg, rng):
    """Answer requests through ServingQueue, bucket by bucket, with every
    launch count set to 0 first. Returns per-bucket latencies and counts."""
    import torch

    from r3d_tpu_torch.serving import ServingQueue

    groups = {256: (200, 256, 131, 240, 199, 250, 180, 222),
              512: (400, 512, 300, 480, 257, 350, 444, 500),
              1024: (900, 700)}
    videos = {S: make_videos(rng, lens, cfg) for S, lens in groups.items()}
    # warm-up at the same chunk shapes: cuBLAS plans, the device allocator
    # and the pinned host buffers (the first pinned 157 MB costs ~70 ms)
    for S, vids in videos.items():
        session.anticipate_batch(vids)
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    latencies = {}
    q = ServingQueue(session, max_wait_ms=20)
    try:
        for S, vids in videos.items():
            t0 = time.perf_counter()
            futs = [q.submit(v["features"], v["depth"]) for v in vids]
            done = []
            for v, f in zip(vids, futs):
                res = f.result(timeout=600)
                done.append(time.perf_counter() - t0)
                n = v["features"].shape[0]
                shapes = {"transcript": (cfg.model.n_query,), "durations": (cfg.model.n_query,),
                          "future_frames": (n,), "seg": (n,)}
                for key, shape in shapes.items():
                    if res[key].shape != shape or not np.all(np.isfinite(res[key])):
                        raise AssertionError(f"bucket {S}: {key} has shape "
                                             f"{res[key].shape} (want {shape}) or is not finite")
            latencies[S] = {"requests": len(vids), "p50_ms": 1e3 * float(np.median(done)),
                            "max_ms": 1e3 * max(done)}
    finally:
        q.close()
    counts = {k.name: k.launches for k in kernels}
    return latencies, counts


def breakdown(session, cfg, rng, S=512):
    """Where one full chunk of 8 requests of bucket S spends its time: host
    collate, then copy + forward to a synchronised result, and the card's
    busy time in that forward from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    vids = make_videos(rng, (S,) * 8, cfg)
    t0 = time.perf_counter()
    batch = session._collate(vids, S)
    t1 = time.perf_counter()
    session._run(*batch)["action"].cpu()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        session._run(*batch)["action"].cpu()
    t3 = time.perf_counter()
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    events = sorted(on_card, key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"bucket {S} chunk of 8: collate {1e3 * (t1 - t0):.2f} ms, copy + forward "
          f"{1e3 * (t2 - t1):.2f} ms (profiled {1e3 * (t3 - t2):.2f} ms, card busy "
          f"{busy_ms:.2f} ms)")
    for e in events[:6]:
        print(f"  {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}")


def compare_with_cpu(session, cfg, state_dict, rng):
    """The card's logits for one 256-bucket chunk vs the same session on the CPU."""
    import torch

    from r3d_tpu_torch.serving import InferenceSession

    vids = make_videos(rng, (256, 200, 129, 250, 177, 240, 210, 255), cfg)
    feats, depth, mask = session._collate(vids, 256)
    got = {k: v.float().cpu() for k, v in session._run(feats, depth, mask).items()}
    cpu = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8, device="cpu")
    want = cpu._run(feats, depth, mask)
    worst = 0.0
    for key in ("action", "duration", "seg"):
        if not torch.isfinite(got[key]).all():
            raise AssertionError(f"non-finite {key} on the card")
        err = float((got[key] - want[key]).abs().max())
        print(f"card vs CPU, 256-bucket chunk of 8: max|{key}| diff = {err:.3e} (tol {E2E_TOL})")
        worst = max(worst, err)
    agree = float((got["action"].argmax(-1) == want["action"].argmax(-1)).float().mean())
    print(f"card vs CPU: transcript argmax agreement {agree:.4f}")
    if worst > E2E_TOL:
        raise AssertionError("the card's outputs disagree with the CPU run")
    return worst


def train_loaders(cfg, rng_seed=SEED):
    """Synthetic videos of the utkinects layout (2,048-d features, 160x120
    depth frames, 16 actions + NONE) whose observed windows land in the 256
    and 512 buckets: 12 training videos at 2 observation ratios (3 batches
    of 8, grouped by bucket) and 8 validation videos at one."""
    from r3d_tpu_torch.data.pipeline import BucketedLoader
    from r3d_tpu_torch.data.synthetic import SyntheticSource

    def loader(n_videos, obs, seed, shuffle):
        src = SyntheticSource(n_videos=n_videos, n_actions=N_CLASS - 1,
                              vid_len_range=(600, 1000), input_dim=cfg.model.input_dim,
                              depth_shape=tuple(cfg.data.depth_shape), seed=seed)
        fn, n = src.make_example_fn(obs, 1, cfg.model.n_query)
        lengths = [int(o * len(src.videos[v]["labels"])) for v, o in src.example_table(obs)]
        return src, BucketedLoader(
            num_examples=n, make_example_fn=fn, batch_size=8, pad_idx=src.pad_idx,
            buckets=cfg.data.seq_buckets, n_query=cfg.model.n_query, with_depth=True,
            shuffle=shuffle, seed=seed, example_lengths=lengths,
            feature_dtype=cfg.data.feature_dtype)

    src, train = loader(12, (0.3, 0.5), rng_seed, True)
    _, val = loader(8, (0.4,), rng_seed + 1, False)
    return src, train, val


def train(cfg, state_dict, kernels):
    """fit 2 epochs on the card with every launch count set to 0 first;
    returns the launches of each epoch's training and validation."""
    import dataclasses

    import torch

    from r3d_tpu_torch.train.loop import Trainer

    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2))
    _, train_loader, val_loader = train_loaders(cfg)
    trainer = Trainer(cfg, N_CLASS)
    state = trainer.init_state(len(train_loader), state_dict)
    snapshots, lines = [], []

    def log(line):
        torch.cuda.synchronize()
        snapshots.append({k.name: k.launches for k in kernels})
        lines.append(line)
        print(f"  {line}")

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    trainer.fit(state, train_loader, val_loader, seed=SEED, log=log)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    phases = ["epoch 0 train", "epoch 0 validation", "epoch 1 train", "epoch 1 validation"]
    per_phase, prev = {}, {k.name: 0 for k in kernels}
    for name, snap in zip(phases, snapshots):
        per_phase[name] = {k: snap[k] - prev[k] for k in snap}
        prev = snap
    for name, c in per_phase.items():
        print(f"launches in {name}: {c}")
    losses = [float(x) for line in lines for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
    print(f"fit: 2 epochs of {len(train_loader)} steps with validation in {dt:.2f} s; "
          f"train and validation losses {losses}")
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss of the fit is not finite: {lines}")
    want = {"epoch 0 train": ("fused_safuser_tail", "fused_tail_bwd",
                              "flash_attention_dropout", "attention_bwd"),
            "epoch 1 train": ("fused_bn_blend_tail", "flash_attention", "attention_bwd")}
    for phase, names in want.items():
        missing = [n for n in names if per_phase[phase][n] == 0]
        if missing:
            raise AssertionError(f"{phase} never launched {missing}")
    return counts, trainer, state, train_loader


def train_step_on_card_and_cpu(cfg, state_dict, train_loader):
    """One dropout-off train step at lr 1e-3 (warmup 0) from the same
    weights and batch on the card and on the CPU: the loss, every gradient
    before the update (relative to its largest entry), and the BN running
    statistics after it."""
    import dataclasses

    import torch

    from r3d_tpu_torch.train.loop import Trainer

    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=0.0, fuser_dropout=0.0),
        train=dataclasses.replace(cfg.train, warmup_epochs=0))
    batch = min(train_loader, key=lambda b: b["features"].shape[1])
    out = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, N_CLASS, device=device)
        state = trainer.init_state(len(train_loader), state_dict)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        metrics = trainer._grad_core(state.model, trainer.to_device(batch))
        grads = {k: p.grad.float().cpu() for k, p in state.model.named_parameters()
                 if p.grad is not None}
        state.apply_gradients()
        stats = {k: v.float().cpu() for k, v in state.model.state_dict().items()
                 if "running" in k}
        out[device] = (float(metrics["loss"]), grads, stats)
    (loss_c, g_c, st_c), (loss_h, g_h, st_h) = out["cuda"], out["cpu"]
    if g_c.keys() != g_h.keys():
        raise AssertionError("the card and the CPU gave gradients to different parameters")
    rel = {k: float((g_c[k] - g_h[k]).abs().max()) / max(float(g_h[k].abs().max()), 1e-30)
           for k in g_h}
    gated = {k: e for k, e in rel.items() if not k.endswith(GRAD_NOISE_ONLY)}
    worst = max(gated, key=gated.get)
    stat_diff = max(float((st_c[k] - st_h[k]).abs().max()) for k in st_c)
    print(f"train step card vs CPU (dropout off, bucket {batch['features'].shape[1]}): loss "
          f"{loss_c:.6f} vs {loss_h:.6f} (tol {E2E_TOL}); over {len(gated)} gradients "
          f"max|card - CPU| / max|CPU| = {gated[worst]:.3e} in {worst} (tol {GRAD_TOL}; "
          f"not gated, rounding noise only: "
          + ", ".join(f"{k} {e:.2e}" for k, e in rel.items() if k not in gated)
          + f"); max|BN running stat diff| {stat_diff:.3e} (tol {STAT_TOL})")
    print("  per-gradient relative error, largest 8: "
          + ", ".join(f"{k} {e:.2e}" for k, e in sorted(gated.items(), key=lambda kv: -kv[1])[:8]))
    if not (abs(loss_c - loss_h) <= E2E_TOL and gated[worst] <= GRAD_TOL
            and stat_diff <= STAT_TOL):
        raise AssertionError("the card's train step disagrees with the CPU's")
    return abs(loss_c - loss_h)


def train_breakdown(trainer, state, train_loader):
    """Where one train step of a 512-bucket batch spends its time: host
    collate, H2D, forward + backward + optimizer to a synchronised end, and
    the card's busy time in that step from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from r3d_tpu_torch.data.pipeline import pad_batch

    loader = train_loader
    order = loader._order()
    examples = None
    for i in range(0, len(order), 8):
        ex = [loader.make_example_fn(int(j)) for j in order[i:i + 8]]
        if max(e.features.shape[0] for e in ex) > 256:
            examples = ex
            break
    t0 = time.perf_counter()
    batch = pad_batch(examples, loader.pad_idx, loader.buckets, loader.n_query, True,
                      loader.feature_dtype)
    t1 = time.perf_counter()
    dev = trainer.to_device(batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    S = batch["features"].shape[1]
    print(f"train batch, bucket {S} batch of 8: host collate {1e3 * (t1 - t0):.2f} ms, "
          f"H2D {1e3 * (t2 - t1):.2f} ms")

    def step(epoch):
        state.model.train(not trainer._sticky(epoch))
        state.optimizer.zero_grad(set_to_none=True)
        trainer._grad_core(state.model, dev)
        state.apply_gradients()

    for epoch, mode in ((0, "epoch 0, train mode, dropout 0.1"), (1, "sticky epoch")):
        for _ in range(2):   # warm
            step(epoch)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t3 = time.perf_counter()
            step(epoch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t3))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            step(epoch)
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        events = sorted(on_card, key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        launches = sum(e.count for e in on_card)
        print(f"train step ({mode}), bucket {S}: forward + backward + AdamW "
              f"median {float(np.median(times)):.2f} ms of 5 (min {min(times):.2f}), card busy "
              f"{busy_ms:.2f} ms in {launches} kernel launches (one profiled step)")
        for e in events[:8]:
            print(f"  {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    try:
        from r3d_tpu_torch.config import get_config
        from r3d_tpu_torch.models import build_model, init_weights
        from r3d_tpu_torch.ops import attention as att
        from r3d_tpu_torch.ops import build as kbuild
        from r3d_tpu_torch.ops import fuser_kernel as fk
        from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb
        from r3d_tpu_torch.serving import InferenceSession
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 1

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    kernels = [fk.KERNEL, fk.TAIL_KERNEL, fkb.KERNEL, att.KERNEL, att.DROPOUT_KERNEL,
               att.BWD_KERNEL]
    serving_kernels = [fk.KERNEL, att.KERNEL]
    t0 = time.perf_counter()
    kbuild.build_all(kernels)
    sources = sorted({k.source for k in kernels})
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s into {kbuild.build_dir()}")
    for source in sources:
        log = (kbuild.build_dir() / (source.rsplit('.', 1)[0] + ".log"))
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    k1_err, k1_time = check_fuser_kernel(gen, device)
    k3_err, k3_time = check_attention_kernel(gen, device)
    (k1t_err, k1t_time), (k2_err, k2_time) = check_tail_kernels(gen, device)
    (k4_err, k4_time), (k5_err, k5_time) = check_attention_train_kernels(gen, device)

    cfg = get_config("utkinects")
    model = init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                         torch.Generator().manual_seed(SEED))
    state_dict = model.state_dict()
    session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8)
    rng = np.random.default_rng(SEED)
    latencies, serving_counts = serve(session, kernels, cfg, rng)
    for S, lat in latencies.items():
        print(f"bucket {S}: {lat['requests']} requests through ServingQueue, "
              f"latency p50 {lat['p50_ms']:.2f} ms, max {lat['max_ms']:.2f} ms")
    print(f"launches on the serving path: {serving_counts}")
    missing = [k.name for k in serving_kernels if serving_counts[k.name] == 0]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    breakdown(session, cfg, rng)
    compare_with_cpu(session, cfg, state_dict, rng)
    del session

    counts, trainer, state, train_loader = train(cfg, state_dict, kernels)
    print(f"launches on the training path: {counts}")
    train_breakdown(trainer, state, train_loader)
    del trainer, state
    train_step_on_card_and_cpu(cfg, state_dict, train_loader)

    rows = []
    for k, err, t, replaces in (
        (fk.KERNEL, (k1_err, k1_err), k1_time, "r3d_tpu/ops/fuser_kernel.py:180"),
        (fk.TAIL_KERNEL, (k1t_err, k1t_err), k1t_time, "r3d_tpu/ops/fuser_kernel.py:180"),
        (fkb.KERNEL, k2_err, k2_time, "r3d_tpu/ops/fuser_kernel_bwd.py:70"),
        (att.KERNEL, (k3_err, k3_err), k3_time, "r3d_tpu/ops/attention.py:38"),
        (att.DROPOUT_KERNEL, (k4_err, k4_err), k4_time, "r3d_tpu/ops/attention.py:192"),
        (att.BWD_KERNEL, k5_err, k5_time, "r3d_tpu/ops/attention.py:215"),
    ):
        rows.append({
            "name": k.name, "route": "cuda", "source": f"r3d_tpu_torch/csrc/{k.source}",
            "replaces": replaces, "launches": counts[k.name],
            "serving_launches": serving_counts[k.name],
            "max_abs_err": err[0], "max_err": err[1], "shape": t["shape"],
            "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
