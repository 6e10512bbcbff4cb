"""Drive the PyTorch port on one NVIDIA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA host

Phases, each of which fails the run (non-zero exit) if it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``r3d_tpu_torch/csrc`` (one nvcc each, in
   parallel) and print what ptxas says of each;
3. hold each kernel against its plain PyTorch version on the card, at the
   serving shapes (fused_bn_blend_tail at N = 8*256, 8*512 and a ragged N;
   flash_attention at B = 8, H = 8, Lq = 8, D = 16, Lk = 256, 512 and a
   ragged 300, with real padding masks), fp32 with TF32 off, and time kernel,
   plain version and, for attention, one ``scaled_dot_product_attention``
   call as the yardstick;
4. build an ``InferenceSession`` for ``utkinects`` at full width (n_class
   17, max_batch 8) from the port's seeded init, set every launch count to
   0, answer requests through ``ServingQueue`` in the 256, 512 and 1024
   buckets, read the counts, and check shapes, finite outputs and that both
   kernels were launched;
5. time the parts of one 512-bucket chunk (host collate, copy + forward,
   the card's busy time from a profiler trace), and compare the card's
   logits for one 256-bucket chunk with the same session run on the CPU;
6. print per-bucket request latency, one ``{"kernels": [...]}`` line and, as
   the last line, ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero and prints no result where CUDA is
missing or the port is not importable.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_CLASS = 17            # UTKinect: 16 L2 actions + NONE
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, SXM, 700 W
K1_TOL = 1e-4            # fp32 on both sides; sums of up to 512 terms in another order
K3_TOL = 2e-5            # fp32; online vs two-pass softmax
E2E_TOL = 5e-2           # logits, card vs CPU: cuBLAS and the CPU may round a
                         # bf16 embed output to neighbouring bf16 values


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


def fuser_bound_ms(N, C=128, Ch=512):
    """Least time: bytes (streams in and out once, parameters once) over
    HBM rate, or fp32 flops of the three products over the CUDA-core rate."""
    n_bytes = 4 * (3 * N * C + C * C + 2 * C * Ch + Ch + 15 * C)
    flops = N * 2 * (2 * C * C + 4 * C * Ch)
    return _bound(n_bytes, flops)


def attention_bound_ms(B, H, Lq, Lk, D):
    n_bytes = 4 * (2 * B * H * Lq * D + 2 * B * H * Lk * D + B * Lk)
    flops = 4 * B * H * Lq * Lk * D
    return _bound(n_bytes, flops)


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
                                  N, 128, 512, stream)
            plain = lambda: fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params)
            bound, bound_by = fuser_bound_ms(N)
            timing = {"shape": f"N={N} C=128 Ch=512", "ms": time_ms(launch),
                      "device_ms": device_ms(launch, "fused_bn_blend_tail_kernel"),
                      "plain_ms": time_ms(plain), "library_ms": None,
                      "bound_ms": bound, "bound_by": bound_by}
    return worst, timing


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

    kernels = [fk.KERNEL, att.KERNEL]
    t0 = time.perf_counter()
    kbuild.build_all(kernels)
    print(f"built {[k.source for k in kernels]} in {time.perf_counter() - t0:.1f} s "
          f"into {kbuild.build_dir()}")
    for k in kernels:
        log = (kbuild.build_dir() / (k.source.rsplit('.', 1)[0] + ".log"))
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  {k.source}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    k1_err, k1_time = check_fuser_kernel(gen, device)
    k3_err, k3_time = check_attention_kernel(gen, device)

    cfg = get_config("utkinects")
    model = init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                         torch.Generator().manual_seed(SEED))
    state_dict = model.state_dict()
    session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8)
    rng = np.random.default_rng(SEED)
    latencies, counts = serve(session, kernels, cfg, rng)
    for S, lat in latencies.items():
        print(f"bucket {S}: {lat['requests']} requests through ServingQueue, "
              f"latency p50 {lat['p50_ms']:.2f} ms, max {lat['max_ms']:.2f} ms")
    print(f"launches on the serving path: {counts}")
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    breakdown(session, cfg, rng)
    compare_with_cpu(session, cfg, state_dict, rng)

    rows = []
    for k, err, t, replaces in (
        (fk.KERNEL, k1_err, k1_time, "r3d_tpu/ops/fuser_kernel.py:180"),
        (att.KERNEL, k3_err, k3_time, "r3d_tpu/ops/attention.py:38"),
    ):
        rows.append({
            "name": k.name, "route": "cuda", "source": f"r3d_tpu_torch/csrc/{k.source}",
            "replaces": replaces, "launches": counts[k.name],
            "max_abs_err": err, "max_err": err, "shape": t["shape"],
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
