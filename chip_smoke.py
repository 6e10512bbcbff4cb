"""Drive the PyTorch port on one NVIDIA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA host
    python3 chip_smoke.py --cards  # the CLI on every card of a host of two or more,
                                   # against one card (phase 21's second arm, and on
                                   # dp x tp 2, dp x sp 2 and dp x pp 2, phases 22-25),
                                   # alone

Phases, each of which fails the run (non-zero exit) if it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``r3d_tpu_torch/csrc`` (one nvcc per source,
   all in parallel) and print what ptxas says of each;
3. hold each kernel against its plain PyTorch version on the card, fp32
   with TF32 off, at the model's shapes: the fuser tail forward (K1) on both
   routes with the outer residual off and on at the utkinects buckets' N =
   8*256, 8*512, 8*1024, 8*2000 and a ragged N, twice bit-equal, with each
   bucket's launch shape and times; its backward (K2) at N = 1, 16, 2,053
   and the four buckets with the outer residual off and on, twice
   bit-equal, one call audited as its own four launches, timed at the four
   buckets; attention
   forward, dropout forward and backward (rate 0 and 0.1) at B = 8, H = 8,
   Lq = 8, D = 16, Lk = 256, 512 and a ragged 300 with a fully masked row,
   fp32 K4 also at Lq = 33 and 70 and Lk = 1-1,100 (from
   ``FP32_MANY_QUERY_MIN``, 20 queries, the fp32 many-query forward,
   ``csrc/attention_many_f32.cu``);
   the same three in bf16 at the 50salads decoder's Lq = 20, D = 64, each
   twice bit-equal and audited as one call's launches on the card, with K3
   and K4 also at 33, 70 and 512 (= Lk) queries, at 1, 31, 65, 129, 385,
   1,000 and 2,049 keys and with whole splits of keys masked, and K5 at 33
   and 70 queries and at 1, 31 and 65 keys (from 33 queries on, the
   many-query bodies); the three bf16 kernels also with S queries against
   S keys (the decoder attention of futr_proposed), where they take the
   many-query bodies (``csrc/attention_many*.cu``), at B = 8, H = 8, D = 64
   and S = 256, 512, 1,024, 3,100 and a ragged 777, and at B = 16, H = 8,
   D = 16 and S = 2,000, each twice bit-equal and timed (K4 with and
   without the fp32 output and keep bits a training call asks for, K5's dq
   launch and its peak memory), one call of each audited at S = 1,024 as 1, 1 and 2
   launches of its own kernels, and the few-query against the many-query
   bodies at Lk = 256 and Lq = 20-256 (the A/B behind ``MANY_QUERY_MIN``);
   the
   native cross-attention forward and backward (K6, K7) in fp32 and bf16 at
   B = 8, H = 8, (Lq, C) = (20, 512) and (8, 128), S = 1024, 3100 and a
   ragged 777 with padded key tails and a fully masked row, rate 0 and 0.1,
   at S = 1, 31 and 257 and with splits whose keys are all masked, each
   twice bit-equal, and one bf16 K7 call audited as its two launches.
   Time each at the main path's shape: kernel, plain version, bound and,
   where one exists, one PyTorch library call as the yardstick; K6 and K7
   also in fp32 at the utkinects 1024 and 2000 buckets' shape, where
   ``R3D_CROSS_NATIVE=1`` sends them, held to their plain versions there,
   each audited as one launch a call, with how many of their clusters fit
   the card at once, and their device time in 6 turns with the SM clock;
4. utkinects serving: an ``InferenceSession`` at full width (n_class 17,
   max_batch 8) from the port's seeded init; every launch count set to 0,
   requests through ``ServingQueue`` in the 256, 512 and 1024 buckets, the
   counts read, shapes, finite outputs and the serving kernels checked; the
   parts of one 512-bucket chunk; the card's logits against the CPU's;
5. utkinects training: ``Trainer.fit`` at full width, every count set to 0,
   2 epochs of 3 batch-8 steps (256 and 512 buckets) with validation;
   epoch 0 (train mode, dropout 0.1) must launch the no-blend tail, its
   backward, the dropout attention and the attention backward; epoch 1
   (sticky eval) the blend tail, attention and the attention backward. The
   parts of one train step, and one dropout-off step on the card against
   the CPU (loss, every gradient, BN statistics);
6. utkinects through the command line (``r3d_tpu_torch.cli``) at full
   width: a synthetic utkinect-layout dataset written from a seed (16
   actions; 5 train videos of 300-780 frames, 2 val videos of 600-780);
   every count set to 0, ``train`` of one seed for 2 epochs with
   validation on the JAX CLI's route for the config, the device cache
   (its log line asserted), where epoch 0 must launch the no-blend tail,
   its backward, the dropout attention and the attention backward, epoch 1
   the blend tail, attention and its backward, and each validation from
   the val cache the blend tail and attention, writing ``seed_1_best``,
   ``seed_1_last`` and the metrics stream; the same ``train`` with
   ``--no-device_cache`` (the host loader); ``fit`` over the host loader
   in the cached route's batch order and ``fit_hybrid`` with two of five
   units on the card, whose final parameters must equal the cached run's
   bit for bit; the counts set to 0 again, the 9-ratio MoC sweep from the
   best checkpoint and the cached val videos, where every chunk must
   launch the blend tail (K1) and the 256/512-bucket chunks attention
   (K3); its card-busy time and host-to-device bytes (the videos and the
   model, no optimizer state) from a profiled sweep; the host sweep
   (``--no-device_cache``), equal to the cached one; the same sweep with
   ``--cpu``, held window by window (logits and durations within 5e-2; a
   MoC difference only where a decode sits within the measured error of a
   flip); both MoC tables and the wall times;
7. utkinects at UTKinect scale from the device cache: 200 videos of
   150-450 frames from a seed (2,048-d features and 160x120 depth frames,
   bf16 on the card), ``build_cache`` timed; one epoch of ``fit_cached``
   (250 batch-8 steps in the 128, 256 and 512 buckets, validation from a
   cache of 16 videos), which must launch K1 no-blend, K2, K4 and K5, with
   its step time, and the card's busy time and launches a step from a
   profiled window; a window in which the host may not wait for the card
   (torch's sync debug mode) and no host-to-device copy may be larger than
   its index table; the same batches through the host loader and the cache
   in 4 interleaved rounds of 16 steps; 3 steps a dispatch (cached, and ``make_multi_step`` over host
   batches) equal to 3 single steps bit for bit; a ``grad_accum=2`` update
   against the mean microbatch gradient taken by hand;
8. utkinects with ``R3D_CROSS_NATIVE=1`` (restored after): requests in the
   1024 and 2000 buckets, where every cross-attention call must be an fp32
   K6 launch; the card's logits against the CPU's in the 2000 bucket;
   ``fit`` of 2 epochs (one 1024- and one 2000-bucket batch of 8) with
   validation, where every cross-attention call must be a K6 launch, epoch
   0 must launch K6 and K7 with dropout (their kernels' names in a profiler
   trace of it), and epoch 1 K6 and K7; one
   dropout-off 1024-bucket step on the card against the CPU; the parts of a
   2000-bucket train step; an interleaved A/B of a 2000-bucket train step
   and serving chunk with ``R3D_CROSS_NATIVE`` set and unset;
9. 50salads (FUTR, bf16, ``R3D_CROSS_NATIVE=1``) at full width (hidden 512,
   8 heads, 2 decoder layers, 20 queries, n_class 20): requests in the 256,
   512, 1024 and 3100 buckets, where the counts must show K3 at 256/512 and
   K6 at 1024/3100; the parts of a 512- and a 3100-bucket chunk; the card's
   logits against the CPU's; ``fit`` of 2 epochs (one 512- and one
   3100-bucket batch of 8) with validation, where epoch 0 must launch K4,
   K5, K6 and K7 and epoch 1 K3, K5, K6 and K7 (the few-query bodies, never
   the many-query ones); one dropout-off step on the
   card against the CPU; the parts of a train step; and an interleaved A/B
   of a 3100-bucket train step and serving chunk with ``R3D_CROSS_NATIVE``
   set and unset;
10. ``50salads_proposed`` (futr_proposed: hidden 512, 8 heads of 64, 2
   decoder layers, S queries from the L2 ground truth, bf16, batch 8) and
   ``breakfast_proposed`` (hidden 128, 8 heads of 16, 1 layer, batch 16)
   through the command line at full width: a dataset of each config's
   layout written from a seed (50salads: 8 train videos of 3,000-13,000
   frames, the longest reaching the 3100 bucket at ratio 0.5; Breakfast: 8
   of 1,500-7,000, two reaching the 2000 bucket), every count set to 0,
   ``train`` of one seed for 2 epochs on the device cache, where both
   epochs must launch the dropout attention and the attention backward
   (the loop is not sticky) with a step in the largest bucket, and each
   validation the attention forward; the 9-ratio sweep from the cached val
   videos (every chunk of 256 rows or more launches K3), equal to the host
   sweep, and held window by window to ``--cpu`` (logits and durations
   within 0.15, MoC and ``l3_acc`` differences explained by a margin or a
   frame edge); one dropout-off train step of the largest bucket through
   the kernels against the plain route on the card (outputs, loss, each
   gradient and the gradient vectors' cosine); the parts of that step; K3,
   K4 and K5 there are the many-query bodies, never the few-query ones;
11. ``darai`` (futr_unsupervised: self-attention queries across the batch,
   the ``unsupervised`` loop) and ``darai_gaze`` (futr_gaze, the ``futr``
   loop) through the command line at full width (hidden 128, 8 heads of
   16, 8 queries, input 2,048, one decoder layer, batch 8, fp32): one
   dataset of the DARai layout from a seed (4 train videos of 8 sequences
   of 10,500-12,800 frames, whose views at sample rate 15 fall in the 256
   and 512 buckets, 1 val video of 2 sequences, a gaze CSV of 1,200-1,900
   rows a video), every count set to 0, ``train`` of one seed for 2
   epochs (``darai`` on the device cache, ``darai_gaze`` on the host
   loader), where epoch 0 must launch fp32 K4 and K5, the sticky epoch K3
   and K5 and no K4, each validation K3; for ``darai`` the same with
   ``--no-device_cache`` and ``fit`` in the cached order, bit-equal to the
   cached run; the 9-ratio sweep at ``eval_batch=1`` (the cached sweep
   equal to the host sweep for ``darai``), K3 in every chunk of the 256
   and 512 buckets, its card time from a profiled sweep, held window by
   window to ``--cpu`` (logits, durations and L3 logits within 1e-3, every
   MoC or ``l3_acc`` difference explained by a margin or a frame edge); one
   sticky 512-bucket step through the kernels against the plain route;
   the parts of a 512-bucket step in epoch 0 and sticky; ``darai``'s
   validation time and launches a video;
12. the fuser ablations ``futr_fusion_grad``, ``futr_fusion_vary``,
   ``futr_fusion_nox`` and ``afft`` through the command line
   (``--config utkinects --model <variant>``) at full width over the CLI
   phase's 5 + 2 seeded videos: every count set to 0, ``train`` of one
   seed for 2 epochs on the device cache, each step's K1 and K2 launches
   counted by name, the outer-residual calls on counters of their own (on
   for grad, off for the others): both training epochs (epoch 0 and the sticky one) must launch
   K1's no-blend route and K2, never the blend route, and but for ``afft``
   the attention kernels; the checkpoint; the 9-ratio sweep on the card
   against ``--cpu`` window by window (K1's no-blend route in every chunk);
   for grad the training ranking on the card (channels [0, 32), in train
   mode and sticky), one sticky 512-bucket step through the kernels
   against the plain routes of the fuser and the attention, and the same
   step with K2's outer-residual flag flipped, which must fail its bounds;
13. ``futr_fusion_bn`` with ``fuser_depth=2`` (the composed fuser blocks,
   no K1 or K2): one serving chunk and one dropout-off train step on the
   card against the CPU;
14. the FUTR encoder (``use_encoder=True``, two layers): before the model
   phases, fp32 K3, K4 and K5 with S queries against S keys (B = H = 8,
   D = 16, S = 256, 512, 777, 1,024 and 2,000; K3 and K4 on the many-query
   forward, K5 on the many-query backward from what the forward kept, one
   launch a call on its counter; the forward's output the same with and
   without ``for_grad``) against their plain versions, twice bit-equal,
   and timed at 512 and 2,000 with their bounds, SDPA (forward + backward
   for K5), the cluster bodies they replace there and, for K3 and K5, the
   distance from an fp64 reference; the cluster bodies against the
   many-query bodies at Lk = 256, Lq = 8-256, K3, K4 and K5 (the A/B behind
   ``FP32_MANY_QUERY_MIN``); K1 and K2 timed with the outer residual;
   then ``futr_fusion_bn`` with the encoder at full width:
   requests in the 256-2,000 buckets (each launching fp32 K3 at Lq = Lk,
   counted as ``flash_attention_many``), the card's logits against the
   CPU's in the 2000 bucket, ``fit`` of 2 epochs over windows in the 512
   and 2000 buckets (K4 and K5 at Lq = Lk in epoch 0, K3 and K5 sticky), a
   train step against the CPU; and one 3100-bucket train step of ``futr``
   (50salads widths, bf16) with the encoder through the kernels (the
   many-query bodies) against the plain route, with the plain version at
   the kernels' rounding points read against the same witness at three
   seeds;
15. the NTU baselines (``--config nturgbd --model rnn|cnn|tcn``: input
   2,048, hidden 128, bf16 batches and embed) through the command line
   over an NTU-layout dataset written from a seed (5 + 2 videos of 100-300
   frames, 224x224 depth frames, 120 actions): ``train`` 2 epochs on the
   device cache, the sweep on the card against ``--cpu`` (outputs within
   5e-2, the TCN's slots decoded without durations), a dropout-off step
   against the CPU, the parts of a step, then ``Trainer.fit`` in the
   ``unimodal`` loop for ``rnn`` and the ``tcn`` loop for ``tcn`` (its
   sticky step's fixed-rate dropouts held by their keep rate and masks);
   no kernel of the port may launch anywhere in the phase;
16. ``darai --model futr_unsupervised_depth`` through the command line on
   the darai phase's dataset (S queries: fp32 K4 and K5 in epoch 0, K3
   and K5 sticky, K3 in validation, all on the ``*_MANY`` counters, the
   self- and cross-attention of every sweep chunk of 256 rows or more),
   the sweep against ``--cpu`` (1e-3), a sticky step through the kernels
   against the plain route, and a sticky step whose source and query
   ``Dropout(0.1)`` must keep 0.9 within 3 sigma, the backward through the
   forward's mask (ROADMAP C4);
17. ``50salads`` with MoE FFNs (4 experts, top 2) at full width under
   ``R3D_CROSS_NATIVE=1``: requests in the 512 and 3100 buckets, a 3100
   chunk against the CPU with the expert choices pinned to the card's,
   ``fit`` of 2 epochs (K4-K7 in epoch 0, K3, K5-K7 in epoch 1), a 3100
   step through the kernels against the plain route with an fp32 witness
   (the routes share the kernels' route's expert choices), and the parts
   of that step beside the dense ``futr``'s;
18. ``futr`` with the gt-label embed at the breakfast widths (fp32): a
   forward of [8, 512] ids (K3) and a train step (K5) against the CPU
   within 1e-3;
19. L3 query generation (``FUTRTransformer(query_pos=None)``) at S = 2,000:
   one forward against the CPU within 1e-3, ``l3_attention`` on fp32 K3's
   many-query counter;
20. serving deployment (A13): ``utkinects`` at full width from the seeded
   init in four sessions (float, ``quantize="int8"``,
   ``input_dtype="uint8"``, both), requests through ``ServingQueue`` in the
   256-2,000 buckets (K1's blend route in every chunk, fp32 K3 at 256/512),
   each session against itself on the CPU, the quantized sessions' logits
   against the float session's, the depth quantizer within scale/2, the
   weights' bytes on the card and (measured after phase 4,
   ``deploy_htod``) a 2000-bucket chunk's host-to-device bytes; the float
   and int8 + uint8 sessions exported (time, bytes), loaded as
   ``ExportedSession``s and served again, bit-equal to the live
   sessions, with live and exported latency a bucket; ``50salads`` (bf16,
   ``R3D_CROSS_NATIVE=1``, one request at a time) exported and served from
   the artifact in the 256-3,100 buckets (bf16 K3, bf16 K6), bit-equal to
   its live session;
21. data parallelism (A14, ``data_parallel``) at the utkinects widths, in
   three arms: a one-rank NCCL group on ``cuda:0`` in this process (a
   2-epoch ``fit`` on the host loader and ``fit_cached``, both with dropout
   0.1, and ``fit_cached`` under FSDP; the final parameters, BN statistics
   and checkpoint tensors of each bit-equal to the same run without a
   group, FSDP2 making every parameter a DTensor on the one-rank mesh; K1,
   K2, K3, K4 and K5 counted inside the group); the CLI under ``torchrun
   --standalone --nproc_per_node 1 ... --fsdp`` in a subprocess against the
   plain CLI (train, checkpoint, sweep; ``cli_under_torchrun``),
   MoC tables and checkpoints equal, and where the script sees more cards,
   on all of them with dropout off, within the fit bounds; two gloo ranks
   on the one card (dp = 2, the gradients all-reduced, the global
   BatchNorm), ``DP_STEPS`` 512-bucket steps of a global batch of 8,
   dropout off, against the one-process steps on the card within the CPU
   tests' fit bounds, then two steps with dropout 0.1 after which the
   ranks' parameters are equal, each rank's K1-K5 launches and its median
   step printed (two processes sharing one card: a reading, not a
   throughput);
22. tensor and expert parallelism (A14, ``tensor_parallel``): K3, K4 and
   K5 at the heads a rank of tp 2 holds (H 4: fp32 at D 16, bf16 at D
   64) and K6/K7 at its channels (fp32 C 64, bf16 C 256) against their
   plain versions (``check_tp_shapes``); which gloo collectives take CUDA
   tensors (``_gloo_probe``); then two gloo ranks on the one card run
   ``TP_ARMS``, each against the same steps in one process on the card
   within the fit bounds (the loss within ``DP_LOSS_TOL``, bf16
   ``TP_BF16_LOSS_TOL``), the ranks' whole states equal: utkinects at full
   width on tp 2 in the 512 bucket (K1/K2 on every row, K3 and K5 on 4 of
   the 8 heads) and in the 2000 bucket under ``R3D_CROSS_NATIVE=1`` (K6/K7
   on 64 of the 128 channels), each then with dropout 0.1 (K4, and K6/K7
   with their tp-folded seeds) after which the replicated tensors of the
   two ranks are equal; 50salads with MoE (bf16) on ep 2; darai
   (futr_unsupervised, the unsupervised loop, SupCon on, epoch 2) and the
   self-attention source in 50salads' futr loop on dp 2; each rank's
   launches, the heads and channels its attention calls saw, and its
   median step printed (two processes sharing one card: a reading);
   ``--cards`` also runs the CLI under ``torchrun ... --fsdp --mesh_tp 2``
   (dp x tp 2, NCCL) against one card;
23. sequence parallelism (A14, ``sequence_parallel``): whether gloo
   carries ``send``/``recv`` and ``batch_isend_irecv`` of CUDA tensors, the
   ring's transport (``gloo_p2p_probe``, each in a pair of throwaway
   processes: gloo aborted the sending process in its first run; the
   ring's hop on gloo with CUDA tensors is an ``all_gather_into_tensor``,
   ``ops/ring_attention.py``); then two gloo ranks on
   the one card on dp 1 x sp 2 run ``SP_ARMS``, each against the same
   steps in one process on the card within the fit bounds (the loss within
   ``DP_LOSS_TOL``, bf16 ``TP_BF16_LOSS_TOL``), the ranks' whole states
   equal: utkinects at full width in the 512 bucket, epoch 0 with dropout
   0.1 and the sticky epoch (K1 and K2 on each rank's 8 x 256 rows, K3, K4
   and K5 in the decoder over the 512 gathered keys), and futr at 50salads
   widths with its 2 encoder layers in the 2000 bucket (S/sp = 1,000): a
   dropout-off step through the ring, a dropout-0.1 step whose encoder
   gathers its attention over sp (bf16 K4/K5 on the whole sequence), and a
   step under ``R3D_CROSS_NATIVE=1`` (K6/K7 over the 2,000 gathered keys),
   then futr's eval forward through the ring against one process within
   ``SP_EVAL_TOL``; each rank's launches (every kernel of an arm's path
   must launch on each rank), the routes and shapes its calls saw, its
   step times and its peak allocated bytes beside one process's (two
   processes sharing one card: a reading). ``--cards`` also runs the CLI
   under ``torchrun ... --fsdp --mesh_sp 2`` (dp x sp 2, NCCL) against one
   card, without and with one encoder layer (the ring over point-to-point
   calls; its logged numbers within ``SP_RING_LOG_RTOL``);
24. sequence parallelism for every other family (A14,
   ``sequence_parallel_families``): two gloo ranks on the one card on dp 1
   x sp 2 run ``SPF_ARMS`` at full width, each against the same steps in
   one process on the card within the fit bounds, the ranks' whole states
   equal: 50salads_proposed (bf16) in the 3100 bucket with dropout 0.1
   (bf16 many-query K4/K5 on the decoder's gathered 3,100 queries), then
   its eval forward (the decoder's self-attention the ring, its
   cross-attention bf16 many-query K3 on each rank's 1,550 rows against
   the 3,100 gathered keys) within ``SP_EVAL_TOL``; darai (SupCon on) in
   the 512 bucket, epoch 0 with dropout and the sticky epoch 2 (fp32 K3-K5,
   8 queries against the 512 gathered keys) on the host route and on the
   cached route, the two equal; its depth source (fp32 many-query K3-K5,
   the ring in the sticky epoch); darai_gaze in the 2000 bucket, its gaze
   stream cut, under ``R3D_CROSS_NATIVE=1`` (fp32 K6/K7); 50salads with
   MoE and one encoder layer in the 3100 bucket with dropout under
   ``R3D_CROSS_NATIVE=1`` (bf16 K4/K5 in the gathered encoder, K6/K7 in
   the decoder; the queues on cut and on replicated tokens) and in the 512
   without (the ring, bf16 K3/K5); nturgbd's rnn and tcn (no kernel); each
   rank's launches (every kernel of an arm's path must launch on each
   rank), routes, step times and peak allocated bytes beside one
   process's. ``--cards`` also runs 50salads_proposed and darai through
   the CLI under ``torchrun ... --fsdp --mesh_sp 2`` against one card;
25. pipeline parallelism (A14, ``pipeline_parallel``): two gloo ranks on
   the one card on dp 1 x pp 2, each rank one decoder layer, run
   ``PP_ARMS``, each against the same steps in one process on the card
   within the fit bounds (GPipe's steps through ``pp_twin``, one process
   drawing the pipelined decoder's per-(layer, microbatch) dropout; the
   1F1B steps against ``make_accum_step`` over the same M microbatches),
   the ranks' whole states equal: 50salads at full width under
   ``R3D_CROSS_NATIVE=1`` in the 512 and 3100 buckets, GPipe with dropout
   0.1 and off (bf16 K3/K4/K5 at 512, K6/K7 at 3100), 1F1B at M = 2 and
   4, and its eval forwards (K3, K6); utkinects with 2 decoder layers,
   1F1B at M = 2 in epoch 0 and the sticky epoch (K1 and K2 in the pre
   stage, fp32 K3-K5 at 8 queries in each stage); a utkinects session on
   dp 2 and a 50salads session on pp 2 against one process. Each rank's
   launches must be the twin's share: its own layer's over M microbatches
   (1F1B's forward twice before the last stage: the forward tick and the
   recomputation), the pre's all; step times and peak allocated bytes
   beside one process's. ``--cards`` also runs the utkinects CLI with 2
   decoder layers under ``torchrun ... --mesh_pp 2`` on dp 2 x pp 2, GPipe
   (``--fsdp``) and 1F1B (one microbatch on the host route), against one
   card. Each phase's seconds print on a line of their own;
26. print one ``{"kernels": [...]}`` line (with each kernel's launches in
   the CLI phases' training and sweeps and in the cached epoch beside those
   of the other phases; rows for bf16 K3, K4 and K5 at Lq = Lk = 3,100 and
   2,000 with the launches of the two proposed configs' training and
   sweep; the darai phases', the ablations', ``fuser_depth=2``'s and the
   encoder's launches; rows for K1 and K2 with the outer residual, with the
   grad variant's launches, and for fp32 K3, K4 and K5 at Lq = Lk = 512 and
   2,000, with the encoder fit's launches and the serving launches of that
   bucket, the launches of phases 15-25 in their own columns and the
   relative error of phase 22's tp-shape checks) and, as
   the last line,
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero and prints no result where CUDA is
missing or the port is not importable.
"""

from __future__ import annotations

import contextlib
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
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense, SXM, 700 W
H100_TF32X3_FLOPS = 495e12 / 3   # fp32-accurate products as three TF32 tensor-core products
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
CROSS_FWD_TOL = 2e-5     # K6 fp32: online vs two-pass softmax
CROSS_BWD_TOL = 1e-4     # K7 fp32, over each gradient's largest entry: sums over up to 3,100 keys
BF16_TOL = 2e-2          # bf16 kernels vs their plain versions, over the largest entry: the same
                         # rounding points, but a sum in another order can land on the
                         # neighbouring bf16 value (2**-8 relative)
BF16_STEPS = 2           # bf16 K1 vs its plain version: within two bf16 steps (2**-7 of the
BF16_SHARE = 0.01        # largest entry each) and at most 1 % of the entries off; the same
                         # rounding points, so only a sum in another order that lands on the
                         # other side of a rounding boundary moves a value (and what it feeds).
                         # bf16 K2 (fp32 inside): dr and dd within one step, its fp32
                         # parameter gradients within K2_TOL
BF16_GRAD_TOL = 0.25     # a bf16 model's train step, card vs CPU: each gradient over its
BF16_COS_MIN = 0.9995    # largest entry, and the cosine of the whole gradient
SELF_TOL = 1e-2          # bf16 K3-K5 at S queries against S keys, over each tensor's own largest
                         # entry with no floor of 1 (an output entry there averages thousands
                         # of keys and reads far below 1): a flip to the neighbouring bf16
                         # value is 2**-8 = 3.9e-3 of it


# every __global__ function of r3d_tpu_torch/csrc, by a fragment of its name
OWN_KERNELS = ("fuser_tail_tf32_kernel", "fuser_tail_bf16_kernel", "transpose_weights_kernel",
               "fuser_tail_bwd_rows_kernel", "fuser_tail_wgrad_kernel", "fuser_tail_bwd_sum_kernel",
               "attention_fwd_cluster_kernel", "attention_fwd_split_kernel",
               "attention_fwd_many_kernel", "attention_fwd_many_f32_kernel",
               "attention_bwd_many_dq_kernel", "attention_bwd_many_dkdv_kernel",
               "attention_bwd_many_f32_dq_kernel", "attention_bwd_many_f32_dkdv_kernel",
               "attention_bwd_cluster_kernel", "attention_bwd_bf16_kernel",
               "dq_sum_kernel", "cross_fwd_split_kernel", "cross_fwd_combine_kernel",
               "cross_bwd_bf16_kernel", "cross_bwd_sum_kernel")


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


def cross_inputs(B, Lq, S, C, gen, device, dtype, all_masked_row=False):
    """Native-layout q [B, Lq, C], k, v [B, S, C] in ``dtype`` and a
    key-padding bias: row b keeps a random length (key 0 always), optionally
    one row with every key masked."""
    import torch

    from r3d_tpu_torch.models.layers import attention_bias_from_padding

    q, k, v = (torch.randn(B, L, C, generator=gen).to(device, dtype) for L in (Lq, S, S))
    lengths = torch.randint(1, S + 1, (B,), generator=gen)
    lengths[0] = S
    pad = torch.arange(S)[None, :] >= lengths[:, None]
    if all_masked_row:
        pad[-1] = True
    return q, k, v, attention_bias_from_padding(pad.to(device))


def fuser_bound_ms(N, C=128, Ch=512, with_blend=True):
    """Least time: bytes (streams in and out once, the tail's parameters
    once, with 8 [C] vectors, and the blend's 7 [C] vectors on its route)
    over HBM rate, or the flops of the three fp32-accurate products at the
    3xTF32 tensor-core rate (495 / 3 TFLOP/s; the fp32 pipes' 67 would give
    2.5x more)."""
    n_bytes = 4 * (3 * N * C + C * C + 2 * C * Ch + Ch + (15 if with_blend else 8) * C)
    flops = N * 2 * (2 * C * C + 4 * C * Ch)
    return _bound(n_bytes, flops, H100_TF32X3_FLOPS)


def fuser_bwd_bound_ms(N, C=128, Ch=512):
    """Streams r, d, g in and dr, dd out once, parameters in and their
    gradients out once; about 6 * N * (2*C*C + 4*C*Ch) flops (forward
    recomputed, the backward's products), fp32-accurate as for K1."""
    n_params = C * C + 2 * C * Ch + Ch + 8 * C
    return _bound(4 * (5 * N * C + 2 * n_params), 6 * N * (2 * C * C + 4 * C * Ch),
                  H100_TF32X3_FLOPS)


def attention_bound_ms(B, H, Lq, Lk, D, flops_per_s=H100_FP32_FLOPS):
    """q, k, v and the bias in, out out, once; the two products at the fp32
    rate (or ``flops_per_s``: the 3xTF32 rate for the many-query body,
    whose products are fp32-accurate on the tensor cores)."""
    n_bytes = 4 * (2 * B * H * Lq * D + 2 * B * H * Lk * D + B * Lk)
    flops = 4 * B * H * Lq * Lk * D
    return _bound(n_bytes, flops, flops_per_s)


def attention_bwd_bound_ms(B, H, Lq, Lk, D, flops_per_s=H100_FP32_FLOPS):
    """q, g, k, v, bias in and dq, dk, dv out once (the function's inputs
    and outputs: the cluster body recomputes rowsum(g * out) and the
    many-query body reads what its forward kept, neither counted; no dbias
    on the path); the backward's five [Lq, Lk, D] products at the fp32 rate
    (or ``flops_per_s``: the 3xTF32 rate for the many-query body)."""
    n_bytes = 4 * (3 * B * H * Lq * D + 4 * B * H * Lk * D + B * Lk)
    return _bound(n_bytes, 10 * B * H * Lq * Lk * D, flops_per_s)


def attention_bf16_bound_ms(B, H, Lq, Lk, D, backward=False):
    """K3/K4 (and with ``backward`` K5) on bf16 inputs and outputs: the same
    tensors as the fp32 bounds at 2 bytes (the bias and dbias stay fp32),
    the products at the bf16 tensor-core rate."""
    if backward:
        n_bytes = 2 * (3 * B * H * Lq * D + 4 * B * H * Lk * D) + 4 * B * Lk
        return _bound(n_bytes, 10 * B * H * Lq * Lk * D, H100_BF16_FLOPS)
    n_bytes = 2 * (2 * B * H * Lq * D + 2 * B * H * Lk * D) + 4 * B * Lk
    return _bound(n_bytes, 4 * B * H * Lq * Lk * D, H100_BF16_FLOPS)


def cross_bound_ms(B, Lq, S, C, H, itemsize, backward=False):
    """K6: q, k, v and the bias in, out and (m, l) out; K7: q, g, o, k, v,
    the bias, m and l in, dq, dk, dv and dbias out; each once. Products at
    the bf16 tensor-core rate for bf16 inputs, else the fp32 rate."""
    rate = H100_BF16_FLOPS if itemsize == 2 else H100_FP32_FLOPS
    stats = 4 * 2 * B * H * Lq
    if backward:
        n_bytes = itemsize * (4 * B * Lq * C + 4 * B * S * C) + 4 * 2 * B * S + stats
        return _bound(n_bytes, 10 * B * Lq * S * C, rate)
    n_bytes = itemsize * (2 * B * Lq * C + 2 * B * S * C) + 4 * B * S + stats
    return _bound(n_bytes, 4 * B * Lq * S * C, rate)


def _bound(n_bytes, flops, flops_per_s=H100_FP32_FLOPS):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def card_events(prof):
    """The profiler's averages of what ran on the card: kernels, copies and
    memsets. User annotations are left out: a ``record_function`` range (as
    ``Optimizer.step#AdamW.step``, which torch.optim puts around every
    step) also lands on the card's timeline, spanning the kernels it
    enqueued and the gaps between them, so counting it would count those
    kernels twice and the gaps as busy, and add a launch."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, names, iters=20):
    """Device time per CALL of ``fn``: the device time of every kernel whose
    name holds one of ``names`` (a string or several; all the launches of a
    C entry point), or with ``names`` None of every kernel and copy on the
    card, summed over a torch.profiler trace of ``iters`` calls and divided
    by ``iters``. None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if isinstance(names, str):
        names = (names,)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = card_events(prof)
        if names is not None:
            events = [e for e in events if any(n in e.key for n in names)]
        total_us = sum(e.self_device_time_total for e in events)
        if events and total_us > 0:
            return total_us / iters / 1e3
    return None


def library_times(fn, iters=50):
    """A library yardstick's time per call twice over: CUDA events around
    back-to-back calls (which the host can bound) and the sum of its kernels'
    device time from the profiler."""
    return {"library_ms": time_ms(fn, iters=iters),
            "library_device_ms": device_ms(fn, None, iters=min(iters, 20))}


def busy_clock(fn):
    """The card's SM clock and power draw (``nvidia-smi``) read while
    back-to-back calls of ``fn`` keep it busy, as one string."""
    import subprocess

    import torch

    smi = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader"], stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, text=True)
    while smi.poll() is None:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    return smi.stdout.read().strip().replace(", ", " ") or "not read"


FP32_CROSS_TURNS = 6


def device_turns(fn, names, turns=FP32_CROSS_TURNS):
    """``device_ms`` of ``fn`` in ``turns`` turns, each followed by the SM
    clock and power read while ``fn`` runs (``busy_clock``): the median
    ("device_ms"), the least ("device_min_ms") and every (ms, clock) turn.
    A turn whose trace held no device events is left out of the median and
    the least."""
    readings = [(device_ms(fn, names), busy_clock(fn)) for _ in range(turns)]
    ms = [t for t, _ in readings if t is not None]
    return {"device_ms": float(np.median(ms)) if ms else None,
            "device_min_ms": min(ms) if ms else None,
            "turns": [(float("nan") if t is None else t, c) for t, c in readings]}


def fmt_ms(x):
    """A time that the profiler may not have seen, for printing."""
    return "not measured" if x is None else f"{x:.4f}"


def ptxas_entry(mangled):
    """A kernel's name and template arguments from its mangled name in
    ptxas's output: ``_ZN3r3d28attention_fwd_cluster_kernelILi16ELb0ELb0EEEv...``
    gives ``attention_fwd_cluster_kernel<16, 0, 0>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():   # <length><identifier>, namespaces first
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:L[a-z]-?\d+E)+)E", mangled[i:])
    return name + (f"<{', '.join(re.findall(r'L[a-z](-?[0-9]+)E', args[1]))}>" if args else "")


def raw_launcher(kernel, *args):
    """The kernel's C launcher with its arguments bound, for timing without
    the wrapper's checks (and without counting)."""
    fn = kernel.load()
    return lambda: fn(*args)


K1_ROWS = (8 * 256, 8 * 512, 8 * 1024, 8 * 2000)   # the utkinects buckets' batches of 8


def fuser_tail_config(N):
    """K1's launch at N rows: (rows of each stream a block takes, blocks,
    blocks that fit one SM at once)."""
    import ctypes

    from r3d_tpu_torch.ops import fuser_kernel as fk

    out = [ctypes.c_int() for _ in range(3)]
    fn = fk.KERNEL.query("r3d_fuser_tail_config",
                         [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3)
    err = fn(N, *(ctypes.byref(x) for x in out))
    if err:
        raise RuntimeError(f"r3d_fuser_tail_config: CUDA error {err}")
    return tuple(x.value for x in out)


def check_fuser_kernel(gen, device):
    """K1 on both routes, the outer residual off and on, against its plain
    version at the utkinects buckets' N = 8 x 256, 512, 1,024 and 2,000 rows
    and a ragged N, each call twice bit-equal; each bucket's launch shape,
    and both routes timed there beside the bound. Returns per route (worst
    error, the timing at N = 8 x 512, the main path's serving chunk)."""
    import torch

    from r3d_tpu_torch.ops import fuser_kernel as fk

    stream = torch.cuda.current_stream().cuda_stream
    worst = {"blend": 0.0, "no-blend": 0.0}
    timing = {}
    for N in K1_ROWS + (8 * 256 + 5,):
        r, d, blend, params = fuser_inputs(N, gen, device)
        for outer in (False, True):
            calls = {
                "blend": (lambda: fk.fused_bn_blend_tail(r, d, blend, params, outer),
                          lambda: fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params,
                                                   outer)),
                "no-blend": (lambda: fk.fused_safuser_tail(r, d, params, outer),
                             lambda: fk.composed_tail(r, d, params, outer)),
            }
            for route, (fn, plain) in calls.items():
                got = fn()
                err = float((got - plain()).abs().max())
                print(f"K1 {route} N={N} outer_residual={outer}: max|kernel - plain| = "
                      f"{err:.3e} (tol {K1_TOL})")
                if not (err <= K1_TOL and torch.isfinite(got).all()):
                    raise AssertionError(f"K1 {route} disagrees with its plain version at N={N}, "
                                         f"outer_residual={outer}")
                if not torch.equal(got, fn()):
                    raise AssertionError(f"K1 {route} is not deterministic at N={N}")
                worst[route] = max(worst[route], err)
        if N not in K1_ROWS:
            continue
        rows, blocks, per_sm = fuser_tail_config(N)
        out = torch.empty_like(r)
        launches = {
            "blend": raw_launcher(fk.KERNEL, r.data_ptr(), d.data_ptr(),
                                  *(t.data_ptr() for t in blend),
                                  *(t.data_ptr() for t in params), out.data_ptr(), N, 128, 512,
                                  0, stream),
            "no-blend": raw_launcher(fk.TAIL_KERNEL, r.data_ptr(), d.data_ptr(),
                                     *(t.data_ptr() for t in params), out.data_ptr(), N, 128,
                                     512, 0, stream),
        }
        for route, launch in launches.items():
            bound, bound_by = fuser_bound_ms(N, with_blend=route == "blend")
            t = {"shape": f"N={N} C=128 Ch=512", "ms": time_ms(launch),
                 "device_ms": device_ms(launch, "fuser_tail_tf32_kernel<" +
                                        ("true" if route == "blend" else "false")),
                 "library_ms": None, "library_device_ms": None, "bound_ms": bound,
                 "bound_by": bound_by}
            print(f"K1 {route} N={N}: {blocks} blocks of {rows} rows of each stream, {per_sm} "
                  f"an SM; {t['ms']:.4f} ms by events, {t['device_ms']:.4f} on the device, "
                  f"bound {bound:.4f} ({bound_by})")
            if N == 8 * 512:
                plain = {"blend": lambda: fk.composed_tail(*fk.composed_bn_blend(r, d, blend),
                                                           params),
                         "no-blend": lambda: fk.composed_tail(r, d, params)}[route]
                timing[route] = {**t, "plain_ms": time_ms(plain)}
    return (worst["blend"], timing["blend"]), (worst["no-blend"], timing["no-blend"])


def errs(got, want):
    """(max|got - want|, the same over max(1, max|want|)) over tensor pairs,
    in fp32."""
    a = r = 0.0
    for x, y in zip(got, want):
        e = float((x.float() - y.float()).abs().max())
        a, r = max(a, e), max(r, e / max(1.0, float(y.float().abs().max())))
    return a, r


def errs_own(got, want):
    """Over tensor pairs, in fp32: (max|got - want|, the largest of
    max|got - want| / max|want|, the least max|want|, the least RMS of
    ``want``): each tensor against its own scale, with no floor."""
    a = r = 0.0
    top = rms = math.inf
    for x, y in zip(got, want):
        y = y.float()
        e = float((x.float() - y).abs().max())
        m = float(y.abs().max())
        a, r = max(a, e), max(r, e / max(m, 1e-30))
        top, rms = min(top, m), min(rms, float(y.square().mean().sqrt()))
    return a, r, top, rms


@contextlib.contextmanager
def plain_attention_route():
    """Within: the attention modules take the plain route on the card
    (``attention_kernel_eligible`` and, under ``R3D_CROSS_NATIVE=1``,
    ``cross_attention_native_eligible`` patched off), for a comparison
    only."""
    from r3d_tpu_torch.models import layers

    eligible = layers.attention_kernel_eligible, layers.cross_attention_native_eligible
    layers.attention_kernel_eligible = lambda *a: False
    layers.cross_attention_native_eligible = lambda *a: False
    try:
        yield
    finally:
        layers.attention_kernel_eligible, layers.cross_attention_native_eligible = eligible


def attention_fp64(q, k, v, bias, scale, seed=0, rate=0.0, g=None):
    """Attention in fp64 (the plain versions compute their products in
    fp32): the output, or with ``g`` the backward's (dq, dk, dv) under the
    kernels' keep mask at ``rate``."""
    import torch

    from r3d_tpu_torch.ops import attention as att

    q, k, v = (t.double() for t in (q, k, v))
    w = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias.double(), dim=-1)
    if g is None:
        return torch.einsum("bhqk,bhkd->bhqd", w, v)
    keep = att.dropout_keep(seed, rate, w.shape, q.device).double() if rate > 0.0 else 1.0
    g = g.double()
    dw = torch.einsum("bhqd,bhkd->bhqk", g, v) * keep
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale,
            torch.einsum("bhqk,bhqd->bhkd", w * keep, g))


def errs_fp64(got, ref):
    """max|got - ref| over max(1, max|ref|), the worst of tensor pairs, in
    fp64 (``ref`` an fp64 reference)."""
    return max(float((x.double() - y).abs().max()) / max(1.0, float(y.abs().max()))
               for x, y in zip(got, ref))


def worse(a, b):
    """The elementwise max of two (absolute, relative) error pairs."""
    return max(a[0], b[0]), max(a[1], b[1])


def check_fuser_bwd_kernel(gen, device):
    """K2 (the fuser-tail backward) at N = 1, 16, a ragged 2,053 and the
    utkinects buckets' N = 8 x 256, 512, 1,024 and 2,000 rows, the outer
    residual off and on, each call twice bit-equal; one call audited as
    exactly its own four launches (no memset); timed at the four buckets
    with every launch of a call counted. Returns (worst error, the timing at
    N = 8 x 512)."""
    import torch

    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    worst_bwd = (0.0, 0.0)
    t_bwd = None
    for N in (1, 16, 2053) + K1_ROWS:
        r, d, _, params = fuser_inputs(N, gen, device)
        g = torch.randn(N, 128, generator=gen).to(device)
        for outer in (False, True):
            got = fkb.fused_tail_bwd(r, d, g, params, outer)
            want = fkb.composed_tail_bwd(r, d, g, params, outer)
            torch.cuda.synchronize()
            ea, er = errs((got[0], got[1], *got[2]), (want[0], want[1], *want[2]))
            again = fkb.fused_tail_bwd(r, d, g, params, outer)
            same = all(torch.equal(a, b) for a, b in zip((got[0], got[1], *got[2]),
                                                          (again[0], again[1], *again[2])))
            print(f"fused_tail_bwd N={N} outer_residual={outer}: over dr, dd and 12 "
                  f"gradients max|kernel - plain| = {ea:.3e}, relative {er:.3e} (tol {K2_TOL}); "
                  f"two calls bit-equal: {same}")
            if not (er <= K2_TOL and same):
                raise AssertionError(f"fused_tail_bwd disagrees or is not deterministic at N={N}, "
                                     f"outer_residual={outer}")
            worst_bwd = (max(worst_bwd[0], ea), max(worst_bwd[1], er))
        if N not in K1_ROWS:
            continue
        if N == 8 * 512:
            own_launches_per_call(lambda: fkb.fused_tail_bwd(r, d, g, params),
                                  ("transpose_weights_kernel", "fuser_tail_bwd_rows_kernel",
                                   "fuser_tail_wgrad_kernel", "fuser_tail_bwd_sum_kernel"),
                                  4, "K2 fused_tail_bwd")
        plan = fkb.bwd_plan(N, 512, torch.cuda.get_device_properties(device).multi_processor_count)
        dr, dd = torch.empty_like(r), torch.empty_like(d)
        scratch = torch.empty(fkb.scratch_floats(128, 512, plan), device=device)
        flat = torch.empty(fkb.grad_layout(128, 512)[1], device=device)
        launch = raw_launcher(fkb.KERNEL, r.data_ptr(), d.data_ptr(), g.data_ptr(),
                              *(t.data_ptr() for t in params), dr.data_ptr(), dd.data_ptr(),
                              scratch.data_ptr(), flat.data_ptr(), N, 128, 512, plan.tile_rows,
                              plan.split_rows, 0, torch.cuda.current_stream().cuda_stream)
        bound, bound_by = fuser_bwd_bound_ms(N)
        t = {"shape": f"N={N} C=128 Ch=512", "ms": time_ms(launch, iters=20),
             "device_ms": device_ms(launch, None), "library_ms": None,
             "library_device_ms": None, "bound_ms": bound, "bound_by": bound_by}
        print(f"K2 N={N}: {plan.n_tiles} row blocks of {plan.tile_rows} token rows, "
              f"{plan.n_split} splits of {plan.split_rows} rows x "
              f"{2 * 512 // fkb.OUT_TILE + 1} output tiles; {t['ms']:.4f} ms by events, "
              f"{t['device_ms']:.4f} on the device (every launch of a call), "
              f"bound {bound:.4f} ({bound_by})")
        if N == 8 * 512:
            t_bwd = {**t, "plain_ms": time_ms(
                lambda: fkb.composed_tail_bwd(r, d, g, params, False), iters=20)}
    return worst_bwd, t_bwd


def fp32_clusters_at_once(B, H, Lq, Lk, D, split):
    """How many clusters of the fp32 K3 and K5 launches at these sizes the
    card holds at once (``cudaOccupancyMaxActiveClusters``): fewer than the
    launch has, and it runs in waves."""
    import ctypes

    from r3d_tpu_torch.ops import attention as att

    out = [ctypes.c_int(), ctypes.c_int()]
    args = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    err = att.KERNEL.query("r3d_attention_fwd_clusters", args)(
        B, H, Lq, Lk, D, split, ctypes.byref(out[0]))
    err = err or att.BWD_KERNEL.query("r3d_attention_bwd_clusters", args)(
        B, H, Lk, D, split, 1, ctypes.byref(out[1]))
    if err:
        raise RuntimeError(f"r3d_attention_*_clusters: CUDA error {err}")
    return out[0].value, out[1].value


def check_attention_train_kernels(gen, device):
    """K4 (dropout forward) and K5 (backward, rate 0 and 0.1), each twice
    bit-equal and one call audited as one launch of its own kernel (K5: no
    memset); K4 also at Lq 8, 33 and 70 against 1-1,100 keys, rate 0 and
    0.1."""
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
        if not torch.equal(got, att.flash_attention_dropout(q, k, v, bias, seed, scale, rate)):
            raise AssertionError(f"flash_attention_dropout (fp32) is not deterministic at Lk={Lk}")
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
        again = att.attention_bwd(q, k, v, bias, seed, scale, rate, g, need_dbias=True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"attention_bwd (fp32) is not deterministic at Lk={Lk}")
        if Lk == 512:
            stream = torch.cuda.current_stream().cuda_stream
            out = torch.empty_like(q)
            launch = raw_launcher(att.DROPOUT_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), B, H, Lq, Lk, D,
                                  att.fp32_split_keys(Lk), scale, seed,
                                  att.dropout_threshold(rate), 1.0 / (1.0 - rate), stream)
            own_launches_per_call(
                lambda: att.flash_attention_dropout(q, k, v, bias, seed, scale, rate),
                ("attention_fwd_cluster_kernel",), 1, "K4 fp32 flash_attention_dropout")
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                             dropout_p=rate, scale=scale)
            bound, bound_by = attention_bound_ms(B, H, Lq, Lk, D)
            t4 = {"shape": f"B={B} H={H} Lq={Lq} Lk={Lk} D={D} p={rate}", "ms": time_ms(launch),
                  "device_ms": device_ms(launch, "attention_fwd_cluster_kernel<16, true"),
                  "plain_ms": time_ms(lambda: att.composed_attention_dropout(
                      q, k, v, bias, seed, scale, rate)),
                  **library_times(library), "bound_ms": bound, "bound_by": bound_by}
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            split = att.fp32_split_keys(Lk)
            fit = fp32_clusters_at_once(B, H, Lq, Lk, D, split)
            print(f"  K3/K5 fp32 at Lk={Lk}: {-(-Lk // split)} splits of {split} keys, "
                  f"{B * H} clusters launched; the card holds {fit[0]} (K3) and {fit[1]} (K5) "
                  "at once")
            launch = raw_launcher(att.BWD_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(), None, B, H, Lq, Lk, D, split, scale, 1, seed,
                                  att.dropout_threshold(rate), 1.0 / (1.0 - rate), stream)
            own_launches_per_call(lambda: att.attention_bwd(q, k, v, bias, seed, scale, rate, g),
                                  ("attention_bwd_cluster_kernel",), 1, "K5 fp32 attention_bwd")
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]

            def library_bwd():
                o = F.scaled_dot_product_attention(*leaves, attn_mask=bias, dropout_p=rate,
                                                   scale=scale)
                torch.autograd.grad(o, leaves, g)

            bound, bound_by = attention_bwd_bound_ms(B, H, Lq, Lk, D)
            t5 = {"shape": f"B={B} H={H} Lq={Lq} Lk={Lk} D={D} p={rate}", "ms": time_ms(launch),
                  "device_ms": device_ms(launch, "attention_bwd_cluster_kernel<16"),
                  "plain_ms": time_ms(lambda: att.composed_attention_bwd(
                      q, k, v, bias, seed, scale, rate, g, False)),
                  **library_times(library_bwd), "bound_ms": bound, "bound_by": bound_by}
    # what the dropout forwards could get wrong (the cluster body at 8
    # queries, the many-query body at 33 and 70): more than one query
    # tile, one key, less than a tile, a last split of one key, a fully
    # masked row, splits of several tiles; rate 0 keeps every weight
    for Lq_ in (8, 33, 70):
        for Lk in (1, 31, 65, 256, 300, 512, 1100):
            q, k, v, bias = attention_inputs(B, H, Lq_, Lk, D, gen, device, all_masked_row=Lk > 1)
            for r_ in (0.0, rate):
                got = att.flash_attention_dropout(q, k, v, bias, 77 + Lk, scale, r_)
                err = float((got - att.composed_attention_dropout(q, k, v, bias, 77 + Lk, scale,
                                                                  r_)).abs().max())
                same = torch.equal(got, att.flash_attention_dropout(q, k, v, bias, 77 + Lk,
                                                                    scale, r_))
                if not (err <= K3_TOL and same and torch.isfinite(got).all()):
                    raise AssertionError(f"flash_attention_dropout (fp32) disagrees or is not "
                                         f"deterministic at Lq={Lq_}, Lk={Lk}, rate={r_}: "
                                         f"{err:.3e}")
                worst4 = max(worst4, err)
    print(f"K4 fp32 at Lq 8, 33, 70 x Lk 1-1,100, rate 0 and {rate}: max|kernel - plain| = "
          f"{worst4:.3e} (tol {K3_TOL}); two calls bit-equal at each")
    return (worst4, t4), (worst5, t5)


def check_attention_kernel(gen, device):
    """K3 (fp32) at B = H = 8, Lq = 8, D = 16, Lk = 256, 512 and a ragged 300
    with a fully masked row, each twice bit-equal, timed at Lk = 512 and one
    call audited as one launch of its own kernel; K3 and K5 at the shapes
    around their query tiles of 8 and their splits of 64 keys; the routing
    A/B of wrapper against plain call at Lk = 128-2,000."""
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
        if not torch.equal(got, att.flash_attention(q, k, v, bias, scale)):
            raise AssertionError(f"flash_attention (fp32) is not deterministic at Lk={Lk}")
        if Lk == 512:   # the 512-bucket cross-attention of the serving path
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            launch = raw_launcher(att.KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), B, H, Lq, Lk, D,
                                  att.fp32_split_keys(Lk), scale, stream)
            own_launches_per_call(lambda: att.flash_attention(q, k, v, bias, scale),
                                  ("attention_fwd_cluster_kernel",), 1, "K3 fp32 flash_attention")
            plain = lambda: att.composed_attention(q, k, v, bias, scale)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                             scale=scale)
            lib_err = float((library() - want).abs().max())
            print(f"  scaled_dot_product_attention (yardstick only): max|lib - plain| = {lib_err:.3e}")
            bound, bound_by = attention_bound_ms(B, H, Lq, Lk, D)
            timing = {"shape": f"B={B} H={H} Lq={Lq} Lk={Lk} D={D}", "ms": time_ms(launch),
                      "device_ms": device_ms(launch, "attention_fwd_cluster_kernel<16"),
                      "plain_ms": time_ms(plain), **library_times(library),
                      "bound_ms": bound, "bound_by": bound_by}
    # what the cluster bodies of K3 and K5 could get wrong: more than one
    # query tile of 8, one key, less than one tile of 64, a last tile of one
    # key, splits grown to two and to five tiles (the ring), the
    # self-attention route; a fully masked row where Lk > 1 (K3 at 33 queries
    # or more: the many-query forward, a ragged query block and key tile)
    for Lq_, Lk in ((33, 512), (70, 300), (8, 1), (8, 31), (8, 65), (20, 1024), (8, 2049),
                    (512, 512)):
        q, k, v, bias = attention_inputs(B, H, Lq_, Lk, D, gen, device, all_masked_row=Lk > 1)
        g = torch.randn(q.shape, generator=gen).to(device)
        got = att.flash_attention(q, k, v, bias, scale)
        err = float((got - att.composed_attention(q, k, v, bias, scale)).abs().max())
        if not (err <= K3_TOL and torch.equal(got, att.flash_attention(q, k, v, bias, scale))):
            raise AssertionError(f"flash_attention (fp32) disagrees or is not deterministic at "
                                 f"Lq={Lq_}, Lk={Lk}: {err:.3e}")
        worst = max(worst, err)
        for r_ in (0.0, 0.1):
            got_b = att.attention_bwd(q, k, v, bias, 5, scale, r_, g, need_dbias=True)
            e_b = errs(got_b, att.composed_attention_bwd(q, k, v, bias, 5, scale, r_, g))
            same = all(torch.equal(a, b) for a, b in zip(
                got_b, att.attention_bwd(q, k, v, bias, 5, scale, r_, g, need_dbias=True)))
            print(f"K3, K5 fp32 Lq={Lq_} Lk={Lk} rate={r_}: K3 max|kernel - plain| {err:.3e}; "
                  f"K5 over dq, dk, dv, dbias {e_b[0]:.3e}, relative {e_b[1]:.3e} "
                  f"(tol {K3_TOL}); two calls bit-equal")
            if not (e_b[1] <= K3_TOL and same):
                raise AssertionError(f"attention_bwd (fp32) disagrees or is not deterministic at "
                                     f"Lq={Lq_}, Lk={Lk}, rate={r_}")
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


def own_launches_per_call(fn, fragments, per_call, label, calls=5):
    """Fail unless ``calls`` calls of ``fn`` are, on the card, exactly
    ``per_call`` launches each of kernels whose names hold one of
    ``fragments``, and nothing else (no memset, no cast). The first launches
    after the card's tracing starts can go missing from a trace (one kernel
    or whole calls, trace after trace), so each trace runs ``calls``
    uncounted calls first and counts what started on the card after the
    counted calls began (a ``record_function`` range opened after a
    synchronise). The card's timestamps are mapped onto the host's clock,
    and that mapping need not be exact, so the two groups of calls run 10 ms
    apart and the count starts halfway between them. A trace short of an event is taken again (three times at
    most); a foreign kernel or one launch too many fails at once."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    gap_us = 10_000
    on_card = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(gap_us / 1e6)
            with record_function("counted calls"):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = next(e.time_range.start for e in events if e.name == "counted calls"
                     and e.device_type == torch.autograd.DeviceType.CPU) - gap_us / 2
        on_card = dict(collections.Counter(
            e.name for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != "counted calls"
            and e.time_range.start >= start))
        foreign = [k for k in on_card if not any(f in k for f in fragments)]
        if foreign or sum(on_card.values()) >= per_call * calls:
            break
    print(f"{label}: {calls} calls on the card: { {k[:70]: c for k, c in on_card.items()} }")
    if foreign or sum(on_card.values()) != per_call * calls:
        raise AssertionError(f"{label} should be {per_call} launches of its own kernels a "
                             f"call: {on_card}")


def masked_split_bias(B, Lk, lengths, device):
    """A key-padding bias whose rows keep the given numbers of keys (cycled
    over the batch): with 10, 128 or 129 real keys of 512, whole splits of
    the bf16 forwards hold only masked keys; with 0 the row is fully masked."""
    import torch

    from r3d_tpu_torch.models.layers import attention_bias_from_padding

    keep = torch.tensor([lengths[b % len(lengths)] for b in range(B)])
    return attention_bias_from_padding((torch.arange(Lk)[None, :] >= keep[:, None]).to(device))


def check_attention_bf16_kernels(gen, device):
    """K3, K4 and K5 on bf16 inputs at the 50salads decoder's shape (B = 8,
    H = 8, Lq = 20, D = 64; Lk = 256, 512 and a ragged 300 with a fully
    masked row), against their plain versions; timed at Lk = 512. Each
    twice (bit-equal), and as the launches of one wrapper call. K3 and K4
    also at the shapes around their splits of 128 keys, clusters of up to 8
    splits and tiles of 32 queries, on the self-attention route (Lq = Lk =
    512) and with whole splits masked; K5 at the shapes around its tiles of
    32 queries and blocks of 64 keys. From ``MANY_QUERY_MIN`` queries on
    (33, 70, 512) the calls take the many-query bodies, held the same way."""
    import torch
    import torch.nn.functional as F

    from r3d_tpu_torch.ops import attention as att

    B, H, Lq, D, rate = 8, 8, 20, 64, 0.1
    scale = 1.0 / math.sqrt(D)
    worst = {"K3": (0.0, 0.0), "K4": (0.0, 0.0), "K5": (0.0, 0.0)}
    timing = {}

    def check_fwd(q, k, v, bias, seed, label):
        """K3 and K4 against their plain versions, and each twice bit-equal."""
        Lq_, Lk_ = q.shape[2], k.shape[2]
        calls = {"K3": lambda: att.flash_attention(q, k, v, bias, scale),
                 "K4": lambda: att.flash_attention_dropout(q, k, v, bias, seed, scale, rate)}
        plain = {"K3": lambda: att.composed_attention(q, k, v, bias, scale),
                 "K4": lambda: att.composed_attention_dropout(q, k, v, bias, seed, scale, rate)}
        for name, fn in calls.items():
            got = fn()
            err = errs([got], [plain[name]()])
            print(f"{name} bf16 Lq={Lq_} Lk={Lk_}{label}: max|kernel - plain| = {err[0]:.3e}, "
                  f"over max(1, max|plain|) {err[1]:.3e} (tol {BF16_TOL})")
            if not (err[1] <= BF16_TOL and torch.isfinite(got.float()).all()):
                raise AssertionError(f"{name} bf16 disagrees with its plain version at "
                                     f"Lq={Lq_}, Lk={Lk_}{label}")
            if not torch.equal(got, fn()):
                raise AssertionError(f"{name} bf16 is not deterministic at Lq={Lq_}, Lk={Lk_}")
            worst[name] = worse(worst[name], err)

    for Lk, all_masked in ((256, False), (512, False), (300, True)):
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device, all_masked)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        g = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
        seed = 2000 + Lk
        check_fwd(q, k, v, bias, seed, " (one row fully masked)" if all_masked else "")
        for r_ in (0.0, rate):
            got = att.attention_bwd(q, k, v, bias, seed, scale, r_, g, need_dbias=True)
            want = att.composed_attention_bwd(q, k, v, bias, seed, scale, r_, g)
            err = errs(got, want)
            print(f"K5 bf16 Lk={Lk} rate={r_}: over dq, dk, dv, dbias max|kernel - plain| = "
                  f"{err[0]:.3e}, relative {err[1]:.3e} (tol {BF16_TOL})")
            if not err[1] <= BF16_TOL:
                raise AssertionError(f"K5 bf16 disagrees at Lk={Lk}, rate={r_}")
            worst["K5"] = worse(worst["K5"], err)
        again = att.attention_bwd(q, k, v, bias, seed, scale, rate, g, need_dbias=True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K5 bf16 is not deterministic at Lk={Lk}")
        if Lk != 512:
            continue
        print(f"K3, K4, K5 bf16 Lk={Lk}: two calls agree bit for bit")
        stream = torch.cuda.current_stream().cuda_stream
        shape = f"B={B} H={H} Lq={Lq} Lk={Lk} D={D} bf16"
        split = att.fwd_split_keys(Lk)
        print(f"  K3/K4 bf16 at Lk={Lk}: {-(-Lk // split)} splits of {split} keys")
        mask = bias == 0   # SDPA's bool mask (True = attend) for bf16 inputs
        out = torch.empty_like(q)
        launch = raw_launcher(att.KERNEL_BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              bias.data_ptr(), out.data_ptr(), B, H, Lq, Lk, D, split, scale,
                              stream)
        bound, bound_by = attention_bf16_bound_ms(B, H, Lq, Lk, D)
        timing["K3"] = {"shape": shape, "ms": time_ms(launch),
                        "device_ms": device_ms(launch, "attention_fwd_split_kernel<64, false"),
                        "plain_ms": time_ms(lambda: att.composed_attention(q, k, v, bias, scale)),
                        **library_times(lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, scale=scale)),
                        "bound_ms": bound, "bound_by": bound_by}
        launch = raw_launcher(att.DROPOUT_KERNEL_BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              bias.data_ptr(), out.data_ptr(), B, H, Lq, Lk, D, split, scale,
                              seed, att.dropout_threshold(rate), 1.0 / (1.0 - rate), stream)
        timing["K4"] = {"shape": shape + f" p={rate}", "ms": time_ms(launch),
                        "device_ms": device_ms(launch, "attention_fwd_split_kernel<64, true"),
                        "plain_ms": time_ms(lambda: att.composed_attention_dropout(
                            q, k, v, bias, seed, scale, rate)),
                        **library_times(lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, dropout_p=rate, scale=scale)),
                        "bound_ms": bound, "bound_by": bound_by}
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        n_kblocks = -(-Lk // att.BWD_BLOCK_KEYS)
        stats = torch.empty(3 * n_kblocks * B * H * Lq, device=device)
        dq_part = torch.empty(n_kblocks * B * H * Lq * D, device=device)
        launch = raw_launcher(att.BWD_KERNEL_BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              bias.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), None, stats.data_ptr(), dq_part.data_ptr(), B, H, Lq,
                              Lk, D, n_kblocks, scale, 1, seed, att.dropout_threshold(rate),
                              1.0 / (1.0 - rate), stream)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def library_bwd():
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate,
                                               scale=scale)
            torch.autograd.grad(o, leaves, g)

        # each wrapper's call on the card: its kernel's launches and nothing
        # else (no memset of dk and dv, no cast afterwards)
        own_launches_per_call(lambda: att.flash_attention(q, k, v, bias, scale),
                              ("attention_fwd_split_kernel",), 1, "K3 bf16 flash_attention")
        own_launches_per_call(
            lambda: att.flash_attention_dropout(q, k, v, bias, seed, scale, rate),
            ("attention_fwd_split_kernel",), 1, "K4 bf16 flash_attention_dropout")
        own_launches_per_call(lambda: att.attention_bwd(q, k, v, bias, seed, scale, rate, g),
                              ("attention_bwd_bf16_kernel", "dq_sum_kernel"), 3,
                              "K5 bf16 attention_bwd")
        bound, bound_by = attention_bf16_bound_ms(B, H, Lq, Lk, D, backward=True)
        timing["K5"] = {"shape": shape + f" p={rate}", "ms": time_ms(launch),
                        "device_ms": device_ms(launch, ("attention_bwd_bf16_kernel",
                                                        "dq_sum_kernel")),
                        "plain_ms": time_ms(lambda: att.composed_attention_bwd(
                            q, k, v, bias, seed, scale, rate, g, False)),
                        **library_times(library_bwd), "bound_ms": bound,
                        "bound_by": bound_by}
    # what the split design of K3/K4 could get wrong: more than one query
    # tile of 32, the self-attention route, less than one split, one key, a
    # last split of one key, eight splits, splits grown past one tile a warp
    for Lq_, Lk in ((33, 512), (70, 512), (512, 512), (20, 1), (20, 31), (20, 65), (20, 129),
                    (33, 385), (20, 1000), (20, 2049)):
        q, k, v, bias = attention_inputs(B, H, Lq_, Lk, D, gen, device, all_masked_row=Lk > 1)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        check_fwd(q, k, v, bias, 9 + Lk, " (one row fully masked)" if Lk > 1 else "")
    # rows whose later splits hold only masked keys, and a fully masked row
    q, k, v, _ = attention_inputs(B, H, Lq, 512, D, gen, device)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    check_fwd(q, k, v, masked_split_bias(B, 512, (512, 10, 0, 128, 129, 300, 384, 1), device),
              17, " (rows of 512, 10, 0, 128, 129, 300, 384 and 1 real keys)")
    # what the key-block design of K5 could get wrong: more than one query
    # tile of 32, less than one key block of 64, one key, a last block of one key
    for Lq_, Lk in ((33, 300), (70, 512), (20, 1), (20, 31), (70, 65)):
        q, k, v, bias = attention_inputs(B, H, Lq_, Lk, D, gen, device, all_masked_row=Lk > 1)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        g = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
        for r_ in (0.0, rate):
            got = att.attention_bwd(q, k, v, bias, 7, scale, r_, g, need_dbias=True)
            err = errs(got, att.composed_attention_bwd(q, k, v, bias, 7, scale, r_, g))
            print(f"K5 bf16 Lq={Lq_} Lk={Lk} rate={r_}: over dq, dk, dv, dbias max|kernel - "
                  f"plain| = {err[0]:.3e}, relative {err[1]:.3e} (tol {BF16_TOL})")
            if not (err[1] <= BF16_TOL and all(torch.isfinite(t.float()).all() for t in got)):
                raise AssertionError(f"K5 bf16 disagrees at Lq={Lq_}, Lk={Lk}, rate={r_}")
            worst["K5"] = worse(worst["K5"], err)
    return worst, timing


# bf16 K3, K4 and K5 with S queries against S keys: the decoder attention of
# futr_proposed (self and cross), (B, H, S, D) of 50salads_proposed's
# buckets and Breakfast's 2000 bucket, and a ragged S.
SELF_SHAPES = ((8, 8, 256, 64), (8, 8, 512, 64), (8, 8, 1024, 64), (8, 8, 3100, 64),
               (16, 8, 2000, 16), (8, 8, 777, 64))
SELF_TIMED = ((8, 8, 3100, 64), (16, 8, 2000, 16))   # the kernels line's rows
BWD_MANY = ("attention_bwd_many_dq_kernel", "attention_bwd_many_dkdv_kernel")   # K5's two launches
BWD_MANY_F32 = ("attention_bwd_many_f32_dq_kernel", "attention_bwd_many_f32_dkdv_kernel")   # fp32's


def time_mha_routes(B, H, S, D, gen, device, rate=0.1):
    """The decoder's bf16 ``MultiheadAttention`` (S queries against S keys,
    width H * D) on the kernels' route and on the plain route
    (``plain_attention_route``): the two routes' eval outputs with a random
    key length per row held within ``PROPOSED_E2E_TOL``; then, on full
    rows (every key valid, so the bounds count the work done), the eval
    forward (K3), the train forward (K4) and the train forward + backward
    (K4, K5), each timed by events. Returns {"K3" | "K4" | "K5": (kernels'
    route ms, plain route ms)}."""
    import torch

    from r3d_tpu_torch.models import layers

    C = H * D
    mha = layers.MultiheadAttention(C, H, rate, torch.bfloat16).to(device)
    x = torch.randn(B, S, C, generator=gen).to(device, torch.bfloat16)
    lengths = torch.randint(1, S + 1, (B,), generator=gen)
    lengths[0] = S
    ragged = (torch.arange(S)[None, :] >= lengths[:, None]).to(device)
    full = torch.zeros(B, S, dtype=torch.bool, device=device)
    g = torch.randn(B, S, C, generator=gen).to(device, torch.bfloat16)
    leaf = x.clone().requires_grad_()

    def eval_fwd(pad=full):
        with torch.no_grad():
            return mha.eval()(x, x, x, pad)

    def train_fwd():
        with torch.no_grad():
            return mha.train()(x, x, x, full)

    def train_step():
        mha.train()
        out = mha(leaf, leaf, leaf, full)
        torch.autograd.grad(out, [leaf] + list(mha.parameters()), g)

    out, times = {}, {}
    for route, within in (("kernels", contextlib.nullcontext), ("plain", plain_attention_route)):
        with within():
            out[route] = eval_fwd(ragged).float()
            times[route] = [time_ms(fn, iters=5, warmup=2) for fn in (eval_fwd, train_fwd,
                                                                       train_step)]
        torch.cuda.empty_cache()
    err = float((out["kernels"] - out["plain"]).abs().max())
    print(f"MultiheadAttention bf16 B={B} S={S} H={H} D={D}, kernels' route vs the plain route "
          f"on the card: eval output (ragged rows) max|diff| {err:.3e} (tol {PROPOSED_E2E_TOL}); "
          f"on full rows eval forward {times['kernels'][0]:.3f} vs {times['plain'][0]:.3f} ms, "
          f"train forward {times['kernels'][1]:.3f} vs {times['plain'][1]:.3f} ms, train "
          f"forward + backward {times['kernels'][2]:.3f} vs {times['plain'][2]:.3f} ms (events, "
          "5 calls each)")
    if not err <= PROPOSED_E2E_TOL:
        raise AssertionError(f"MultiheadAttention at S={S}: the kernels' route disagrees with "
                             "the plain route")
    return {name: (times["kernels"][i], times["plain"][i])
            for i, name in enumerate(("K3", "K4", "K5"))}


def check_attention_bf16_self(gen, device):
    """bf16 K3, K4 and K5 at Lq = Lk = S (``SELF_SHAPES``), where they take
    the many-query bodies, each against its plain version with random key
    lengths per row, every tensor within ``SELF_TOL`` of its own largest
    entry, twice bit-equal; K5 at rate 0 and 0.1. Each shape timed on full
    rows (every key valid, so that the bounds count the work the calls do):
    the kernels (events around their C launchers, the profiler's device
    time; K4 as training calls it, with the fp32 output and keep bits for
    the backward, and without; K5's dq launch apart), the plain versions,
    SDPA (forward,
    and forward + backward for K5), the bounds, and K5's peak memory in a
    wrapper call; at S = 1,024 one call of each audited as its own launches
    (1, 1 and 2); at the ``SELF_TIMED`` shapes also the decoder's attention
    module on the kernels' route against the plain route
    (``time_mha_routes``). Then the A/B that sets ``MANY_QUERY_MIN``
    (``many_query_threshold_ab``). Returns (worst (abs, rel) error per
    kernel, timing per kernel and shape)."""
    import torch
    import torch.nn.functional as F

    from r3d_tpu_torch.ops import attention as att

    rate = 0.1
    worst = {"K3": (0.0, 0.0), "K4": (0.0, 0.0), "K5": (0.0, 0.0)}
    timing = {"K3": {}, "K4": {}, "K5": {}}
    stream = torch.cuda.current_stream().cuda_stream
    for B, H, S, D in SELF_SHAPES:
        scale = 1.0 / math.sqrt(D)
        q, k, v, bias = attention_inputs(B, H, S, S, D, gen, device)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        g = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
        seed = 3000 + S
        label = f"B={B} H={H} Lq=Lk={S} D={D}"
        for name, fn, plain in (
                ("K3", lambda: att.flash_attention(q, k, v, bias, scale),
                 lambda: att.composed_attention(q, k, v, bias, scale)),
                ("K4", lambda: att.flash_attention_dropout(q, k, v, bias, seed, scale, rate),
                 lambda: att.composed_attention_dropout(q, k, v, bias, seed, scale, rate))):
            got = fn()
            err = errs_own([got], [plain()])
            print(f"{name} bf16 {label}: max|kernel - plain| = {err[0]:.3e}, over max|plain| "
                  f"{err[1]:.3e} (tol {SELF_TOL}); max|plain| {err[2]:.3e}, RMS {err[3]:.3e}")
            if not (err[1] <= SELF_TOL and torch.isfinite(got.float()).all()):
                raise AssertionError(f"{name} bf16 disagrees with its plain version at {label}")
            if not torch.equal(got, fn()):
                raise AssertionError(f"{name} bf16 is not deterministic at {label}")
            worst[name] = worse(worst[name], err[:2])
            del got
            torch.cuda.empty_cache()
        for r_ in (0.0, rate):
            got = att.attention_bwd(q, k, v, bias, seed, scale, r_, g, need_dbias=True)
            err = errs_own(got, att.composed_attention_bwd(q, k, v, bias, seed, scale, r_, g))
            print(f"K5 bf16 {label} rate={r_}: over dq, dk, dv, dbias max|kernel - plain| = "
                  f"{err[0]:.3e}, over each one's max|plain| {err[1]:.3e} (tol {SELF_TOL}); "
                  f"least max|plain| {err[2]:.3e}, least RMS {err[3]:.3e}")
            if not (err[1] <= SELF_TOL and all(torch.isfinite(t.float()).all() for t in got)):
                raise AssertionError(f"K5 bf16 disagrees at {label}, rate={r_}")
            worst["K5"] = worse(worst["K5"], err[:2])
            torch.cuda.empty_cache()
        again = att.attention_bwd(q, k, v, bias, seed, scale, rate, g, need_dbias=True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K5 bf16 is not deterministic at {label}")
        del got, again
        torch.cuda.empty_cache()
        if (B, H, S, D) not in SELF_TIMED and S not in (256, 512, 1024):
            continue
        big = S > 1024
        iters = 10 if big else 50
        bias = torch.zeros_like(bias)     # full rows
        mask = bias == 0
        out = torch.empty_like(q)
        out32 = torch.empty(q.shape, device=device)
        stats = torch.empty(2, B * H, S, device=device)
        keep_bits = torch.empty(att.keep_bits_shape(B, H, S, S), dtype=torch.int32, device=device)
        shape = f"{label} bf16, full rows"
        fwd_bound = attention_bf16_bound_ms(B, H, S, S, D)
        bwd_bound = attention_bf16_bound_ms(B, H, S, S, D, backward=True)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr())
        launch = raw_launcher(att.KERNEL_BF16_MANY, *ptrs, None, stats.data_ptr(), B, H, S, S, D,
                              scale, stream)
        timing["K3"][S] = {
            "shape": shape, "ms": time_ms(launch, iters=iters),
            "device_ms": device_ms(launch, f"attention_fwd_many_kernel<{D}, false, false"),
            "plain_ms": time_ms(lambda: att.composed_attention(q, k, v, bias, scale), iters=5),
            **library_times(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                   scale=scale), iters=iters),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]}
        drop = (seed, att.dropout_threshold(rate), 1.0 / (1.0 - rate), stream)
        # K4 as a training step calls it, keeping the fp32 output and keep bits
        launch = raw_launcher(att.DROPOUT_KERNEL_BF16_MANY, *ptrs, out32.data_ptr(),
                              stats.data_ptr(), keep_bits.data_ptr(), B, H, S, S, D, scale, *drop)
        eval_launch = raw_launcher(att.DROPOUT_KERNEL_BF16_MANY, *ptrs, None, stats.data_ptr(),
                                   None, B, H, S, S, D, scale, *drop)
        timing["K4"][S] = {
            "shape": shape + f" p={rate}, with out32", "ms": time_ms(launch, iters=iters),
            "device_ms": device_ms(launch, f"attention_fwd_many_kernel<{D}, true, true"),
            "no_out32_device_ms": device_ms(eval_launch,
                                            f"attention_fwd_many_kernel<{D}, true, false"),
            "plain_ms": time_ms(lambda: att.composed_attention_dropout(
                q, k, v, bias, seed, scale, rate), iters=3),
            **library_times(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=rate, scale=scale), iters=iters),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]}
        launch()
        del out
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(B * H, S, device=device)
        launch = raw_launcher(att.BWD_KERNEL_BF16_MANY, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              bias.data_ptr(), g.data_ptr(), out32.data_ptr(), stats.data_ptr(),
                              keep_bits.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                              dk.data_ptr(), dv.data_ptr(), None, B, H, S, S, D, scale, 1,
                              1.0 / (1.0 - rate), stream)
        k5_ms = time_ms(launch, iters=iters)
        k5_device = device_ms(launch, BWD_MANY)
        k5_dq = device_ms(launch, "attention_bwd_many_dq_kernel")
        del dq, dk, dv, delta
        saved = (stats, out32, keep_bits)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        att.attention_bwd(q, k, v, bias, seed, scale, rate, g, saved=saved)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if S == 1024:   # one wrapper call on the card: its own launches, nothing else
            own_launches_per_call(lambda: att.flash_attention(q, k, v, bias, scale),
                                  ("attention_fwd_many_kernel",), 1, f"K3 bf16 {label}")
            own_launches_per_call(
                lambda: att.flash_attention_dropout(q, k, v, bias, seed, scale, rate),
                ("attention_fwd_many_kernel",), 1, f"K4 bf16 {label}")
            own_launches_per_call(
                lambda: att.attention_bwd(q, k, v, bias, seed, scale, rate, g, saved=saved),
                BWD_MANY, 2, f"K5 bf16 {label}")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def library_bwd():
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate,
                                               scale=scale)
            torch.autograd.grad(o, leaves, g)

        timing["K5"][S] = {
            "shape": shape + f" p={rate}", "ms": k5_ms, "device_ms": k5_device,
            "dq_launch_device_ms": k5_dq,
            "plain_ms": time_ms(lambda: att.composed_attention_bwd(
                q, k, v, bias, seed, scale, rate, g, False), iters=3),
            **library_times(library_bwd, iters=iters),
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "peak_bytes": peak}
        if (B, H, S, D) in SELF_TIMED:
            for name, (route_ms, plain_route_ms) in time_mha_routes(B, H, S, D, gen,
                                                                    device).items():
                timing[name][S].update(route_ms=route_ms, plain_route_ms=plain_route_ms)
        for name in ("K3", "K4", "K5"):
            t = timing[name][S]
            print(f"{name} bf16 {t['shape']}: kernel {t['ms']:.4f} ms by events, "
                  f"{fmt_ms(t['device_ms'])} on the device; plain {t['plain_ms']:.3f}; SDPA "
                  f"{t['library_ms']:.4f} / {fmt_ms(t['library_device_ms'])}; bound "
                  f"{t['bound_ms']:.4f} ({t['bound_by']})"
                  + {"K4": f"; without out32 {fmt_ms(t.get('no_out32_device_ms'))} on the device",
                     "K5": f"; the dq launch {fmt_ms(t.get('dq_launch_device_ms'))} on the "
                           f"device; peak of a wrapper call {peak / 1e9:.4f} GB"}.get(name, ""))
        del leaves, saved, stats, out32, keep_bits
        torch.cuda.empty_cache()
    many_query_threshold_ab(gen, device)
    return worst, timing


def many_query_threshold_ab(gen, device, B=8, H=8, Lk=256, D=64):
    """Which bf16 body an Lq takes (``MANY_QUERY_MIN``): the few-query and
    the many-query K3 and K5 (rate 0) launched by hand on the same inputs at
    Lk = 256, Lq = 20-256, device time each."""
    import torch

    from r3d_tpu_torch.ops import attention as att

    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    for Lq in (20, 32, 33, 48, 64, 128, 256):
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        g = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
        out, out32 = torch.empty_like(q), torch.empty(q.shape, device=device)
        stats = torch.empty(2, B * H, Lq, device=device)
        qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr())
        few = raw_launcher(att.KERNEL_BF16, *qkv, out.data_ptr(), B, H, Lq, Lk, D,
                           att.fwd_split_keys(Lk), scale, stream)
        many = raw_launcher(att.KERNEL_BF16_MANY, *qkv, out.data_ptr(), None, stats.data_ptr(), B,
                            H, Lq, Lk, D, scale, stream)
        raw_launcher(att.KERNEL_BF16_MANY, *qkv, out.data_ptr(), out32.data_ptr(),
                     stats.data_ptr(), B, H, Lq, Lk, D, scale, stream)()
        nkb = -(-Lk // att.BWD_BLOCK_KEYS)
        block_stats = torch.empty(3 * nkb * B * H * Lq, device=device)
        part = torch.empty(nkb * B * H * Lq * D, device=device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(B * H * Lq, device=device)
        grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None)
        few_b = raw_launcher(att.BWD_KERNEL_BF16, *qkv, g.data_ptr(), *grads,
                             block_stats.data_ptr(), part.data_ptr(), B, H, Lq, Lk, D, nkb,
                             scale, 0, 0, 0, 1.0, stream)
        many_b = raw_launcher(att.BWD_KERNEL_BF16_MANY, *qkv, g.data_ptr(), out32.data_ptr(),
                              stats.data_ptr(), None, delta.data_ptr(), *grads, B, H, Lq, Lk, D,
                              scale, 0, 1.0, stream)
        t = [device_ms(fn, names) for fn, names in (
            (few, "attention_fwd_split_kernel"), (many, "attention_fwd_many_kernel"),
            (few_b, ("attention_bwd_bf16_kernel", "dq_sum_kernel")), (many_b, BWD_MANY))]
        print(f"threshold A/B bf16 B={B} H={H} Lq={Lq} Lk={Lk} D={D} (MANY_QUERY_MIN "
              f"{att.MANY_QUERY_MIN}): K3 few-query {fmt_ms(t[0])} / many-query {fmt_ms(t[1])} "
              f"ms, K5 few-query {fmt_ms(t[2])} / many-query {fmt_ms(t[3])} ms on the device")


def check_cross_attention_kernels(gen, device):
    """K6 and K7 against their plain versions: fp32 and bf16; B = 8, H = 8;
    (Lq, C) = (20, 512) and (8, 128); S = 1024, 3100, a ragged 777, 257 (a
    last split of one key), 31 and 1, each with padded key tails and (S > 1)
    a fully masked row; rows whose later splits are all masked; two calls of
    each bit-equal; rate 0 and 0.1 (the keep rate, and K7 under the same
    seed agreeing with the plain backward, which redraws the plain forward's
    mask). One bf16 K7 call audited as its two launches. Timed at the
    50salads shape: B = 8, Lq = 20, S = 3100, C = 512, bf16; and in fp32 at
    the utkinects shape (B = 8, Lq = 8, C = 128, S = 1,024 and 2,000), where
    they are also held to their plain versions and audited as one launch a
    call (``time_cross_fp32``).
    Returns (worst error, timing) of K6 and K7 in bf16, then in fp32 (timed
    at S = 2,000)."""
    import ctypes

    import torch

    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca

    B, H, rate = 8, 8, 0.1
    tols = {torch.float32: (CROSS_FWD_TOL, CROSS_BWD_TOL), torch.bfloat16: (BF16_TOL, BF16_TOL)}
    worst = {(dt, d): (0.0, 0.0) for dt in tols for d in ("fwd", "bwd")}
    for dtype, (ftol, btol) in tols.items():
        for Lq, C in ((20, 512), (8, 128)):
            scale = 1.0 / math.sqrt(C // H)
            for S in (1024, 3100, 777, 257, 31, 1):
                q, k, v, bias = cross_inputs(B, Lq, S, C, gen, device, dtype,
                                             all_masked_row=S > 1)
                g = torch.randn(q.shape, generator=gen).to(device, dtype)
                for r_ in (0.0, rate):
                    seed = 3000 + S + int(r_ > 0)
                    out, m, l = ca.cross_attention_fwd(q, k, v, bias, seed, scale, r_, H)
                    want = ca.composed_cross_attention(q, k, v, bias, seed, scale, r_, H)
                    e_out = errs([out], want[:1])
                    e_ml = max(float(((m - want[1]) / want[1].abs().clamp_min(1.0)).abs().max()),
                               float(((l - want[2]) / want[2].abs().clamp_min(1.0)).abs().max()))
                    got_b = ca.cross_attention_bwd(q, k, v, bias, seed, scale, r_, H, g, out, m,
                                                   l, need_dbias=True)
                    want_b = ca.composed_cross_attention_bwd(q, k, v, bias, seed, scale, r_, H,
                                                             g, out, m, l)
                    e_b = errs(got_b, want_b)
                    torch.cuda.synchronize()
                    kept = ""
                    if r_ > 0:
                        keep = att.dropout_keep(seed, r_, (B, H, Lq, S), device) > 0
                        kept = f", keep rate {float(keep.float().mean()):.4f}"
                    if not all(torch.equal(a, b) for a, b in zip(
                            (out, m, l), ca.cross_attention_fwd(q, k, v, bias, seed, scale, r_, H))):
                        raise AssertionError(f"K6 is not deterministic at {dtype} S={S}")
                    if not all(torch.equal(a, b) for a, b in zip(got_b, ca.cross_attention_bwd(
                            q, k, v, bias, seed, scale, r_, H, g, out, m, l, need_dbias=True))):
                        raise AssertionError(f"K7 is not deterministic at {dtype} S={S}")
                    print(f"cross_attention {str(dtype)[6:]} Lq={Lq} C={C} S={S} rate={r_} "
                          f"(padded tails, one row fully masked): out max|kernel - plain| "
                          f"{e_out[0]:.3e}, relative {e_out[1]:.3e} (tol {ftol}); m and l "
                          f"relative {e_ml:.3e} (tol 1e-5); backward over dq, dk, dv, dbias "
                          f"{e_b[0]:.3e}, relative {e_b[1]:.3e} (tol {btol}){kept}")
                    if not (e_out[1] <= ftol and e_ml <= 1e-5 and e_b[1] <= btol
                            and torch.isfinite(out.float()).all()):
                        raise AssertionError(f"K6/K7 disagree with their plain versions at "
                                             f"{dtype} Lq={Lq} C={C} S={S} rate={r_}")
                    worst[dtype, "fwd"] = worse(worst[dtype, "fwd"], e_out)
                    worst[dtype, "bwd"] = worse(worst[dtype, "bwd"], e_b)

    # rows whose later splits hold only masked keys (10 and 300 real keys of
    # 1,024) and a row with none: weight 0 in the combine, not NaN; K7 on
    # the same rows, twice bit-equal
    from r3d_tpu_torch.models.layers import attention_bias_from_padding

    scale = 0.125
    for dtype, (ftol, btol) in tols.items():
        q, k, v, _ = cross_inputs(4, 20, 1024, 512, gen, device, dtype)
        g = torch.randn(q.shape, generator=gen).to(device, dtype)
        lengths = torch.tensor([1024, 10, 0, 300])
        bias = attention_bias_from_padding(
            (torch.arange(1024)[None, :] >= lengths[:, None]).to(device))
        for r_ in (0.0, rate):
            out, m, l = ca.cross_attention_fwd(q, k, v, bias, 11, scale, r_, H)
            want = ca.composed_cross_attention(q, k, v, bias, 11, scale, r_, H)
            e_out = errs([out], want[:1])
            e_ml = max(float(((m - want[1]) / want[1].abs().clamp_min(1.0)).abs().max()),
                       float(((l - want[2]) / want[2].abs().clamp_min(1.0)).abs().max()))
            got_b = ca.cross_attention_bwd(q, k, v, bias, 11, scale, r_, H, g, out, m, l,
                                           need_dbias=True)
            e_b = errs(got_b, ca.composed_cross_attention_bwd(q, k, v, bias, 11, scale, r_, H,
                                                              g, out, m, l))
            print(f"cross_attention {str(dtype)[6:]} S=1024, rows of 1024, 10, 0 and 300 real "
                  f"keys, rate={r_}: out relative {e_out[1]:.3e} (tol {ftol}), m and l relative "
                  f"{e_ml:.3e} (tol 1e-5); backward over dq, dk, dv, dbias relative "
                  f"{e_b[1]:.3e} (tol {btol})")
            if not (e_out[1] <= ftol and e_ml <= 1e-5 and torch.isfinite(out.float()).all()):
                raise AssertionError(f"K6 disagrees under masked splits at {dtype}, rate={r_}")
            if not (e_b[1] <= btol and all(torch.isfinite(t.float()).all() for t in got_b)):
                raise AssertionError(f"K7 disagrees under masked splits at {dtype}, rate={r_}")
            if not all(torch.equal(a, b) for a, b in zip(got_b, ca.cross_attention_bwd(
                    q, k, v, bias, 11, scale, r_, H, g, out, m, l, need_dbias=True))):
                raise AssertionError(f"K7 is not deterministic under masked splits at {dtype}")
            worst[dtype, "fwd"] = worse(worst[dtype, "fwd"], e_out)
            worst[dtype, "bwd"] = worse(worst[dtype, "bwd"], e_b)

    # timings at the 50salads shape, bf16
    Lq, S, C = 20, 3100, 512
    D = C // H
    scale = 1.0 / math.sqrt(D)
    q, k, v, bias = cross_inputs(B, Lq, S, C, gen, device, torch.bfloat16)
    g = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 0, scale, 0.0, H)
    split_keys = ca.fwd_split_keys(
        S, B * H, torch.cuda.get_device_properties(device).multi_processor_count)
    fwd_part = torch.empty(-(-S // split_keys) * B * H * Lq * (D + 2), device=device)
    print(f"  K6 bf16 at S={S}: {-(-S // split_keys)} splits of {split_keys} keys")
    launch = raw_launcher(ca.FWD_KERNEL, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
                          fwd_part.data_ptr(), split_keys, B, Lq, S, H, D, scale, 0, 0, 0, 1.0,
                          stream)
    library, library_bwd = cross_library(q, k, v, bias, g, H, scale)
    lib_err = errs([library()], [ca.composed_cross_attention(q, k, v, bias, 0, scale, 0.0, H)[0]])
    print(f"  scaled_dot_product_attention with relayouts (yardstick only): "
          f"max|lib - plain| = {lib_err[0]:.3e}")
    shape = f"B={B} Lq={Lq} S={S} C={C} H={H} bf16"
    bound, bound_by = cross_bound_ms(B, Lq, S, C, H, 2)
    t6 = {"shape": shape, "ms": time_ms(launch),
          "device_ms": device_ms(launch, ("cross_fwd_split_kernel", "cross_fwd_combine_kernel")),
          "plain_ms": time_ms(lambda: ca.composed_cross_attention(q, k, v, bias, 0, scale, 0.0,
                                                                  H)),
          **library_times(library), "bound_ms": bound, "bound_by": bound_by}
    split_keys = ca.bwd_split_keys(
        S, B * H, torch.cuda.get_device_properties(device).multi_processor_count)
    part = torch.empty(ca.bwd_scratch_shape(S, B, Lq, C, H, split_keys, False), device=device)
    per_sm = ctypes.c_int()
    err = ca.BWD_KERNEL.query("r3d_cross_attention_bwd_occupancy",
                              [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])(
        D, 0, ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"r3d_cross_attention_bwd_occupancy: CUDA error {err}")
    print(f"  K7 bf16 at S={S}: grid ({B * H}, {-(-S // split_keys)}), splits of {split_keys} "
          f"keys, {per_sm.value} blocks an SM")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch = raw_launcher(ca.BWD_KERNEL, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), g.data_ptr(), out.data_ptr(), m.data_ptr(),
                          l.data_ptr(), part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), None, B, Lq, S, H, D, split_keys, scale, 0, 0, 0, 1.0,
                          stream)
    own_launches_per_call(
        lambda: ca.cross_attention_bwd(q, k, v, bias, 0, scale, 0.0, H, g, out, m, l),
        ("cross_bwd_bf16_kernel", "cross_bwd_sum_kernel"), 2, "K7 bf16 cross_attention_bwd")
    bound, bound_by = cross_bound_ms(B, Lq, S, C, H, 2, backward=True)
    t7 = {"shape": shape, "ms": time_ms(launch, iters=20),
          "device_ms": device_ms(launch, ("cross_bwd_bf16_kernel", "cross_bwd_sum_kernel")),
          "plain_ms": time_ms(lambda: ca.composed_cross_attention_bwd(
              q, k, v, bias, 0, scale, 0.0, H, g, out, m, l, False), iters=20),
          **library_times(library_bwd, iters=20), "bound_ms": bound, "bound_by": bound_by}
    t6f, t7f = {S: time_cross_fp32(gen, device, S) for S in (1024, 2000)}[2000]
    return ((worst[torch.bfloat16, "fwd"], t6), (worst[torch.bfloat16, "bwd"], t7),
            (worst[torch.float32, "fwd"], t6f), (worst[torch.float32, "bwd"], t7f))


def cross_library(q, k, v, bias, g, H, scale):
    """The library yardsticks of K6 and K7 on native-layout q [B, Lq, C],
    k, v [B, S, C]: SDPA on head-major copies with the output back in native
    layout, and that forward with its backward under ``g``."""
    import torch
    import torch.nn.functional as F

    B, Lq, C = q.shape
    D = C // H
    mask = (bias == 0)   # SDPA's bool mask (True = attend)
    heads = lambda x: x.view(B, x.shape[1], H, D).transpose(1, 2).contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def library():
        o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask,
                                           scale=scale)
        return o.transpose(1, 2).reshape(B, Lq, C)

    def library_bwd():
        o = F.scaled_dot_product_attention(*(heads(t) for t in leaves), attn_mask=mask,
                                           scale=scale)
        torch.autograd.grad(o.transpose(1, 2).reshape(B, Lq, C), leaves, g)

    return library, library_bwd


def cross_fp32_kernel_names(D):
    """What the profiler's names of fp32 K6's and K7's kernels (head dim D,
    no dropout) hold: the cluster bodies on the native layout."""
    return (f"attention_fwd_cluster_kernel<{D}, false, true",
            f"attention_bwd_cluster_kernel<{D}, false, true")


def cross_fp32_clusters(B, H, Lq, S, D, fwd_split, bwd_split):
    """How many clusters of the fp32 K6 and K7 launches at these sizes the
    card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    from r3d_tpu_torch.ops import cross_attention as ca

    out = [ctypes.c_int(), ctypes.c_int()]
    err = ca.FWD_KERNEL.query("r3d_cross_attention_fwd_clusters",
                              [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])(
        B, H, Lq, S, D, fwd_split, ctypes.byref(out[0]))
    err = err or ca.BWD_KERNEL.query("r3d_cross_attention_bwd_clusters",
                                     [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])(
        B, H, S, D, bwd_split, 1, ctypes.byref(out[1]))
    if err:
        raise RuntimeError(f"r3d_cross_attention_*_clusters: CUDA error {err}")
    return out[0].value, out[1].value


def time_cross_fp32(gen, device, S, B=8, Lq=8, C=128, H=8):
    """K6 and K7 in fp32 at the shape ``R3D_CROSS_NATIVE=1`` gives them on
    the utkinects path (its 1024 and 2000 buckets: B = 8, Lq = 8, C = 128,
    H = 8): held to their plain versions (rate 0.1), how many of their
    clusters the card holds at once, events, device time, bound and the
    library yardsticks. Their device times fall in two modes about 1.8x
    apart from one turn to the next, so each is read in ``FP32_CROSS_TURNS``
    turns, with the card's SM clock and power while each turn's kernel keeps
    it busy: ``device_ms`` is the median, ``device_min_ms`` the least.
    Returns the two timings (K6, K7)."""
    import torch

    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca

    D = C // H
    scale = 1.0 / math.sqrt(D)
    q, k, v, bias = cross_inputs(B, Lq, S, C, gen, device, torch.float32)
    g = torch.randn(q.shape, generator=gen).to(device)
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 7, scale, 0.1, H)
    want = ca.composed_cross_attention(q, k, v, bias, 7, scale, 0.1, H)
    got_b = ca.cross_attention_bwd(q, k, v, bias, 7, scale, 0.1, H, g, out, m, l)
    e_f = errs([out, m, l], want)
    e_b = errs(got_b[:3], ca.composed_cross_attention_bwd(q, k, v, bias, 7, scale, 0.1, H, g, out,
                                                          m, l, False)[:3])
    fwd_split = bwd_split = att.fp32_split_keys(S)
    at_once = cross_fp32_clusters(B, H, Lq, S, D, fwd_split, bwd_split)
    print(f"cross_attention fp32 B={B} Lq={Lq} S={S} C={C} H={H} rate=0.1: out, m, l relative "
          f"{e_f[1]:.3e} (tol {CROSS_FWD_TOL}); backward {e_b[1]:.3e} (tol {CROSS_BWD_TOL}); K6 "
          f"{-(-S // fwd_split)} splits of {fwd_split}, {-(-S // fwd_split) * B * H} blocks, "
          f"{at_once[0]} clusters at once; K7 {-(-S // bwd_split)} splits of {bwd_split}, "
          f"{at_once[1]} clusters at once (of {B * H})")
    if not (e_f[1] <= CROSS_FWD_TOL and e_b[1] <= CROSS_BWD_TOL):
        raise AssertionError(f"fp32 K6/K7 disagree with their plain versions at S={S}")
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 0, scale, 0.0, H)
    library, library_bwd = cross_library(q, k, v, bias, g, H, scale)
    shape = f"B={B} Lq={Lq} S={S} C={C} H={H} fp32"
    stream = torch.cuda.current_stream().cuda_stream
    fwd_name, bwd_name = cross_fp32_kernel_names(D)
    launch = raw_launcher(ca.FWD_KERNEL_FP32, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), None,
                          fwd_split, B, Lq, S, H, D, scale, 0, 0, 0, 1.0, stream)
    bound, bound_by = cross_bound_ms(B, Lq, S, C, H, 4)
    t6 = {"shape": shape, "ms": time_ms(launch), **device_turns(launch, fwd_name),
          "plain_ms": time_ms(lambda: ca.composed_cross_attention(q, k, v, bias, 0, scale, 0.0,
                                                                  H)),
          **library_times(library), "bound_ms": bound, "bound_by": bound_by}
    own_launches_per_call(lambda: ca.cross_attention_fwd(q, k, v, bias, 0, scale, 0.0, H),
                          (fwd_name,), 1, "K6 fp32 cross_attention")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch = raw_launcher(ca.BWD_KERNEL_FP32, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), g.data_ptr(), out.data_ptr(), m.data_ptr(),
                          l.data_ptr(), None, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None,
                          B, Lq, S, H, D, bwd_split, scale, 0, 0, 0, 1.0, stream)
    own_launches_per_call(
        lambda: ca.cross_attention_bwd(q, k, v, bias, 0, scale, 0.0, H, g, out, m, l),
        (bwd_name,), 1, "K7 fp32 cross_attention_bwd")
    bound, bound_by = cross_bound_ms(B, Lq, S, C, H, 4, backward=True)
    t7 = {"shape": shape, "ms": time_ms(launch, iters=20), **device_turns(launch, bwd_name),
          "plain_ms": time_ms(lambda: ca.composed_cross_attention_bwd(
              q, k, v, bias, 0, scale, 0.0, H, g, out, m, l, False), iters=20),
          **library_times(library_bwd, iters=20), "bound_ms": bound, "bound_by": bound_by}
    for name, t in (("K6", t6), ("K7", t7)):
        print(f"{name} fp32 {shape}: {t['ms']:.4f} ms by events, {t['device_ms']:.4f} on the "
              f"device (median of {len(t['turns'])} turns, least {t['device_min_ms']:.4f}; each "
              "turn's ms at the SM clock and power read while it ran: "
              + ", ".join(f"{ms:.4f} at {clock}" for ms, clock in t["turns"])
              + f"); bound {t['bound_ms']:.4f} ({t['bound_by']}); SDPA with relayouts"
              f"{' forward + backward' if name == 'K7' else ''} {t['library_ms']:.4f} by "
              f"events, {t['library_device_ms']:.4f} on the device; plain {t['plain_ms']:.4f}")
    return t6, t7


def make_videos(rng, lengths, cfg):
    """Request videos of the config's layout: features, and raw depth frames
    for the fusion configs."""
    D = cfg.model.input_dim
    with_depth = cfg.data.depth_features_dir is not None
    return [{"features": rng.standard_normal((n, D), dtype=np.float32),
             **({"depth": rng.random((n,) + tuple(cfg.data.depth_shape), dtype=np.float32)}
                if with_depth else {})}
            for n in lengths]


def serve(session, kernels, cfg, rng, groups):
    """Answer requests through ServingQueue, bucket by bucket (``groups``:
    bucket -> request lengths), with every launch count set to 0 first
    (after a warm-up of the same chunks). Returns per-bucket latencies, the
    counts of the whole run and the launches of each bucket."""
    videos = {S: make_videos(rng, lens, cfg) for S, lens in groups.items()}
    return serve_videos(session, kernels, cfg, videos)[:3]


def serve_videos(session, kernels, cfg, videos):
    """``serve`` of given request videos (bucket -> videos); also returns
    the results, bucket -> the results in request order."""
    import torch

    from r3d_tpu_torch.serving import ServingQueue

    # warm-up at the same chunk shapes: cuBLAS plans, the device allocator
    # and the pinned host buffers (the first pinned 157 MB costs ~70 ms)
    for S, vids in videos.items():
        session.anticipate_batch(vids)
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    latencies, per_bucket, results = {}, {}, {}
    q = ServingQueue(session, max_wait_ms=20)
    try:
        for S, vids in videos.items():
            before = {k.name: k.launches for k in kernels}
            t0 = time.perf_counter()
            futs = [q.submit(v["features"], v.get("depth")) for v in vids]
            done, results[S] = [], []
            for v, f in zip(vids, futs):
                res = f.result(timeout=600)
                done.append(time.perf_counter() - t0)
                results[S].append(res)
                n = v["features"].shape[0]
                shapes = {"transcript": (cfg.model.n_query,), "durations": (cfg.model.n_query,),
                          "future_frames": (n,), "seg": (n,)}
                for key, shape in shapes.items():
                    if res[key].shape != shape or not np.all(np.isfinite(res[key])):
                        raise AssertionError(f"bucket {S}: {key} has shape "
                                             f"{res[key].shape} (want {shape}) or is not finite")
            latencies[S] = {"requests": len(vids), "p50_ms": 1e3 * float(np.median(done)),
                            "max_ms": 1e3 * max(done)}
            per_bucket[S] = {k.name: k.launches - before[k.name] for k in kernels}
    finally:
        q.close()
    counts = {k.name: k.launches for k in kernels}
    return latencies, counts, per_bucket, results


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
    events = sorted(card_events(prof), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"bucket {S} chunk of 8: collate {1e3 * (t1 - t0):.2f} ms, copy + forward "
          f"{1e3 * (t2 - t1):.2f} ms (profiled {1e3 * (t3 - t2):.2f} ms, card busy "
          f"{busy_ms:.2f} ms)")
    for e in events[:6]:
        print(f"  {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}")


def compare_with_cpu(session, cfg, state_dict, rng, n_class=N_CLASS,
                     lengths=(256, 200, 129, 250, 177, 240, 210, 255), tol=E2E_TOL, **kw):
    """The card's outputs for one chunk vs the same session on the CPU
    (``kw``: its ``quantize`` and ``input_dtype``), where every attention
    runs its plain composed form."""
    import torch

    from r3d_tpu_torch.data.pipeline import bucket_length
    from r3d_tpu_torch.serving import InferenceSession

    S = bucket_length(max(lengths), cfg.data.seq_buckets)
    vids = make_videos(rng, lengths, cfg)
    batch = session._collate(vids, S)
    got = {k: v.float().cpu() for k, v in session._run(*batch).items()}
    cpu = InferenceSession(cfg, state_dict, n_class, max_batch=8, device="cpu", **kw)
    want = cpu._run(*batch)
    worst = 0.0
    for key in ("action", "duration", "seg"):
        if not torch.isfinite(got[key]).all():
            raise AssertionError(f"non-finite {key} on the card")
        err = float((got[key] - want[key]).abs().max())
        print(f"card vs CPU, {S}-bucket chunk of {len(lengths)}: max|{key}| diff = {err:.3e} "
              f"(tol {tol})")
        worst = max(worst, err)
    agree = float((got["action"].argmax(-1) == want["action"].argmax(-1)).float().mean())
    print(f"card vs CPU: transcript argmax agreement {agree:.4f}")
    if worst > tol:
        raise AssertionError("the card's outputs disagree with the CPU run")
    return worst


def train_loaders(cfg, rng_seed=SEED, n_class=N_CLASS, n_videos=12, vid_len_range=(600, 1000),
                  obs=(0.3, 0.5), val_videos=8, val_obs=(0.4,), val_batch=8):
    """Synthetic videos of the config's layout (its features, its depth
    frames where it has them, ``n_class - 1`` actions + NONE) for a train
    loader over ``n_videos`` videos at the observation ratios ``obs``
    (batch-8 steps grouped by bucket) and a validation loader. The
    utkinects defaults: observed windows in the 256 and 512 buckets, 3
    batches of 8, and 8 validation videos at one ratio."""
    from r3d_tpu_torch.data.pipeline import BucketedLoader
    from r3d_tpu_torch.data.synthetic import SyntheticSource

    with_depth = cfg.data.depth_features_dir is not None

    def loader(n_videos, obs, seed, shuffle, batch_size):
        src = SyntheticSource(n_videos=n_videos, n_actions=n_class - 1,
                              vid_len_range=vid_len_range, input_dim=cfg.model.input_dim,
                              depth_shape=tuple(cfg.data.depth_shape) if with_depth else None,
                              seed=seed)
        fn, n = src.make_example_fn(obs, 1, cfg.model.n_query)
        lengths = [int(o * len(src.videos[v]["labels"])) for v, o in src.example_table(obs)]
        return src, BucketedLoader(
            num_examples=n, make_example_fn=fn, batch_size=batch_size, pad_idx=src.pad_idx,
            buckets=cfg.data.seq_buckets, n_query=cfg.model.n_query, with_depth=with_depth,
            shuffle=shuffle, seed=seed, example_lengths=lengths,
            feature_dtype=cfg.data.feature_dtype, pin_memory=True)

    src, train = loader(n_videos, obs, rng_seed, True, 8)
    _, val = loader(val_videos, val_obs, rng_seed + 1, False, val_batch)
    return src, train, val


def on_card(prof, fragments):
    """How many launches of kernels whose names hold each of ``fragments``
    a profiler trace shows on the card; None where it shows nothing at all
    there (a trace now and then comes back without device events)."""
    events = card_events(prof)
    return {f: sum(e.count for e in events if f in e.key) for f in fragments} if events else None


def train(cfg, state_dict, kernels, loaders, want, n_class=N_CLASS, equal=(), epoch0_on_card=()):
    """fit 2 epochs on the card with every launch count set to 0 first;
    fail unless each phase of ``want`` (phase -> kernel names) launched each
    of its kernels, unless each pair of names in ``equal`` counted alike in
    every phase, and unless a profiler trace of epoch 0's training shows a
    launch of a kernel whose name holds each of ``epoch0_on_card`` (where
    that trace holds no device events, a profiled train-mode step of the
    loader's first batch stands in for it). Returns the counts of the whole
    fit."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from r3d_tpu_torch.train.loop import Trainer

    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2))
    _, train_loader, val_loader = loaders
    trainer = Trainer(cfg, n_class)
    state = trainer.init_state(len(train_loader), state_dict)
    snapshots, lines = [], []
    traced = [profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                      acc_events=True)] if epoch0_on_card else []

    def log(line):
        torch.cuda.synchronize()
        if traced and not snapshots:   # the end of epoch 0's training
            traced[0].stop()
        snapshots.append({k.name: k.launches for k in kernels})
        lines.append(line)
        print(f"  {line}")

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    if traced:
        traced[0].start()
    try:
        trainer.fit(state, train_loader, val_loader, seed=SEED, log=log)
    finally:
        if traced and not snapshots:
            traced[0].stop()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if traced:
        seen = on_card(traced[0], epoch0_on_card)
        where = "a profiler trace of epoch 0's training"
        if seen is None:
            batch = trainer.to_device(one_batch(train_loader, 0))
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             acc_events=True) as prof:
                    state.model.train()
                    state.optimizer.zero_grad(set_to_none=True)
                    trainer._grad_core(state.model, batch)
                    state.apply_gradients()
                    torch.cuda.synchronize()
                seen = on_card(prof, epoch0_on_card)
                if seen is not None:
                    break
            where = ("a profiled train-mode step (the trace of epoch 0 held no device "
                     "events)")
        print(f"launches on the card in {where}: {seen}")
        if seen is None or not all(seen.values()):
            raise AssertionError(f"{cfg.name}: epoch 0 launched no kernel named like each of "
                                 f"{list(epoch0_on_card)}: {seen}")
    counts = {k.name: k.launches for k in kernels}
    phases = ["epoch 0 train", "epoch 0 validation", "epoch 1 train", "epoch 1 validation"]
    per_phase, prev = {}, {k.name: 0 for k in kernels}
    for name, snap in zip(phases, snapshots):
        per_phase[name] = {k: snap[k] - prev[k] for k in snap if snap[k] - prev[k]}
        prev = snap
    for name, c in per_phase.items():
        print(f"launches in {name}: {c}")
    losses = [float(x) for line in lines for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
    print(f"fit ({cfg.name}): 2 epochs of {len(train_loader)} steps with validation in "
          f"{dt:.2f} s; train and validation losses {losses}")
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss of the fit is not finite: {lines}")
    for phase, names in want.items():
        missing = [n for n in names if per_phase[phase].get(n, 0) == 0]
        if missing:
            raise AssertionError(f"{cfg.name}: {phase} never launched {missing}")
    for phase, c in per_phase.items():
        for a, b in equal:
            if c.get(a, 0) != c.get(b, 0):
                raise AssertionError(f"{cfg.name}: {phase} counted {c.get(a, 0)} {a} but "
                                     f"{c.get(b, 0)} {b}")
    return counts


def train_step_on_card_and_cpu(cfg, state_dict, batch, n_class=N_CLASS, loss_tol=E2E_TOL,
                               grad_tol=GRAD_TOL, cos_min=None):
    """One dropout-off train step at lr 1e-3 (warmup 0) from the same
    weights and batch on the card and on the CPU: the loss, every gradient
    before the update (relative to its largest entry, and with ``cos_min``
    the cosine of the whole gradient vectors), and the BN running
    statistics after it."""
    import dataclasses

    import torch

    from r3d_tpu_torch.train.loop import Trainer

    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=0.0, fuser_dropout=0.0),
        train=dataclasses.replace(cfg.train, warmup_epochs=0))
    out = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, n_class, device=device)
        state = trainer.init_state(1, state_dict)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        metrics = trainer._grad_core(state.model, trainer.to_device(batch))
        grads = {k: p.grad.float().cpu() for k, p in state.model.named_parameters()
                 if p.grad is not None}
        state.apply_gradients()
        stats = {k: v.float().cpu() for k, v in state.model.state_dict().items()
                 if "running" in k}
        out[device] = (float(metrics["loss"]), grads, stats)
        del trainer, state
    (loss_c, g_c, st_c), (loss_h, g_h, st_h) = out["cuda"], out["cpu"]
    if g_c.keys() != g_h.keys():
        raise AssertionError("the card and the CPU gave gradients to different parameters")
    rel = {k: float((g_c[k] - g_h[k]).abs().max()) / max(float(g_h[k].abs().max()), 1e-30)
           for k in g_h}
    gated = {k: e for k, e in rel.items() if not k.endswith(GRAD_NOISE_ONLY)}
    worst = max(gated, key=gated.get)
    stat_diff = max((float((st_c[k] - st_h[k]).abs().max()) for k in st_c), default=0.0)
    names = sorted(g_h)
    cos = float(torch.nn.functional.cosine_similarity(   # fp64: ~10^7 entries
        torch.cat([g_c[k].double().flatten() for k in names]),
        torch.cat([g_h[k].double().flatten() for k in names]), dim=0))
    print(f"train step card vs CPU ({cfg.name}, dropout off, batch "
          f"{tuple(batch['features'].shape[:2])}): loss {loss_c:.6f} vs {loss_h:.6f} (tol "
          f"{loss_tol}); over {len(gated)} gradients max|card - CPU| / max|CPU| = "
          f"{gated[worst]:.3e} in {worst} (tol {grad_tol}; not gated, rounding noise only: "
          + ", ".join(f"{k} {e:.2e}" for k, e in rel.items() if k not in gated)
          + f"); gradient cosine {cos:.6f}"
          + (f" (min {cos_min})" if cos_min else "")
          + f"; max|BN running stat diff| {stat_diff:.3e} (tol {STAT_TOL})")
    print("  per-gradient relative error, largest 8: "
          + ", ".join(f"{k} {e:.2e}" for k, e in sorted(gated.items(), key=lambda kv: -kv[1])[:8]))
    if not (abs(loss_c - loss_h) <= loss_tol and gated[worst] <= grad_tol
            and stat_diff <= STAT_TOL and (cos_min is None or cos >= cos_min)):
        raise AssertionError(f"{cfg.name}: the card's train step disagrees with the CPU's")
    return abs(loss_c - loss_h)


def one_batch(loader, min_len, max_len=None, rows=8):
    """The first ``rows`` examples (in the loader's order) whose observed
    window is longer than ``min_len`` (and at most ``max_len``), collated."""
    from r3d_tpu_torch.data.pipeline import pad_batch

    examples = []
    for j in loader._order():
        e = loader.make_example_fn(int(j))
        if e.features.shape[0] > min_len and (max_len is None or e.features.shape[0] <= max_len):
            examples.append(e)
        if len(examples) == rows:
            break
    return pad_batch(examples, loader.pad_idx, loader.buckets, loader.n_query,
                     loader.with_depth, loader.feature_dtype, loader.pin_memory,
                     loader.with_query, loader.query_pad_idx, loader.query_pad_len)


def train_breakdown(cfg, state_dict, train_loader, min_len=256, n_class=N_CLASS, label="",
                    make_batch=None):
    """Where one train step of a batch of 8 with observed windows longer
    than ``min_len`` (or of the batch ``make_batch()`` collates) spends its
    time: host collate, H2D, forward + backward + optimizer to a
    synchronised end, and the card's busy time in that step from a profiler
    trace, with the share of the port's own kernels, in epoch 0's train mode
    and, where the loop has one, the sticky mode."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, n_class)
    state = trainer.init_state(len(train_loader), state_dict)
    t0 = time.perf_counter()
    batch = one_batch(train_loader, min_len) if make_batch is None else make_batch()
    t1 = time.perf_counter()
    dev = trainer.to_device(trainer._with_seg_ids(batch))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    B, S = batch["features"].shape[:2]
    print(f"train batch{label}, bucket {S} batch of {B}: host collate "
          f"{1e3 * (t1 - t0):.2f} ms, H2D {1e3 * (t2 - t1):.2f} ms")

    def step(epoch):
        trainer._train_mode(state.model, epoch)
        state.optimizer.zero_grad(set_to_none=True)
        trainer._grad_core(state.model, dev, epoch)
        state.apply_gradients()

    modes = ((0, "epoch 0, train mode, dropout 0.1"), (1, "sticky epoch"))
    for epoch, mode in modes if trainer.sticky_eval else modes[:1]:
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
        events = sorted(card_events(prof), key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        launches = sum(e.count for e in events)
        optim = [e for e in events if "multi_tensor_apply" in e.key]
        print(f"train step{label} ({mode}), bucket {S}: forward + backward + AdamW "
              f"median {float(np.median(times)):.2f} ms of 5 (min {min(times):.2f}), card busy "
              f"{busy_ms:.2f} ms in {launches} kernel launches (one profiled step)")
        for e in events[:8]:
            print(f"  {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}")
        print(f"  of which AdamW (its foreach multi_tensor_apply kernels): "
              f"{sum(e.self_device_time_total for e in optim) / 1e3:.3f} ms in "
              f"{sum(e.count for e in optim)} launches")
        own = [e for e in events if any(n in e.key for n in OWN_KERNELS)]
        own_ms = sum(e.self_device_time_total for e in own) / 1e3
        print(f"  of which the port's own kernels {own_ms:.3f} ms "
              f"({100 * own_ms / max(busy_ms, 1e-9):.1f} % of the card's busy time; the step's "
              f"median wall time {float(np.median(times)):.2f} ms): " + "; ".join(
                  f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
                  f"{e.key.split('::')[-1].split('(')[0][:60]}" for e in own))


# ---- utkinects under R3D_CROSS_NATIVE=1: fp32 K6 and K7 in the 1024 and 2000 buckets ----

UTK_NATIVE_SERVE = {1024: (900, 700), 2000: (1900, 1500)}


class Count:
    """A count kept beside the kernels' own, with the same two attributes
    (``name``, ``launches``), for what a kernel's count cannot tell: calls
    of a module."""

    def __init__(self, name):
        self.name, self.launches = name, 0


def utkinects_native_loaders(cfg):
    """Synthetic utkinects videos of 1,100-1,399 frames: the train loader's
    observed windows at 0.5 (550-699 frames) land in the 1024 bucket and at
    0.95 (1,045-1,329) in the 2000 bucket, one batch of 8 each; validation
    holds 2 videos at both ratios (batches of 2)."""
    return train_loaders(cfg, n_videos=8, vid_len_range=(1100, 1400), obs=(0.5, 0.95),
                         val_videos=2, val_obs=(0.5, 0.95), val_batch=2)


def utkinects_cross_native(kernels, state_dict, k6, k7):
    """Serve and train utkinects at full width with R3D_CROSS_NATIVE=1, where
    the decoder's cross-attention takes fp32 K6 (``k6``) and K7 (``k7``) in
    the 1024 and 2000 buckets: requests in both buckets, the card's logits
    against the CPU's, ``fit`` of 2 epochs (one 1024- and one 2000-bucket
    batch of 8) with validation, a dropout-off step on the card against the
    CPU, the parts of a 2000-bucket step and the on/off A/B there. Every
    cross-attention call (a module call with more than 512 keys) must be a
    K6 launch; a profiler trace of epoch 0 must show K6 and K7 launched
    with dropout. Restores R3D_CROSS_NATIVE at the end. Returns (serving counts, training counts)."""
    import os

    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models.layers import MultiheadAttention
    from r3d_tpu_torch.serving import InferenceSession

    calls = Count("cross-attention calls")   # MultiheadAttention calls with more than 512 keys

    def count_call(module, args, _):
        if isinstance(module, MultiheadAttention) and args[1].shape[1] > 512:
            calls.launches += 1

    watched = list(kernels) + [calls]
    before = os.environ.get("R3D_CROSS_NATIVE")
    os.environ["R3D_CROSS_NATIVE"] = "1"
    hook = torch.nn.modules.module.register_module_forward_hook(count_call)
    try:
        cfg = get_config("utkinects")
        print(f"utkinects with R3D_CROSS_NATIVE=1: hidden {cfg.model.hidden_dim}, "
              f"{cfg.model.n_head} heads, {cfg.model.n_query} queries, input "
              f"{cfg.model.input_dim}, depth {tuple(cfg.data.depth_shape)}, buckets 1024 and 2000")
        session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8)
        rng = np.random.default_rng(SEED + 2)
        latencies, serving, per_bucket = serve(session, watched, cfg, rng, UTK_NATIVE_SERVE)
        for S, lat in latencies.items():
            print(f"utkinects R3D_CROSS_NATIVE=1 bucket {S}: {lat['requests']} requests through "
                  f"ServingQueue, latency p50 {lat['p50_ms']:.2f} ms, max {lat['max_ms']:.2f} ms; "
                  f"launches { {k: c for k, c in per_bucket[S].items() if c} }")
            n = per_bucket[S]
            if not (n[k6.name] > 0 and n[k6.name] == n[calls.name] and n["flash_attention"] == 0):
                raise AssertionError(f"utkinects bucket {S} should take every cross-attention "
                                     f"call to {k6.name}: {n}")
        compare_with_cpu(session, cfg, state_dict, rng, lengths=(1900, 1300))

        loaders = utkinects_native_loaders(cfg)
        want = {"epoch 0 train": (k6.name, k7.name), "epoch 1 train": (k6.name, k7.name)}
        D = cfg.model.hidden_dim // cfg.model.n_head
        counts = train(cfg, state_dict, watched, loaders, want, equal=((k6.name, calls.name),),
                       epoch0_on_card=(f"attention_fwd_cluster_kernel<{D}, true, true",
                                       f"attention_bwd_cluster_kernel<{D}, true, true"))
        train_step_on_card_and_cpu(cfg, state_dict, one_batch(loaders[1], 512, 1024, rows=4))
        train_breakdown(cfg, state_dict, loaders[1], 1024,
                        label=" (utkinects, R3D_CROSS_NATIVE=1, 2000 bucket)")
        cross_native_ab(cfg, state_dict, session, loaders[1], rng, N_CLASS, 2000, 1024)
        del session
    finally:
        hook.remove()
        if before is None:
            os.environ.pop("R3D_CROSS_NATIVE", None)
        else:
            os.environ["R3D_CROSS_NATIVE"] = before
    return serving, counts


# ---- 50salads: the FUTR baseline, bf16, decoder cross-attention on K3/K6 ----

SALADS_CLASSES = 20      # 50salads: 19 L2 actions + NONE (bench.py builds it so)
SALADS_SERVE = {256: (200, 256, 131, 240, 199, 250, 180, 222),
                512: (400, 512, 300, 480, 257, 350, 444, 500),
                1024: (1024, 900, 700, 600),
                3100: (3100, 2000, 1500, 2800)}
# 50salads, card vs CPU. The CPU runs every attention composed in bf16, with
# bf16 scores, where the card's kernels keep the scores in fp32, and bf16
# rounding differences run through two decoder layers. Read on an H100 (the
# first run of this phase): logits 3.9e-2, loss 1.2e-3, a gradient 7.4e-2
# of its largest entry (the FFNs' linear1); each bound 3-8x what was read.
SALADS_E2E_TOL = 0.15    # outputs, absolute
SALADS_LOSS_TOL = 1e-2
SALADS_GRAD_TOL = 0.25   # a gradient over its largest entry
SALADS_COS_MIN = 0.999   # the whole gradient vectors' cosine (read 0.99974)


def salads_loaders(cfg):
    """Synthetic videos of the 50salads layout (2,048-d features, no depth,
    19 actions + NONE) of 2,600-3,800 frames: the train loader's observed
    windows at 0.13 (338-494 frames) land in the 512 bucket and at 0.8
    (2,080-3,040 frames, 67-98 % of the bucket) in the 3100 bucket, one batch
    of 8 each; validation holds 4 videos at both ratios (batches of 4)."""
    return train_loaders(cfg, n_class=SALADS_CLASSES, n_videos=8, vid_len_range=(2600, 3800),
                         obs=(0.13, 0.8), val_videos=4, val_obs=(0.13, 0.8), val_batch=4)


def cross_native_ab(cfg, state_dict, session, train_loader, rng, n_class, bucket, min_len,
                    rounds=8):
    """One ``bucket`` train step (epoch 0, train mode; a batch of 8 of the
    train loader's windows longer than ``min_len``) and one serving chunk
    of 8 full-length requests, each with R3D_CROSS_NATIVE set and unset, in
    the order off, on, on, off, ``rounds`` times (2 * ``rounds`` of each
    setting), each to a synchronised end. Prints the medians and, as the
    spread, the off/on ratio of every round (its two offs over its two ons):
    median, quartiles and range. Leaves R3D_CROSS_NATIVE as it found it."""
    import os

    import torch

    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, n_class)
    state = trainer.init_state(1, state_dict)
    batch = trainer.to_device(one_batch(train_loader, min_len))
    if batch["features"].shape[1] != bucket:
        raise AssertionError(f"the A/B batch fell in bucket {batch['features'].shape[1]}, "
                             f"not {bucket}")
    chunk = session._collate(make_videos(rng, (bucket,) * 8, cfg), bucket)

    def step():
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        trainer._grad_core(state.model, batch)
        state.apply_gradients()

    def serve_chunk():
        session._run(*chunk)["action"].float().cpu()

    before = os.environ.get("R3D_CROSS_NATIVE")
    times = {s: {"step": [], "chunk": []} for s in ("on", "off")}
    try:
        for setting in ("off", "on"):   # warm both routes
            os.environ["R3D_CROSS_NATIVE"] = "1" if setting == "on" else "0"
            step()
            serve_chunk()
        for setting in ("off", "on", "on", "off") * rounds:
            os.environ["R3D_CROSS_NATIVE"] = "1" if setting == "on" else "0"
            for name, fn in (("step", step), ("chunk", serve_chunk)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[setting][name].append(1e3 * (time.perf_counter() - t0))
    finally:
        if before is None:
            os.environ.pop("R3D_CROSS_NATIVE", None)
        else:
            os.environ["R3D_CROSS_NATIVE"] = before
    med = {s: {n: float(np.median(v)) for n, v in d.items()} for s, d in times.items()}
    for name in ("step", "chunk"):
        on, off = np.asarray(times["on"][name]), np.asarray(times["off"][name])
        ratios = off.reshape(rounds, 2).sum(1) / on.reshape(rounds, 2).sum(1)
        q1, q2, q3 = np.percentile(ratios, (25, 50, 75))
        print(f"A/B R3D_CROSS_NATIVE, {cfg.name} {bucket}-bucket "
              f"{'train step' if name == 'step' else 'serving chunk'}"
              f" of 8: on (K6/K7) median {med['on'][name]:.2f} ms, off (composed) median "
              f"{med['off'][name]:.2f} ms of {2 * rounds} each (off/on of the medians "
              f"{med['off'][name] / med['on'][name]:.3f}; off/on per round of off, on, on, off: "
              f"median {q2:.3f}, quartiles {q1:.3f}-{q3:.3f}, range {ratios.min():.3f}-"
              f"{ratios.max():.3f}, {int((ratios > 1).sum())} of {rounds} rounds above 1); "
              "all on: " + ", ".join(f"{t:.2f}" for t in on) + "; all off: "
              + ", ".join(f"{t:.2f}" for t in off))


def salads(kernels, k3b, k4b, k5b, k6, k7):
    """Serve and train the 50salads FUTR at full width with the native
    cross-attention on (R3D_CROSS_NATIVE=1, restored after). Returns
    (serving counts, training counts)."""
    import os

    before = os.environ.get("R3D_CROSS_NATIVE")
    os.environ["R3D_CROSS_NATIVE"] = "1"
    try:
        return _salads(kernels, k3b, k4b, k5b, k6, k7)
    finally:   # the later phases run the default route
        if before is None:
            os.environ.pop("R3D_CROSS_NATIVE", None)
        else:
            os.environ["R3D_CROSS_NATIVE"] = before


def _salads(kernels, k3b, k4b, k5b, k6, k7):
    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights
    from r3d_tpu_torch.serving import InferenceSession

    cfg = get_config("50salads")
    model = init_weights(build_model(cfg.model, SALADS_CLASSES), torch.Generator().manual_seed(SEED))
    state_dict = model.state_dict()
    del model
    print(f"50salads: hidden {cfg.model.hidden_dim}, {cfg.model.n_head} heads, "
          f"{cfg.model.n_decoder_layers} decoder layers, {cfg.model.n_query} queries, input "
          f"{cfg.model.input_dim}, buckets {cfg.data.seq_buckets}, compute "
          f"{cfg.model.compute_dtype}, batches {cfg.data.feature_dtype}, R3D_CROSS_NATIVE=1")
    session = InferenceSession(cfg, state_dict, SALADS_CLASSES, max_batch=8)
    rng = np.random.default_rng(SEED + 1)
    latencies, counts, per_bucket = serve(session, kernels, cfg, rng, SALADS_SERVE)
    for S, lat in latencies.items():
        print(f"50salads bucket {S}: {lat['requests']} requests through ServingQueue, latency "
              f"p50 {lat['p50_ms']:.2f} ms, max {lat['max_ms']:.2f} ms; launches "
              f"{ {k: c for k, c in per_bucket[S].items() if c} }")
    for S, route, other in ((256, k3b, k6), (512, k3b, k6), (1024, k6, k3b), (3100, k6, k3b)):
        if per_bucket[S][route.name] == 0 or per_bucket[S][other.name] != 0:
            raise AssertionError(f"50salads bucket {S} should launch {route.name} and not "
                                 f"{other.name}: {per_bucket[S]}")
    for S in (512, 3100):
        breakdown(session, cfg, rng, S=S)
    compare_with_cpu(session, cfg, state_dict, rng, n_class=SALADS_CLASSES,
                     lengths=(1024, 900, 700, 600), tol=SALADS_E2E_TOL)

    loaders = salads_loaders(cfg)
    want = {"epoch 0 train": (k4b.name, k5b.name, k6.name, k7.name),
            "epoch 1 train": (k3b.name, k5b.name, k6.name, k7.name)}
    train_counts = train(cfg, state_dict, kernels, loaders, want, n_class=SALADS_CLASSES)
    train_step_on_card_and_cpu(cfg, state_dict, one_batch(loaders[1], 1024, rows=4),
                               n_class=SALADS_CLASSES, loss_tol=SALADS_LOSS_TOL,
                               grad_tol=SALADS_GRAD_TOL, cos_min=SALADS_COS_MIN)
    for min_len, label in ((256, " (50salads, 512 bucket)"), (1024, " (50salads, 3100 bucket)")):
        train_breakdown(cfg, state_dict, loaders[1], min_len, SALADS_CLASSES, label)
    cross_native_ab(cfg, state_dict, session, loaders[1], rng, SALADS_CLASSES, 3100, 1024)
    del session
    return counts, train_counts



# ---- utkinects through the CLI: train -> checkpoint -> MoC sweep ----

CLI_DIR = "build/cli_phase"   # under the checkout (git-ignored), removed after the phase
CLI_TRAIN_LENGTHS = (300, 780)   # train windows at 0.2-0.65: the 256 and 512 buckets
CLI_VAL_LENGTHS = (600, 780)     # sweep windows at 0.1-0.9: the 128-1024 buckets


def write_utkinect_dataset(root, n_train, n_val, lengths, n_actions=N_CLASS - 1, seed=SEED,
                           input_dim=2048, depth_shape=(160, 120), val_lengths=None,
                           gt_format="csv", transposed=False, dataset_dir="utkinect"):
    """A dataset in the utkinect layout (NTU RGB+D's too) under
    ``root/<dataset_dir>``, from a numpy seed: per video, action runs of 5-14 frames, features [L, input]
    that carry each frame's class (``.T`` when ``transposed``), raw depth
    frames [L, *depth_shape] of noise, csv (``img,L2,L3``) or plain ground
    truth; the mapping of ``n_actions`` actions (n_class ``n_actions + 1``)
    and the train and val splits. Lengths are drawn from ``lengths``
    (``val_lengths`` for the val split). Returns ``root``."""
    import os

    base = os.path.join(str(root), dataset_dir)
    rng = np.random.RandomState(seed)
    acts = [f"a{i}" for i in range(n_actions)]
    for d in ("features_img", "features_depth", "groundTruth", "splits"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    with open(os.path.join(base, "mapping_l2_changed.txt"), "w") as f:
        f.write("".join(f"{i} {a}\n" for i, a in enumerate(acts)))
    emb = rng.randn(n_actions, input_dim).astype(np.float32)
    vids = []
    for v in range(n_train + n_val):
        lo, hi = lengths if v < n_train or val_lengths is None else val_lengths
        L = int(rng.randint(lo, hi + 1))
        ids = []
        a = int(rng.randint(n_actions))
        while len(ids) < L:
            ids += [a] * int(rng.randint(5, 15))
            a = (a + 1 + int(rng.randint(n_actions - 1))) % n_actions
        ids = np.array(ids[:L])
        feats = (emb[ids] + 0.5 * rng.randn(L, input_dim)).astype(np.float32)
        np.save(os.path.join(base, "features_img", f"v{v}.npy"),
                feats.T if transposed else feats)
        np.save(os.path.join(base, "features_depth", f"v{v}.npy"),
                rng.rand(L, *depth_shape).astype(np.float32))
        with open(os.path.join(base, "groundTruth", f"v{v}.txt"), "w") as f:
            if gt_format == "csv":
                f.write("".join(f"img{t},{acts[i]},q{t % 3}\n" for t, i in enumerate(ids)))
            else:
                f.write("".join(f"{acts[i]}\n" for i in ids))
        vids.append(f"v{v}.txt")
    with open(os.path.join(base, "splits", "train_split.txt"), "w") as f:
        f.write("\n".join(vids[:n_train]) + "\n")
    with open(os.path.join(base, "splits", "val_split.txt"), "w") as f:
        f.write("\n".join(vids[n_train:]) + "\n")
    return str(root)


BREAKFAST_ACTIVITIES = ("cereals", "coffee", "friedegg", "juice", "milk", "pancake", "salat",
                        "sandwich", "scrambledegg", "tea")


def write_proposed_dataset(root, config_name, train_lengths, val_lengths, input_dim=2048,
                           seed=SEED, run=(5, 14), n_fine=48):
    """A dataset in the layout of ``config_name`` (``50salads_proposed`` or
    ``breakfast_proposed``) under ``root/<dataset>``, from a numpy seed:
    features stored [input_dim, L] (transposed), plain ground truth of one
    fine label a line in runs of ``run`` frames, features that carry each
    frame's fine label, the mappings and the split bundles of split 1; one
    video of each length in ``train_lengths`` and ``val_lengths``.

    50salads: the fine labels are the 19 L2 actions of the L1 hierarchy
    (``mapping_l2.txt``), the targets their 5 L1 activities
    (``mapping_l1.txt``). Breakfast: ``n_fine`` fine actions
    (``mapping.txt``), one of 10 activities per video, named in the file
    name (``P<n>_cam01_<activity>``; ``mapping_l2.txt``). Returns ``root``."""
    import os

    from r3d_tpu_torch.data.salads50 import ACTION_MAPPING

    salads = config_name == "50salads_proposed"
    base = os.path.join(str(root), "50salads" if salads else "breakfast")
    rng = np.random.RandomState(seed)
    for d in ("features", "groundTruth", "splits"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    if salads:
        fine = [l2 for l2s in ACTION_MAPPING.values() for l2 in l2s]
        coarse, fine_map, coarse_map = list(ACTION_MAPPING), "mapping_l2.txt", "mapping_l1.txt"
    else:
        fine = [f"f{i}" for i in range(n_fine)]
        coarse, fine_map, coarse_map = list(BREAKFAST_ACTIVITIES), "mapping.txt", "mapping_l2.txt"
    for name, labels in ((fine_map, fine), (coarse_map, coarse)):
        with open(os.path.join(base, name), "w") as f:
            f.write("".join(f"{i} {a}\n" for i, a in enumerate(labels)))
    emb = rng.randn(len(fine), input_dim).astype(np.float32)
    vids = []
    for v, L in enumerate(tuple(train_lengths) + tuple(val_lengths)):
        ids = []
        a = int(rng.randint(len(fine)))
        while len(ids) < L:
            ids += [a] * int(rng.randint(run[0], run[1] + 1))
            a = (a + 1 + int(rng.randint(len(fine) - 1))) % len(fine)
        ids = np.array(ids[:L])
        name = f"v{v}" if salads else f"P{v:02d}_cam01_{coarse[v % len(coarse)]}"
        feats = emb[ids] + 0.5 * rng.randn(L, input_dim).astype(np.float32)
        np.save(os.path.join(base, "features", f"{name}.npy"), feats.T)
        with open(os.path.join(base, "groundTruth", f"{name}.txt"), "w") as f:
            f.write("".join(f"{fine[i]}\n" for i in ids))
        vids.append(f"{name}.txt")
    n_train = len(train_lengths)
    for split, names in (("train", vids[:n_train]), ("test", vids[n_train:])):
        with open(os.path.join(base, "splits", f"{split}.split1.bundle"), "w") as f:
            f.write("\n".join(names) + "\n")
    return str(root)


def write_darai_dataset(root, train_videos, val_videos, input_dim=2048, seed=SEED, run=(5, 14),
                        n_actions=10, n_l3=48, gaze_rows=None, without_gaze=()):
    """A dataset in the DARai layout under ``root/darai``, from a numpy seed:
    each video of ``train_videos`` and ``val_videos`` a tuple of its
    sequences' lengths, stored as ``features_img/v<i>_<seq>.npy`` [L,
    input_dim] and csv ground truth ``groundTruth/v<i>_<seq>.txt`` of
    ``img,L2,L3`` rows: L2 actions in runs of ``run`` frames, each run cut
    into L3 sub-runs of 2-9 frames drawn from the action's own 8 of the
    ``n_l3`` L3 labels; features that carry both labels; the mappings
    ``mapping_l2_changed.txt`` (``n_actions``) and ``mapping_l3_changed.txt``
    (``n_l3``) and the train and val splits of video names. With
    ``gaze_rows`` (lo, hi), a gaze CSV ``gaze/v<i>.csv`` of that many rows
    (x, y in pixels of a 640x480 frame) for each video but those of
    ``without_gaze``. Returns ``root``."""
    import os

    base = os.path.join(str(root), "darai")
    rng = np.random.RandomState(seed)
    for d in ("features_img", "groundTruth", "splits", "gaze"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    acts = [f"act{i}" for i in range(n_actions)]
    l3s = [f"l3_{i}" for i in range(n_l3)]
    for name, labels in (("mapping_l2_changed.txt", acts), ("mapping_l3_changed.txt", l3s)):
        with open(os.path.join(base, name), "w") as f:
            f.write("".join(f"{i} {a}\n" for i, a in enumerate(labels)))
    emb = rng.randn(n_actions, input_dim).astype(np.float32)
    emb3 = rng.randn(n_l3, input_dim).astype(np.float32)
    vids = []
    for v, seqs in enumerate(tuple(train_videos) + tuple(val_videos)):
        for seq, L in enumerate(seqs, start=1):
            ids, sub = [], []
            a = int(rng.randint(n_actions))
            while len(ids) < L:
                n = int(rng.randint(run[0], run[1] + 1))
                ids += [a] * n
                while len(sub) < len(ids):
                    sub += [(8 * a + int(rng.randint(8))) % n_l3] * int(rng.randint(2, 10))
                a = (a + 1 + int(rng.randint(n_actions - 1))) % n_actions
            ids, sub = np.array(ids[:L]), np.array(sub[:L])
            feats = emb[ids] + emb3[sub] + 0.5 * rng.randn(L, input_dim).astype(np.float32)
            np.save(os.path.join(base, "features_img", f"v{v}_{seq}.npy"), feats)
            with open(os.path.join(base, "groundTruth", f"v{v}_{seq}.txt"), "w") as f:
                f.write("".join(f"img_{t}.jpg,{acts[i]},{l3s[j]}\n"
                                for t, (i, j) in enumerate(zip(ids, sub))))
        if gaze_rows is not None and v not in without_gaze:
            n = int(rng.randint(gaze_rows[0], gaze_rows[1] + 1))
            # pixels on a coarse grid: a third of each column normalises to
            # exactly 1, which the model's truncation keeps
            xy = rng.randint(0, 3, (n, 2)) * (320, 240)
            with open(os.path.join(base, "gaze", f"v{v}.csv"), "w") as f:
                f.write("frame, gaze_x [px], gaze_y [px]\n")
                f.write("".join(f"{i}, {x}, {y}\n" for i, (x, y) in enumerate(xy)))
        vids.append(f"v{v}.txt")
    n_train = len(train_videos)
    for split, names in (("train_split.txt", vids[:n_train]), ("val_split.txt", vids[n_train:])):
        with open(os.path.join(base, "splits", split), "w") as f:
            f.write("\n".join(names) + "\n")
    return str(root)


class SweepRecorder:
    """Records each chunk of ``Predictor`` sweeps while in use: its bucket,
    its windows (video, ratio), whether its windows were gathered from the
    device cache, its action logits, durations and L3 logits (None for a
    model without them: the TCN has no durations), and how many launches of
    each of ``kernels`` it made."""

    ROUTES = (("_forward_batch", False), ("_forward_batch_cached", True))

    def __init__(self, kernels):
        self.kernels, self.chunks = kernels, []

    def __enter__(self):
        from r3d_tpu_torch.eval.predict import Predictor

        self._orig = {name: getattr(Predictor, name) for name, _ in self.ROUTES}
        recorder = self

        def recording(orig, cached):
            def recorded(predictor, modules, items, S, *rest):
                before = {k.name: k.launches for k in recorder.kernels}
                out = orig(predictor, modules, items, S, *rest)
                recorder.chunks.append({
                    "S": S, "windows": [(it["vid"], it["obs_p"]) for it in items],
                    "cached": cached, "future_len": [it["future_len"] for it in items],
                    "action": out["action"], "duration": out.get("duration"),
                    "l3": out.get("l3"),
                    "launches": {k.name: k.launches - before[k.name] for k in recorder.kernels}})
                return out
            return recorded

        for name, cached in self.ROUTES:
            setattr(Predictor, name, recording(self._orig[name], cached))
        return self

    def __exit__(self, *exc):
        from r3d_tpu_torch.eval.predict import Predictor

        for name, orig in self._orig.items():
            setattr(Predictor, name, orig)
        return False


def htod_copies(prof, path):
    """The host-to-device copies of a profiler trace (written to ``path``
    and read back): their sizes in bytes."""
    import os

    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    return [int(e.get("args", {}).get("bytes", 0)) for e in trace.get("traceEvents", [])
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]


def final_model(ckpt_dir, name):
    """The model ``state_dict`` of checkpoint ``name``, on the card."""
    import os

    import torch

    return torch.load(os.path.join(ckpt_dir, name, "state.pt"), map_location="cuda",
                      weights_only=True)["model"]


def unequal(a, b):
    """The names of the entries of two ``state_dict``s that differ in any bit."""
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def moc_table(results):
    """The sweep's results (``cli.run.predict``) as printed rows."""
    rows = []
    for obs, r in results.items():
        rows.append(f"  {obs:>7}: " + " ".join(
            f"{k.split('_', 1)[1] if k.startswith('obs') else k} {v:.4f}" for k, v in r.items()))
    return "\n".join(rows)


def top2_margin(action):
    """The least gap between the two largest logits of any query slot."""
    top = np.sort(action, axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


def decode_flips(chunks, ref_chunks, logit_err, n_class=N_CLASS):
    """Windows whose decoded future frames differ between two sweeps of the
    same windows, and those of them that the measured errors do not explain:
    a decode can flip only where a slot's top-2 logit margin is within
    ``logit_err``, or where a slot's length ``0.5 + future_len * duration``
    lies within the durations' measured difference of a whole frame. A
    model without durations (the TCN) paints each slot's argmax, which can
    flip only at a margin."""
    from r3d_tpu_torch.eval.decode import decode_anticipation, decode_frames_from_slots

    flipped, unexplained = 0, 0
    for a, b in zip(chunks, ref_chunks):
        for j, fl in enumerate(b["future_len"]):
            if b["duration"] is None:
                if not np.array_equal(decode_frames_from_slots(a["action"][j], fl),
                                      decode_frames_from_slots(b["action"][j], fl)):
                    flipped += 1
                    unexplained += top2_margin(b["action"][j]) > logit_err
                continue
            fa, da = decode_anticipation(a["action"][j], a["duration"][j], fl, n_class - 1)
            fb, db = decode_anticipation(b["action"][j], b["duration"][j], fl, n_class - 1)
            if np.array_equal(fa, fb):
                continue
            flipped += 1
            lengths = 0.5 + fl * db
            near_edge = np.abs(lengths - np.round(lengths)) <= fl * float(np.abs(da - db).max())
            if not (top2_margin(b["action"][j]) <= logit_err or near_edge.any()):
                unexplained += 1
    return flipped, unexplained


CLI_ROUTE = "device cache: "        # the route's log line, the JAX CLI's words
CLI_SWEEP_ROUTE = "predict: eval videos cached in HBM"


def cli_train(argv, kernels, extra=(), buckets=None):
    """``train`` through the CLI with every launch count set to 0; returns
    (log lines, the counts at the end of each epoch's training and
    validation, the counts in all, the wall time). With a list
    ``buckets``, each batch the device cache gathers appends (phase, S, B),
    the phase counted in log lines as the snapshots are."""
    import torch

    from r3d_tpu_torch.cli.opts import run_from_argv
    from r3d_tpu_torch.data import device_cache as dc

    snapshots, lines = [], []

    def log(line):
        torch.cuda.synchronize()
        if line.startswith(("Epoch [", "Validation")):
            snapshots.append({k.name: k.launches for k in kernels})
        lines.append(line)
        print(f"  {line}")

    assemble = dc.assemble

    def recorded(data, view_ids, S, *rest):
        buckets.append((len(snapshots), S, len(view_ids)))
        return assemble(data, view_ids, S, *rest)

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    if buckets is not None:
        dc.assemble = recorded
    try:
        run_from_argv("utkinects", argv + ["--mode", "train", "--epochs", "2", *extra],
                      log=log)
    finally:
        dc.assemble = assemble
    torch.cuda.synchronize()
    return lines, snapshots, {k.name: k.launches for k in kernels}, time.perf_counter() - t0


def utkinects_cli(kernels, card, k1, k3):
    """utkinects at full width through the CLI (``r3d_tpu_torch.cli``):
    write a synthetic utkinect-layout dataset (16 actions, 5 train videos of
    300-780 frames, 2 val videos of 600-780), every launch count set to 0,
    ``train`` one seed for 2 epochs on the card on the JAX CLI's route for
    the config, the device cache (the route's log line asserted; epoch 0
    must launch the no-blend tail, its backward, the dropout attention and
    the attention backward, epoch 1 the blend tail, attention and its
    backward, each validation from the val cache the blend tail and
    attention) with the gate, ``seed_1_best``, ``seed_1_last`` and the
    metrics stream; the same ``train`` with ``--no-device_cache`` (the host
    loader, whose epoch 0 shuffles with ``seed + 1`` after the JAX CLI's
    example batch); ``fit`` over the host loader in the cached route's
    batch order and ``fit_hybrid`` with two of the five units on the card,
    each of whose final parameters must equal the cached run's bit for bit;
    then the 9-ratio MoC sweep from the best checkpoint on the card from the
    cached val videos, where every chunk must launch K1 (``k1``) and the
    256/512-bucket chunks K3 (``k3``); the sweep again under the profiler
    for its card-busy time and its host-to-device bytes (the videos and the
    model, no optimizer state); the host sweep (``--no-device_cache``),
    equal to the cached one window by window; and the sweep with ``--cpu``,
    whose per-window logits and durations the card's must hold to within
    ``E2E_TOL``. Returns the counts of the cached train and card-sweep
    runs."""
    import dataclasses
    import io
    import json as _json
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args, run_from_argv
    from r3d_tpu_torch.cli.run import save_path
    from r3d_tpu_torch.data import device_cache as dc
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.train.loop import Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, CLI_DIR)
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        root = write_utkinect_dataset(os.path.join(work, "data"), 5, 2, CLI_TRAIN_LENGTHS,
                                      val_lengths=CLI_VAL_LENGTHS)
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        print(f"cli: synthetic utkinect dataset, 5 + 2 videos, {size / 2**20:.0f} MiB written "
              f"in {time.perf_counter() - t0:.2f} s")
        save = os.path.join(work, "save")
        argv = ["--config", "utkinects", "--data_root", root, "--model_save_path", save,
                "--seed", "1"]

        lines, snapshots, train_counts, t_train = cli_train(argv, kernels)
        if not any(line.startswith(CLI_ROUTE) and "views" in line for line in lines):
            raise AssertionError(f"cli train: the cached route's line is missing: {lines}")
        phases = ["epoch 0 train", "epoch 0 validation", "epoch 1 train", "epoch 1 validation"]
        per_phase, prev = {}, {k.name: 0 for k in kernels}
        for name, snap in zip(phases, snapshots):
            per_phase[name] = {k: snap[k] - prev[k] for k in snap if snap[k] - prev[k]}
            prev = snap
            print(f"cli: launches in {name}: {per_phase[name]}")
        want = {"epoch 0 train": ("fused_safuser_tail", "fused_tail_bwd",
                                  "flash_attention_dropout", "attention_bwd"),
                "epoch 0 validation": ("fused_bn_blend_tail", "flash_attention"),
                "epoch 1 train": ("fused_bn_blend_tail", "flash_attention", "attention_bwd"),
                "epoch 1 validation": ("fused_bn_blend_tail", "flash_attention")}
        for phase, names in want.items():
            missing = [n for n in names if per_phase.get(phase, {}).get(n, 0) == 0]
            if missing:
                raise AssertionError(f"cli train: {phase} never launched {missing}")
        losses = [float(x) for line in lines
                  for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"cli train: a loss is missing or not finite: {lines}")
        config = config_from_args(build_parser("utkinects").parse_args(argv))
        ckpt_dir = save_path(config)
        names = sorted(os.listdir(ckpt_dir))
        with open(os.path.join(ckpt_dir, "seed_1_metrics.jsonl")) as f:
            records = [_json.loads(line) for line in f]
        print(f"cli: train on the cached route, 2 epochs of {records[0]['step']} steps: "
              f"{names}; metrics records of epochs {[r['epoch'] for r in records]} with keys "
              f"{sorted(records[0])}")
        for need in ("seed_1_best", "seed_1_last", "seed_1_metrics.jsonl"):
            if need not in names:
                raise AssertionError(f"cli train: no {need} in {ckpt_dir}")
        if [r["epoch"] for r in records] != [0, 1]:
            raise AssertionError(f"cli train: metrics records of epochs {records}")
        cached_final = final_model(ckpt_dir, "seed_1_last")

        # the host route through the CLI: JAX's batch order for it (seed + 1)
        host_argv = ["--config", "utkinects", "--data_root", root, "--model_save_path",
                     os.path.join(work, "save_host"), "--seed", "1"]
        host_lines, _, _, t_host = cli_train(host_argv, kernels, ["--no-device_cache"])
        if any(line.startswith(("device cache", "hybrid cache")) for line in host_lines):
            raise AssertionError(f"cli train --no-device_cache took a cache: {host_lines}")
        host_losses = [float(x) for line in host_lines
                       for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
        if len(host_losses) != 4 or not all(math.isfinite(x) for x in host_losses):
            raise AssertionError(f"cli train --no-device_cache: a loss is not finite")

        # the cached route's batches through the host loader and the hybrid
        # cache: the same kernels, batches and dropout stream
        sources = {s: build_source(config.data, f"{s}_split.txt") for s in ("train", "val")}
        n_class = sources["train"].n_class
        B, nq = config.train.batch_size, config.model.n_query
        val = build_loader(sources["val"], config.data, B, nq, mode="val", shuffle=False,
                           pin_memory=True)
        train = build_loader(sources["train"], config.data, B, nq, seed=1, pin_memory=True)
        _, frows, frb, _, drb, _ = dc._unit_probe(sources["train"], config.data)
        budget = 2 * int(frows.max()) * (frb + drb + 4)   # two units padded to the longest
        hybrid = dc.hybrid_cache_from_source(sources["train"], config.data, nq,
                                             max_bytes=budget,
                                             device=next(iter(cached_final.values())).device)
        finals = {}
        for route in ("fit", "fit_hybrid"):
            cfg2 = config.replace(train=dataclasses.replace(config.train, epochs=2))
            trainer = Trainer(cfg2, n_class)
            state = trainer.init_state(len(train), seed=1)
            t0 = time.perf_counter()
            if route == "fit":
                trainer.fit(state, train, val, seed=1, log=lambda *a: None)
            else:
                trainer.fit_hybrid(state, hybrid, val, seed=1, log=lambda *a: None)
            torch.cuda.synchronize()
            finals[route] = (state.model.state_dict(), time.perf_counter() - t0)
        diff = {r: unequal(cached_final, sd) for r, (sd, _) in finals.items()}
        print(f"cli [{card}]: train 2 epochs on the cached route {t_train:.2f} s "
              f"(launches {({k: c for k, c in train_counts.items() if c})}); with "
              f"--no-device_cache {t_host:.2f} s (the host loader from seed + 1, losses "
              f"{host_losses}); fit over the host loader in the cached order "
              f"{finals['fit'][1]:.2f} s; fit_hybrid with "
              f"{100 * (1 - hybrid.host_frac):.0f}% of views on the card "
              f"({hybrid.cache.nbytes >> 20} MiB) {finals['fit_hybrid'][1]:.2f} s")
        print(f"cli [{card}]: final parameters and BN statistics against the cached run's: "
              f"fit {len(diff['fit'])} of {len(cached_final)} tensors differ, fit_hybrid "
              f"{len(diff['fit_hybrid'])} (bit for bit)")
        if diff["fit"] or diff["fit_hybrid"]:
            raise AssertionError(f"cli: the host routes' final parameters differ from the "
                                 f"cached route's: {diff}")

        predict = argv + ["--predict", "--results_save_path", os.path.join(work, "results")]
        runs = {}
        for run, extra in (("cuda", []), ("cuda_host", ["--no-device_cache"]),
                           ("cpu", ["--cpu"])):
            for k in kernels:
                k.launches = 0
            # the card's cached sweep prints the reference's MoC lines; the
            # others are printed below beside it
            quiet = io.StringIO() if run != "cuda" else sys.stdout
            sweep_log = []
            with SweepRecorder(kernels) as rec, contextlib.redirect_stdout(quiet):
                t0 = time.perf_counter()
                results = run_from_argv("utkinects", predict + extra, log=sweep_log.append)
                if run != "cpu":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            if (CLI_SWEEP_ROUTE in sweep_log) != (run != "cuda_host"):
                raise AssertionError(f"cli sweep {run}: route {sweep_log}")
            if {c["cached"] for c in rec.chunks} != {run != "cuda_host"}:
                raise AssertionError(f"cli sweep {run}: chunks off the expected route")
            runs[run] = (results, rec.chunks, dt, {k.name: k.launches for k in kernels})
        sweep_counts = runs["cuda"][3]
        chunks = runs["cuda"][1]
        per_bucket = {}
        for c in chunks:
            per_bucket[c["S"]] = per_bucket.get(c["S"], 0) + 1
            if c["launches"][k1.name] == 0:
                raise AssertionError(f"cli sweep: a {c['S']}-bucket chunk launched no K1")
            if (c["launches"][k3.name] > 0) != (c["S"] in (256, 512)):
                raise AssertionError(f"cli sweep: a {c['S']}-bucket chunk launched "
                                     f"{c['launches'][k3.name]} K3")
        if not {128, 256, 512, 1024} <= set(per_bucket):
            raise AssertionError(f"cli sweep: chunks per bucket {per_bucket}")
        host_chunks = runs["cuda_host"][1]
        if [c["windows"] for c in host_chunks] != [c["windows"] for c in chunks]:
            raise AssertionError("cli sweep: the cached and host sweeps swept different windows")
        cached_vs_host = max(float(np.abs(a[key] - b[key]).max())
                             for a, b in zip(chunks, host_chunks) for key in ("action", "duration"))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof, contextlib.redirect_stdout(io.StringIO()):
            run_from_argv("utkinects", predict, log=lambda *a: None)
            torch.cuda.synchronize()
        events = sorted(card_events(prof), key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        n_launch = sum(e.count for e in events)
        copies = [e for e in events if "Memcpy HtoD" in e.key]
        htod = htod_copies(prof, os.path.join(work, "sweep_trace.json"))
        video_bytes = sum(t.numel() * t.element_size() for t in dc.arrays_from_source(
            sources["val"], config.data, device="cpu").values())
        model_bytes = sum(t.numel() * t.element_size() for t in cached_final.values())
        print(f"cli sweep [{card}], a profiled cached sweep's card time by event:")
        for e in events[:6]:
            print(f"  {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}")
        print(f"cli sweep [{card}]: {len(htod)} host-to-device copies of {sum(htod)} bytes "
              f"({sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms), at most the "
              f"cached val videos' {video_bytes} and the model's {model_bytes} (parameters and "
              f"BN buffers; AdamW's two moments would add {2 * model_bytes})")
        if sum(htod) > video_bytes + model_bytes + (1 << 20):
            raise AssertionError("cli sweep: more bytes reached the card than the videos and "
                                 "the model; the optimizer's state was restored")

        # the card's sweep against the CPU's, window by window
        cpu_chunks = runs["cpu"][1]
        if [c["windows"] for c in cpu_chunks] != [c["windows"] for c in chunks]:
            raise AssertionError("cli sweep: the card and the CPU swept different windows")
        err = max(float(np.abs(a[key] - b[key]).max())
                  for a, b in zip(chunks, cpu_chunks) for key in ("action", "duration"))
        for c in chunks:
            if not (np.isfinite(c["action"]).all() and np.isfinite(c["duration"]).all()):
                raise AssertionError(f"cli sweep: non-finite outputs in a {c['S']} chunk")
        margin = min(top2_margin(c["action"]) for c in cpu_chunks)
        flipped, unexplained = decode_flips(chunks, cpu_chunks, err)
        gpu_res, cpu_res = runs["cuda"][0], runs["cpu"][0]
        diff = [(k, abs(gpu_res[o][k] - cpu_res[o][k])) for o in cpu_res for k in cpu_res[o]]
        moc_diff = max(d for k, d in diff if k.startswith("obs"))
        acc_diff = max(d for k, d in diff if not k.startswith("obs"))
        n_windows = sum(len(c["windows"]) for c in chunks)
        print(f"cli sweep on the card [{card}], from the cached val videos:\n{moc_table(gpu_res)}")
        print(f"cli sweep on the CPU:\n{moc_table(cpu_res)}")
        launched = {k: c for k, c in sweep_counts.items() if c}
        print(f"cli sweep [{card}]: {n_windows} windows in {len(chunks)} chunks of up to 8, "
              f"per bucket "
              f"{dict(sorted(per_bucket.items()))}; K1 launched in every chunk, K3 in the "
              f"256/512 chunks only; launches {launched}")
        print(f"cli sweep [{card}]: cached vs host sweep on the card, max|logit or duration "
              f"diff| {cached_vs_host:.3e} (must be 0); results equal: "
              f"{runs['cuda'][0] == runs['cuda_host'][0]}")
        print(f"cli sweep card [{card}] vs CPU: max|logit or duration diff| {err:.3e} "
              f"(tol {E2E_TOL}), "
              f"least top-2 logit margin {margin:.3e}, max|MoC diff| {moc_diff:.3e}, max|accuracy "
              f"diff| {acc_diff:.3e}, "
              f"{flipped} of {n_windows} windows decoded differently ({unexplained} not "
              f"explained by a margin or a frame edge within the measured error)")
        print(f"cli wall times [{card}]: train (2 epochs with validation and checkpoints) "
              f"{t_train:.2f} s cached, {t_host:.2f} s host; sweep on the card "
              f"{runs['cuda'][2]:.2f} s cached, {runs['cuda_host'][2]:.2f} s host, card busy "
              f"{busy_ms:.2f} ms in {n_launch} launches (a profiled cached sweep, the videos' "
              f"copy included); sweep on the CPU {runs['cpu'][2]:.2f} s")
        if cached_vs_host != 0 or runs["cuda"][0] != runs["cuda_host"][0]:
            raise AssertionError("cli sweep: the cached sweep differs from the host sweep")
        if err > E2E_TOL:
            raise AssertionError("cli sweep: the card's outputs disagree with the CPU's")
        if unexplained or (moc_diff > 0 and flipped == 0):
            raise AssertionError("cli sweep: the card's MoC table differs from the CPU's where "
                                 "the measured errors cannot explain it")
        return train_counts, sweep_counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- the gt-query FUTR (futr_proposed) through the CLI: 50salads_proposed, breakfast_proposed ----

PROPOSED_DIR = "build/proposed_phase"   # under the checkout (git-ignored), removed after
# (train video lengths, val video lengths, the bucket the longest train view
# reaches): 50salads at sample rate 6, ratios 0.2/0.3/0.5; one 13,000-frame
# video puts its 0.5 view (1,084 rows) in the 3100 bucket; 8 videos make 24
# views, 3 batches of 8. Breakfast at sample rate 3: two videos of 6,400 and
# 7,000 frames reach the 2000 bucket at 0.5; 8 videos, a batch of 16 and one
# of 8. The val videos keep every sweep window within 1,024 rows.
PROPOSED_DATA = {
    "50salads_proposed": ((13000, 3000, 3500, 4000, 4500, 5000, 5500, 6000), (5000, 6000),
                          3100),
    "breakfast_proposed": ((7000, 6400, 1500, 2000, 2500, 3000, 3500, 4000), (2500, 3000),
                           2000),
}
# The S-query path, card vs CPU (the sweep) and kernels vs the plain route on
# the card (one train step at the largest bucket, dropout off): the plain
# route computes its scores in bf16 where the kernels keep them in fp32, as
# the CPU does against the card in the 50salads phase, so the 50salads bounds
# hold for outputs and the loss. The step also runs through the plain route
# in fp32, a witness for both bf16 routes: each output and each gradient
# (but the rounding-noise ones, ``GRAD_NOISE_ONLY``) of the kernels' route
# must be within ``PROPOSED_WITNESS_FACTOR`` times the bf16 plain route's
# error against fp32, each over its own largest fp32 entry. A gradient of
# the two bf16 routes against each other can be far apart for its scale:
# the duration head's weight gradient is a difference of near-equal terms
# (the durations are normalised over the slots, and the pooled decoder rows
# of a long stream are alike), 0.29 of its largest entry at the 3100 bucket
# on an H100 while the cosine read 0.999999; the witness says which route
# is the further off. Every entry stays within ``PROPOSED_GRAD_TOL`` of the
# model's largest gradient entry, and the whole gradients' cosine above
# ``PROPOSED_COS_MIN``, as ROADMAP C says of bf16 gradients.
PROPOSED_E2E_TOL = SALADS_E2E_TOL
PROPOSED_LOSS_TOL = SALADS_LOSS_TOL
PROPOSED_GRAD_TOL = 7e-2     # over the model's largest gradient entry
PROPOSED_COS_MIN = SALADS_COS_MIN
PROPOSED_WITNESS_FACTOR = 2.0


def batch_with_longest(loader, rows):
    """A batch of ``rows`` of the loader's examples, the longest first and
    then the others in the loader's order, collated: it falls in the bucket
    of the longest view."""
    from r3d_tpu_torch.data.pipeline import pad_batch

    examples = [loader.make_example_fn(int(j)) for j in loader._order()]
    longest = max(range(len(examples)), key=lambda i: examples[i].features.shape[0])
    chosen = [examples[longest]] + [e for i, e in enumerate(examples) if i != longest]
    return pad_batch(chosen[:rows], loader.pad_idx, loader.buckets, loader.n_query,
                     loader.with_depth, loader.feature_dtype, loader.pin_memory,
                     loader.with_query, loader.query_pad_idx, loader.query_pad_len)


def bf16_step(cfg, state_dict, batch, n_class, kernels):
    """One dropout-off train-mode step of ``cfg`` on the card from the given
    weights and batch, on whatever route is in force: (loss, outputs,
    gradients by parameter name, launches, wall time of the first call,
    the launches of an eval forward of the batch without its mask, a
    validation or sweep chunk of the bucket)."""
    import torch

    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, n_class)
    state = trainer.init_state(1, state_dict)
    state.model.train()
    dev = trainer.to_device(batch)
    before = {k.name: k.launches for k in kernels}
    t0 = time.perf_counter()
    outputs = state.model(*trainer._model_inputs(dev, with_mask=True))
    total, _ = trainer._losses(outputs, dev)
    total.backward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step = (float(total.detach()),
            {k: outputs[k].detach().float() for k in ("action", "duration", "seg", "l3")
             if k in outputs},
            {k: p.grad.float() for k, p in state.model.named_parameters() if p.grad is not None},
            {k.name: k.launches - before[k.name] for k in kernels
             if k.launches - before[k.name]}, dt)
    state.model.eval()
    before = {k.name: k.launches for k in kernels}
    with torch.no_grad():
        state.model(*trainer._model_inputs(dev, with_mask=False))
    torch.cuda.synchronize()
    eval_launches = {k.name: k.launches - before[k.name] for k in kernels
                     if k.launches - before[k.name]}
    del trainer, state, outputs, total, dev
    torch.cuda.empty_cache()
    return step + (eval_launches,)


def witness_errors(test, plain, fp32):
    """Against the fp32 witness, over each one's largest fp32 entry: output
    or gradient name -> (``test``'s error, ``plain``'s error), each a
    ``bf16_step``; the gradients of ``GRAD_NOISE_ONLY`` left out."""
    def rel(x, y):
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)

    witness = {f"output {k}": (rel(test[1][k], fp32[1][k]), rel(plain[1][k], fp32[1][k]))
               for k in fp32[1]}
    witness.update({k: (rel(test[2][k], fp32[2][k]), rel(plain[2][k], fp32[2][k]))
                    for k in fp32[2] if not k.endswith(GRAD_NOISE_ONLY)})
    return witness


# The MoE routes' router probabilities, card against a compared route
# (the CPU, the card's plain or fp32 route) at the same layer call: the
# inputs differ by the routes' rounding run through the layers before. An
# expectation, not a reading: about 1e-2 on the logits' scale makes a few
# 1e-3 of probability; a router fault (other weights, a wrong softmax)
# moves probabilities by O(0.1).
ROUTER_PROB_TOL = 0.05


class MoERouting:
    """Within: the compared routes take the card's expert choices. Every
    ``MoEFeedForward.select`` on the card's kernels' route records its
    router probabilities and choices, call by call; on a compared route (a
    call on the CPU, or on the card under ``plain_attention_route``) the
    calls take the recorded choices in the same order, the recording
    replayed from its start each time it runs out. Routing is a step
    function of the probabilities: two routes that round differently can
    send a token to another expert, an O(1) change that says nothing of the
    kernels, so pinned, the routes compare their numbers. At the end the
    pin holds itself: the compared routes made as many calls as a whole
    number of recordings, the probabilities' largest difference at a call
    (``eps``) is at most ``ROUTER_PROB_TOL``, and each token whose own
    choices would differ is explained: under the compared route's
    probabilities p, the card's choices c_1..c_K are the top K within 2 eps
    (p[c_j] >= p[c_j+1] - 2 eps, and no other expert above min_j p[c_j] by
    more than 2 eps), as they must be if the card sorted probabilities
    within eps of p."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        from r3d_tpu_torch.models import layers
        from r3d_tpu_torch.models.moe import MoEFeedForward

        self.orig, self.kernel_route = MoEFeedForward.select, layers.attention_kernel_eligible
        self.recorded, self.replaying, self.i = [], False, 0
        self.differ = self.total = 0
        self.eps, self.flips = 0.0, []
        pin = self

        def select(module, probs):
            own = pin.orig(module, probs)
            if pin.card_route(probs):
                if pin.replaying:   # a new recording, once the last was replayed whole
                    pin.check_whole()
                    pin.recorded, pin.replaying, pin.i = [], False, 0
                pin.recorded.append((probs.detach().float(), own))
                return own
            if not pin.recorded:
                raise AssertionError(f"{pin.label}: a compared route routed before the card")
            pin.replaying = True
            card_probs, chosen = pin.recorded[pin.i % len(pin.recorded)]
            pin.i += 1
            if chosen.shape != own.shape:
                raise AssertionError(f"{pin.label}: a compared route's MoE call {pin.i} routes "
                                     f"{tuple(own.shape)} choices, the card's {tuple(chosen.shape)}")
            p = probs.detach().float()
            chosen = chosen.to(own.device)
            pin.eps = max(pin.eps, float((p - card_probs.to(p.device)).abs().max()))
            rows = (own != chosen).any(-1)
            pin.differ += int(rows.sum())
            pin.total += own.shape[0]
            if rows.any():
                pin.flips.append((p[rows], chosen[rows]))
            return chosen

        MoEFeedForward.select = select
        return self

    def check_whole(self):
        """The compared routes replayed the recording a whole number of times."""
        if not self.total or self.i % len(self.recorded):
            raise AssertionError(f"{self.label}: {self.i} compared MoE calls against a "
                                 f"recording of {len(self.recorded)}")

    def card_route(self, probs) -> bool:
        """Whether a call is the card's kernels' route's (recorded) rather
        than a compared route's."""
        from r3d_tpu_torch.models import layers

        return (probs.device.type != "cpu"
                and layers.attention_kernel_eligible is self.kernel_route)

    def __exit__(self, exc_type, *exc):
        import torch

        from r3d_tpu_torch.models.moe import MoEFeedForward

        MoEFeedForward.select = self.orig
        if exc_type is not None:
            return False
        unexplained = 0
        for p, c in self.flips:
            pc = p.gather(-1, c)                                      # [n, K]
            others = p.scatter(-1, c, float("-inf")).amax(-1)         # the best unchosen
            # how far each token's choices break the top-K order under p
            gaps = torch.cat([pc[:, 1:] - pc[:, :-1], (others - pc.amin(-1))[:, None]], -1)
            unexplained += int((gaps.amax(-1) > 2 * self.eps).sum())
        print(f"{self.label}: the compared routes take the card's expert choices; "
              f"{self.differ} of {self.total} token choices would differ, {unexplained} not "
              f"explained by the router probabilities' largest difference {self.eps:.3e} "
              f"(bound {ROUTER_PROB_TOL})")
        self.check_whole()
        if self.eps > ROUTER_PROB_TOL or unexplained:
            raise AssertionError(f"{self.label}: the router probabilities differ by "
                                 f"{self.eps:.3e}, or a token's choices are not explained by it")
        return False


def step_kernels_vs_plain(cfg, state_dict, batch, n_class, kernels):
    """One dropout-off train step's outputs, loss and gradients on the card
    from the same weights and batch through the kernels (K3 forward, K5
    backward), through the plain route (``plain_attention_route``) and
    through the plain route in fp32: the two bf16 routes' outputs within
    ``PROPOSED_E2E_TOL`` of each other, their losses within
    ``PROPOSED_LOSS_TOL``, every gradient entry within ``PROPOSED_GRAD_TOL``
    of the model's largest and the whole gradient vectors' cosine at least
    ``PROPOSED_COS_MIN``; against fp32, each output and gradient of the
    kernels' route within ``PROPOSED_WITNESS_FACTOR`` (with the encoder
    ``ENCODER_WITNESS_FACTOR``) times the bf16 plain route's error; and the
    launches of an eval forward of the batch (a validation or sweep chunk
    of the bucket) on the kernels' route. Returns the readings."""
    import dataclasses

    import torch

    model = dataclasses.replace(cfg.model, dropout=0.0)
    cfg = cfg.replace(model=model)
    cfg32 = cfg.replace(model=dataclasses.replace(model, compute_dtype="float32",
                                                  embed_dtype=None))
    witness_factor = ENCODER_WITNESS_FACTOR if model.use_encoder else PROPOSED_WITNESS_FACTOR
    res = {"kernels": bf16_step(cfg, state_dict, batch, n_class, kernels)}
    with plain_attention_route():
        for route, c in (("plain", cfg), ("fp32", cfg32)):
            res[route] = bf16_step(c, state_dict, batch, n_class, kernels)
    eval_launches = res["kernels"][5]
    (lk, ok, gk, nk, tk, _), (lp, op, gp, npl, tp, _) = res["kernels"], res["plain"]
    l32, o32, g32, n32, _, _ = res["fp32"]

    def rel(x, y):
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)

    out_err = {k: float((ok[k] - op[k]).abs().max()) for k in ok}
    diff = {k: float((gk[k] - gp[k]).abs().max()) for k in gp}
    top = max(float(g.abs().max()) for g in gp.values())
    worst = max(diff, key=diff.get)
    names = sorted(gp)
    cos = float(torch.nn.functional.cosine_similarity(
        torch.cat([gk[k].double().flatten() for k in names]),
        torch.cat([gp[k].double().flatten() for k in names]), dim=0))
    # against the fp32 witness: (kernels' error, bf16 plain route's error)
    witness = witness_errors(res["kernels"], res["plain"], res["fp32"])
    ratio = {k: a / max(b, 1e-30) for k, (a, b) in witness.items()}
    far = max(ratio, key=ratio.get)
    B, S = batch["features"].shape[:2]
    print(f"{cfg.name} train step, bucket {S} batch of {B}, kernels vs the plain route on the "
          f"card (dropout off): loss {lk:.6f} vs {lp:.6f} (tol {PROPOSED_LOSS_TOL}; fp32 "
          f"{l32:.6f}); max|output diff| " + ", ".join(f"{k} {e:.3e}" for k, e in out_err.items())
          + f" (tol {PROPOSED_E2E_TOL}); over {len(gp)} gradients max|diff| over the model's "
          f"largest entry {diff[worst] / top:.3e} in {worst} (tol {PROPOSED_GRAD_TOL}); gradient "
          f"cosine {cos:.6f} (min {PROPOSED_COS_MIN}); launches {nk} vs {npl} (fp32 {n32}), "
          f"an eval forward of the batch on the kernels' route {eval_launches}; "
          f"forward + backward {1e3 * tk:.1f} vs {1e3 * tp:.1f} ms (first calls)")
    print(f"  against the fp32 plain route, over each one's largest fp32 entry, kernels' route "
          f"/ bf16 plain route, at most {ratio[far]:.3f} apart in {far} "
          f"({witness[far][0]:.2e} / {witness[far][1]:.2e}; tol {witness_factor}); largest 8 "
          f"of the kernels' route: "
          + ", ".join(f"{k} {witness[k][0]:.2e} / {witness[k][1]:.2e}"
                      for k in sorted(witness, key=lambda k: -witness[k][0])[:8])
          + "; not gated, rounding noise only: "
          + ", ".join(f"{k} {rel(gk[k], g32[k]):.2e} / {rel(gp[k], g32[k]):.2e}"
                      for k in g32 if k.endswith(GRAD_NOISE_ONLY)))
    if not nk or npl or n32 or not eval_launches:
        raise AssertionError(f"{cfg.name}: the routes launched {nk}, {npl} and {n32}, the "
                             f"eval forward {eval_launches}")
    if not (abs(lk - lp) <= PROPOSED_LOSS_TOL and max(out_err.values()) <= PROPOSED_E2E_TOL
            and diff[worst] <= PROPOSED_GRAD_TOL * top and cos >= PROPOSED_COS_MIN):
        raise AssertionError(f"{cfg.name}: the kernels' train step disagrees with the plain "
                             "route's")
    if not ratio[far] <= witness_factor:
        raise AssertionError(f"{cfg.name}: against fp32, the kernels' route is further off "
                             f"than the bf16 plain route in {far}")
    return {"loss_diff": abs(lk - lp), "out_err": max(out_err.values()), "cos": cos,
            "witness_ratio": ratio[far], "launches": nk, "eval_launches": eval_launches}


def proposed_cli(kernels, card, name, k3, k4, k5):
    """``name`` (``50salads_proposed`` or ``breakfast_proposed``) at full
    width through the CLI: write a dataset of the config's layout
    (``PROPOSED_DATA``), every launch count set to 0, ``train`` one seed for
    2 epochs on the JAX CLI's route (the device cache, its log line
    asserted), where each epoch's training must launch K4 (``k4``, the loop
    is not sticky) and K5 and each validation K3, and the largest bucket must
    come up in training; the 9-ratio sweep from the best checkpoint on the
    card from the cached val videos, where every chunk of 256 rows or more
    must launch K3; the host sweep, equal to it; the sweep with ``--cpu``,
    held window by window (logits and durations within
    ``PROPOSED_E2E_TOL``, every MoC difference explained by a margin or a
    frame edge); one train step at the largest bucket through the kernels
    against the plain route on the card; and the parts of that step. Returns
    (train counts, sweep counts, the launches of an eval chunk of the
    largest bucket)."""
    import io
    import os
    import shutil

    import torch

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args, run_from_argv
    from r3d_tpu_torch.cli.run import save_path
    from r3d_tpu_torch.data.datasets import build_loader, build_source

    train_lengths, val_lengths, big = PROPOSED_DATA[name]
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, PROPOSED_DIR, name)
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        root = write_proposed_dataset(os.path.join(work, "data"), name, train_lengths,
                                      val_lengths, run=(30, 300))
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        print(f"{name}: dataset of {len(train_lengths)} + {len(val_lengths)} videos "
              f"({min(train_lengths)}-{max(train_lengths)} frames), {size / 2**20:.0f} MiB "
              f"written in {time.perf_counter() - t0:.2f} s")
        # the schedule at its peak from the first step: 2 epochs of a 10-epoch
        # warmup would train at lr 0 first
        argv = ["--config", name, "--data_root", root, "--model_save_path",
                os.path.join(work, "save"), "--seed", "1", "--warmup_epochs", "0"]
        config = config_from_args(build_parser(name).parse_args(argv))
        m = config.model
        print(f"{name}: hidden {m.hidden_dim}, {m.n_head} heads of {m.hidden_dim // m.n_head}, "
              f"{m.n_decoder_layers} decoder layers, {m.n_query} queries, query_num "
              f"{m.query_num}, batch {config.train.batch_size}, compute {m.compute_dtype}, "
              f"buckets {config.data.seq_buckets}")
        buckets = []
        lines, snapshots, train_counts, t_train = cli_train(argv, kernels, buckets=buckets)
        if not any(line.startswith(CLI_ROUTE) and "views" in line for line in lines):
            raise AssertionError(f"{name} train: the cached route's line is missing: {lines}")
        phases = ["epoch 0 train", "epoch 0 validation", "epoch 1 train", "epoch 1 validation"]
        per_phase, prev = {}, {k.name: 0 for k in kernels}
        for phase, snap in zip(phases, snapshots):
            per_phase[phase] = {k: snap[k] - prev[k] for k in snap if snap[k] - prev[k]}
            prev = snap
            steps = [(S, B) for i, S, B in buckets if i == phases.index(phase)]
            print(f"{name}: {phase}: batches (bucket, rows) {steps}; launches {per_phase[phase]}")
        want = {"epoch 0 train": (k4.name, k5.name), "epoch 1 train": (k4.name, k5.name),
                "epoch 0 validation": (k3.name,), "epoch 1 validation": (k3.name,)}
        for phase, names in want.items():
            missing = [n for n in names if per_phase.get(phase, {}).get(n, 0) == 0]
            if missing:
                raise AssertionError(f"{name} train: {phase} never launched {missing}")
        trained = [S for i, S, _ in buckets if i in (0, 2)]
        if big not in trained:
            raise AssertionError(f"{name} train: no step in the {big} bucket: {trained}")
        losses = [float(x) for line in lines
                  for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name} train: a loss is missing or not finite: {lines}")
        ckpt_dir = save_path(config)
        names = sorted(os.listdir(ckpt_dir))
        for need in ("seed_1_last", "seed_1_metrics.jsonl"):
            if need not in names:
                raise AssertionError(f"{name} train: no {need} in {ckpt_dir}")
        gate = [line for line in lines if line.startswith("Best model saved")]
        if bool(gate) != ("seed_1_best" in names):
            raise AssertionError(f"{name} train: the gate's lines {gate} and {names} disagree")
        print(f"{name} [{card}]: train 2 epochs on the cached route in {t_train:.2f} s "
              f"(steps in buckets {trained}); the gate opened {len(gate)} times; {names}")

        predict = argv + ["--predict", "--results_save_path", os.path.join(work, "results")]
        runs = {}
        for run, extra in (("cuda", []), ("cuda_host", ["--no-device_cache"]),
                           ("cpu", ["--cpu"])):
            for k in kernels:
                k.launches = 0
            quiet = io.StringIO() if run != "cuda" else sys.stdout
            sweep_log = []
            with SweepRecorder(kernels) as rec, contextlib.redirect_stdout(quiet):
                t0 = time.perf_counter()
                results = run_from_argv(name, predict + extra, log=sweep_log.append)
                if run != "cpu":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            if (CLI_SWEEP_ROUTE in sweep_log) != (run != "cuda_host"):
                raise AssertionError(f"{name} sweep {run}: route {sweep_log}")
            runs[run] = (results, rec.chunks, dt, {k.name: k.launches for k in kernels})
        results, chunks, _, sweep_counts = runs["cuda"]
        per_bucket = {}
        for c in chunks:
            per_bucket[c["S"]] = per_bucket.get(c["S"], 0) + 1
            if (c["launches"][k3.name] > 0) != (c["S"] >= 256):
                raise AssertionError(f"{name} sweep: a {c['S']}-bucket chunk launched "
                                     f"{c['launches'][k3.name]} K3")
        if not {256, 512, 1024} <= set(per_bucket):
            raise AssertionError(f"{name} sweep: chunks per bucket {per_bucket}")
        host_chunks, cpu_chunks = runs["cuda_host"][1], runs["cpu"][1]
        for other in (host_chunks, cpu_chunks):
            if [c["windows"] for c in other] != [c["windows"] for c in chunks]:
                raise AssertionError(f"{name} sweep: the runs swept different windows")
        cached_vs_host = max(float(np.abs(a[key] - b[key]).max())
                             for a, b in zip(chunks, host_chunks) for key in ("action", "duration"))
        err = max(float(np.abs(a[key] - b[key]).max())
                  for a, b in zip(chunks, cpu_chunks) for key in ("action", "duration"))
        for c in chunks:
            if not (np.isfinite(c["action"]).all() and np.isfinite(c["duration"]).all()):
                raise AssertionError(f"{name} sweep: non-finite outputs in a {c['S']} chunk")
        n_class = build_source(config.data, "train.split1.bundle").n_class
        flipped, unexplained = decode_flips(chunks, cpu_chunks, err, n_class=n_class)
        cpu_res = runs["cpu"][0]
        diff = [(k, abs(results[o][k] - cpu_res[o][k])) for o in cpu_res for k in cpu_res[o]]
        moc_diff = max(d for k, d in diff if k.startswith("obs"))
        acc_diff = max(d for k, d in diff if not k.startswith("obs"))
        n_windows = sum(len(c["windows"]) for c in chunks)
        print(f"{name} sweep on the card [{card}], from the cached val videos:\n"
              f"{moc_table(results)}")
        print(f"{name} sweep on the CPU:\n{moc_table(cpu_res)}")
        print(f"{name} sweep [{card}]: {n_windows} windows in {len(chunks)} chunks, per bucket "
              f"{dict(sorted(per_bucket.items()))}; K3 in every chunk of the 256 and 512 "
              f"buckets; "
              f"launches { {k: c for k, c in sweep_counts.items() if c} }; cached vs host max|"
              f"diff| {cached_vs_host:.3e} (must be 0); card vs CPU max|logit or duration diff| "
              f"{err:.3e} (tol {PROPOSED_E2E_TOL}), max|MoC diff| {moc_diff:.3e}, max|accuracy "
              f"diff| {acc_diff:.3e} (l3_acc included), {flipped} of {n_windows} windows decoded "
              f"differently ({unexplained} not explained); wall {runs['cuda'][2]:.2f} s cached, "
              f"{runs['cuda_host'][2]:.2f} s host, {runs['cpu'][2]:.2f} s on the CPU")
        if any("l3_acc" not in r for r in results.values()):
            raise AssertionError(f"{name} sweep: no l3_acc in {results}")
        if cached_vs_host != 0 or results != runs["cuda_host"][0]:
            raise AssertionError(f"{name} sweep: the cached sweep differs from the host sweep")
        if err > PROPOSED_E2E_TOL:
            raise AssertionError(f"{name} sweep: the card's outputs disagree with the CPU's")
        if unexplained or (moc_diff > 0 and flipped == 0):
            raise AssertionError(f"{name} sweep: the card's MoC table differs from the CPU's "
                                 "where the measured errors cannot explain it")

        # one step of the largest bucket: kernels against the plain route, and its parts
        src = build_source(config.data, "train.split1.bundle")
        loader = build_loader(src, config.data, config.train.batch_size, m.n_query,
                              pin_memory=True)
        batch = batch_with_longest(loader, config.train.batch_size)
        if batch["features"].shape[1] != big:
            raise AssertionError(f"{name}: the held batch fell in bucket "
                                 f"{batch['features'].shape[1]}, not {big}")
        state_dict = final_model(ckpt_dir, "seed_1_last")
        step = step_kernels_vs_plain(config, state_dict, batch, n_class, kernels)
        train_breakdown(config, state_dict, loader, n_class=n_class, label=f" ({name})",
                        make_batch=lambda: batch_with_longest(loader, config.train.batch_size))
        return train_counts, sweep_counts, step["eval_launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- the DARai family: darai (futr_unsupervised) and darai_gaze (futr_gaze) ----

DARAI_DIR = "build/darai_phase"   # under the checkout (git-ignored), removed after
# Each video a tuple of its sequences' lengths. At sample rate 15 and the
# train ratios 0.2/0.3/0.5 a sequence of 10,500-12,800 frames gives 140-256
# rows (the 256 bucket) and 350-427 (the 512 bucket); 8 train sequences make
# 24 views, 3 batches of 8. The 2 val sequences give sweep windows of 74-720
# rows (the 128-1024 buckets). About 0.98 GB of fp32 features.
DARAI_TRAIN = ((12000, 11500), (12500, 11000), (11800, 12200), (10500, 12800))
DARAI_VAL = ((12000, 11000),)
DARAI_GAZE_ROWS = (1200, 1900)   # raw gaze rows a video, padded to the 2000 bucket
DARAI_E2E_TOL = 1e-3   # logits and durations, card vs CPU, fp32 on both (TF32 off)
DARAI_LOSS_TOL = 1e-4  # a train step's loss, kernels vs the plain route on the card
DARAI_OUT_TOL = 1e-4   # its outputs
DARAI_GRAD_TOL = 1e-4  # a gradient entry over the model's largest gradient entry


def fp32_step(cfg, state_dict, batch, n_class, kernels):
    """One train step of the sticky epochs' forward (``Trainer._train_mode``:
    the configured dropouts off, the fixed-rate ones on, their generators
    seeded alike on every call) of an fp32 config on the card from the
    given weights and batch, on whatever route is in force: (loss, outputs,
    gradients by parameter name, launches)."""
    import torch

    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, n_class)
    state = trainer.init_state(1, state_dict)
    trainer._seed_dropout(state, SEED, 0)
    trainer._train_mode(state.model, 1)
    dev = trainer.to_device(trainer._with_seg_ids(batch))
    before = {k.name: k.launches for k in kernels}
    outputs = state.model(*trainer._model_inputs(dev, with_mask=True))
    total, _ = trainer._losses(outputs, dev, epoch=1)
    total.backward()
    torch.cuda.synchronize()
    return (float(total.detach()),
            {k: v.detach().float() for k, v in outputs.items() if k != "supcon"},
            {k: p.grad.clone() for k, p in state.model.named_parameters() if p.grad is not None},
            {k.name: k.launches - before[k.name] for k in kernels
             if k.launches - before[k.name]})


def grad_gaps(got, want):
    """Per parameter max|got - want|, and (the largest over the model's
    largest entry of ``want``, its parameter, the largest among the fuser's
    parameters over the fuser's largest entry, its parameter; the last two
    None where the model has no fuser)."""
    diff = {k: float((got[k] - want[k]).abs().max()) for k in want}
    worst = max(diff, key=diff.get)
    top = max(float(g.abs().max()) for g in want.values())
    fuser = [k for k in want if k.startswith("fuser.")]
    if not fuser:
        return diff, (diff[worst] / top, worst, None, None)
    f_worst = max(fuser, key=diff.get)
    f_top = max(float(want[k].abs().max()) for k in fuser)
    return diff, (diff[worst] / top, worst, diff[f_worst] / f_top, f_worst)


def fp32_step_kernels_vs_plain(cfg, state_dict, batch, n_class, kernels):
    """``fp32_step`` through the kernels and through the plain routes
    (``plain_routes``: the attention and the fuser tail): loss within
    ``DARAI_LOSS_TOL``, outputs within ``DARAI_OUT_TOL``, every gradient
    entry within ``DARAI_GRAD_TOL`` of the model's largest gradient entry
    (not of its own tensor's: the duration head's weight gradient is a
    difference of near-equal terms, the gaze model's 8 queries being alike,
    and read 3.3e-2 of its own largest entry on an H100 with the loss and
    outputs within 1e-6), or ``ABLATION_GRAD_TOL`` where the embeds run in
    bf16; where the model has a fuser, every fuser gradient entry also
    within ``FUSER_GRAD_TOL`` of the fuser's largest gradient entry (its
    gradients are small beside the embeds'). The kernels' route must
    launch, the plain route must not. Returns the plain route's step."""
    res = {"kernels": fp32_step(cfg, state_dict, batch, n_class, kernels)}
    with plain_routes():
        res["plain"] = fp32_step(cfg, state_dict, batch, n_class, kernels)
    (lk, ok, gk, nk), (lp, op, gp, npl) = res["kernels"], res["plain"]
    out_err = max(float((ok[k] - op[k]).abs().max()) for k in op)
    diff, (model_gap, worst, fuser_gap, f_worst) = grad_gaps(gk, gp)
    grad_tol = ABLATION_GRAD_TOL if cfg.model.embed_dtype == "bfloat16" else DARAI_GRAD_TOL
    own = {k: diff[k] / max(float(gp[k].abs().max()), 1e-30) for k in gp}
    B, S = batch["features"].shape[:2]
    print(f"{cfg.name} train step, bucket {S} batch of {B}, sticky (the configured dropout "
          f"off, the fixed-rate dropouts seeded alike), kernels vs "
          f"the plain route on the card: loss {lk:.6f} vs {lp:.6f} (tol {DARAI_LOSS_TOL}); "
          f"max|output diff| {out_err:.3e} over {sorted(op)} (tol {DARAI_OUT_TOL}); over "
          f"{len(gp)} gradients max|diff| over the model's largest entry {model_gap:.3e} "
          f"in {worst} (tol {grad_tol}); largest over its own tensor's: " + ", ".join(
              f"{k} {own[k]:.2e}" for k in sorted(own, key=lambda k: -own[k])[:4])
          + (f"; the fuser's over its largest entry {fuser_gap:.3e} in {f_worst} (tol "
             f"{FUSER_GRAD_TOL})" if f_worst else "") + f"; launches {nk} vs {npl}")
    if not nk or npl:
        raise AssertionError(f"{cfg.name}: the routes launched {nk} and {npl}")
    if not (abs(lk - lp) <= DARAI_LOSS_TOL and out_err <= DARAI_OUT_TOL
            and model_gap <= grad_tol and (f_worst is None or fuser_gap <= FUSER_GRAD_TOL)):
        raise AssertionError(f"{cfg.name}: the kernels' train step disagrees with the plain "
                             "route's")
    return res["plain"]


def validation_per_video(config, state_dict, source, n_class):
    """``darai``'s validation from the val cache, one video a batch as the
    config runs it: its wall time (median of 3) and, from a profiled pass,
    the card's busy time and launches, each over the number of views."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from r3d_tpu_torch.cli.run import VAL_CACHE_BYTES
    from r3d_tpu_torch.data import device_cache as dc
    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(config, n_class)
    state = trainer.init_state(1, state_dict)
    cache = dc.cache_from_source(source, config.data, config.model.n_query,
                                 max_bytes=VAL_CACHE_BYTES, device="cuda")
    validate = trainer._cached_validator(None, cache, max(1, config.train.steps_per_dispatch))
    validate(state)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        validate(state)
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        validate(state)
        torch.cuda.synchronize()
    events = card_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    n = cache.n_views
    print(f"{config.name} validation from the val cache, batch {config.train.val_batch_size}: "
          f"{n} views, median {1e3 * float(np.median(times)) / n:.2f} ms a view (of 3 passes), "
          f"card busy {busy / n:.3f} ms and {sum(e.count for e in events) / n:.1f} launches a "
          f"view (one profiled pass)")


def l3_flips(chunks, ref_chunks, err):
    """Frames whose L3 argmax differs between two sweeps of the same
    windows, and those of them whose reference top-2 margin exceeds
    ``err`` (not explained by the measured error)."""
    flipped = unexplained = 0
    for a, b in zip(chunks, ref_chunks):
        if b["l3"] is None:
            continue
        diff = a["l3"].argmax(-1) != b["l3"].argmax(-1)
        top = np.sort(b["l3"], axis=-1)
        margin = top[..., -1] - top[..., -2]
        flipped += int(diff.sum())
        unexplained += int((diff & (margin > err)).sum())
    return flipped, unexplained


def darai_cli(kernels, card, name, root, k3, k4, k5, model=None):
    """``name`` (``darai`` or ``darai_gaze``) at full width through the CLI
    over the dataset at ``root``: every launch count set to 0, ``train`` one
    seed for 2 epochs on the JAX CLI's route (``darai``: the device cache,
    its line asserted; ``darai_gaze``: the host loader, the cache declining
    the gaze stream), where epoch 0's training must launch K4 (``k4``) and
    K5 (``k5``), epoch 1's (sticky) K3 (``k3``) and K5 and no K4, and each
    validation K3; for ``darai`` the same ``train`` with
    ``--no-device_cache``, and ``fit`` over the host loader in the cached
    route's order, bit-equal to the cached run; the 9-ratio sweep at
    ``eval_batch=1`` from the best checkpoint on the card (``darai``: from
    the cached val videos, and the host sweep equal to it), every chunk of
    the 256 and 512 buckets launching K3 once and the others nothing, with
    its card time from a profiled sweep;
    the sweep with ``--cpu``, held window by window (logits, durations and
    L3 logits within ``DARAI_E2E_TOL``, every decode or L3 flip explained by
    a margin or a frame edge, MoC and ``l3_acc`` otherwise equal); one
    512-bucket step through the kernels against the plain route; the parts
    of that step in epoch 0 and sticky; a sticky step that holds the
    fixed-rate dropouts (``sticky_dropout_on_card``); for ``darai`` the
    validation's time and launches a video. With ``model`` (``--model
    <model>``, the depth source) the same run of that model, whose S queries
    launch K3 in self- and cross-attention from the 256 bucket up. Returns
    (train counts, sweep counts)."""
    import dataclasses
    import io
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args, run_from_argv
    from r3d_tpu_torch.cli.run import save_path
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.train.loop import Trainer

    cached = name == "darai"
    label = name if model is None else f"{name} --model {model}"
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), DARAI_DIR, model or name)

    def chunk_launches(S):
        # K3 takes 8 queries against 256-512 keys (attention_kernel_eligible),
        # the depth source's S queries from 256 keys up; the other buckets,
        # and every other kernel, the plain route
        if model is not None:
            return {k3.name: 2} if S >= 256 else {}
        return {k3.name: 1} if S in (256, 512) else {}
    shutil.rmtree(work, ignore_errors=True)
    try:
        # the schedule at its peak from the first step: 2 epochs of a 10-epoch
        # warmup would train at lr 0 first
        argv = ["--config", name, "--data_root", root, "--model_save_path",
                os.path.join(work, "save"), "--seed", "1", "--warmup_epochs", "0"]
        if model is not None:
            argv += ["--model", model]
        config = config_from_args(build_parser(name).parse_args(argv))
        m = config.model
        print(f"{label}: {m.model}, hidden {m.hidden_dim}, {m.n_head} heads of "
              f"{m.hidden_dim // m.n_head}, {m.n_decoder_layers} decoder layer, {m.n_query} "
              f"queries, input {m.input_dim}, query_num {m.query_num}, batch "
              f"{config.train.batch_size}, val batch {config.train.val_batch_size}, compute "
              f"{m.compute_dtype}, loop {config.train.loop}, buckets {config.data.seq_buckets}")
        buckets = []
        lines, snapshots, train_counts, t_train = cli_train(argv, kernels, buckets=buckets)
        took_cache = any(line.startswith(CLI_ROUTE) and "views" in line for line in lines)
        if took_cache != cached:
            raise AssertionError(f"{label} train: the route's lines {lines}")
        phases = ["epoch 0 train", "epoch 0 validation", "epoch 1 train", "epoch 1 validation"]
        per_phase, prev = {}, {k.name: 0 for k in kernels}
        for phase, snap in zip(phases, snapshots):
            per_phase[phase] = {k: snap[k] - prev[k] for k in snap if snap[k] - prev[k]}
            prev = snap
            steps = [(S, B) for i, S, B in buckets if i == phases.index(phase)]
            print(f"{label}: {phase}: cached batches (bucket, rows) {steps}; launches "
                  f"{per_phase[phase]}")
        want = {"epoch 0 train": (k4.name, k5.name), "epoch 1 train": (k3.name, k5.name),
                "epoch 0 validation": (k3.name,), "epoch 1 validation": (k3.name,)}
        for phase, names in want.items():
            missing = [n for n in names if per_phase.get(phase, {}).get(n, 0) == 0]
            if missing:
                raise AssertionError(f"{label} train: {phase} never launched {missing}")
        if per_phase["epoch 1 train"].get(k4.name, 0):
            raise AssertionError(f"{label} train: the sticky epoch launched K4")
        losses = [float(x) for line in lines
                  for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label} train: a loss is missing or not finite: {lines}")
        ckpt_dir = save_path(config)
        names = sorted(os.listdir(ckpt_dir))
        for need in ("seed_1_last", "seed_1_metrics.jsonl"):
            if need not in names:
                raise AssertionError(f"{label} train: no {need} in {ckpt_dir}")
        gate = [line for line in lines if line.startswith("Best model saved")]
        if bool(gate) != ("seed_1_best" in names):
            raise AssertionError(f"{label} train: the gate's lines {gate} and {names} disagree")
        print(f"{label} [{card}]: train 2 epochs on the {'cached' if cached else 'host'} route "
              f"in {t_train:.2f} s; the gate opened {len(gate)} times; {names}")
        final = final_model(ckpt_dir, "seed_1_last")
        sources = {s: build_source(config.data, f"{s}_split.txt") for s in ("train", "val")}
        n_class = sources["train"].n_class
        nq = config.model.n_query
        train = build_loader(sources["train"], config.data, config.train.batch_size, nq, seed=1,
                             pin_memory=True)
        if cached:
            host_argv = argv[:5] + [os.path.join(work, "save_host")] + argv[6:]
            host_lines, _, _, t_host = cli_train(host_argv, kernels, ["--no-device_cache"])
            if any(line.startswith(("device cache", "hybrid cache")) for line in host_lines):
                raise AssertionError(f"{label} --no-device_cache took a cache: {host_lines}")
            host_losses = [float(x) for line in host_lines
                           for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
            if len(host_losses) != 4 or not all(math.isfinite(x) for x in host_losses):
                raise AssertionError(f"{label} --no-device_cache: a loss is not finite")
            # the cached route's batches through the host loader
            val = build_loader(sources["val"], config.data, 1, nq, mode="val", shuffle=False,
                               pin_memory=True)
            trainer = Trainer(config.replace(train=dataclasses.replace(config.train, epochs=2)),
                              n_class)
            state = trainer.init_state(len(train), seed=1)
            t0 = time.perf_counter()
            trainer.fit(state, train, val, seed=1, log=lambda *a: None)
            torch.cuda.synchronize()
            diff = unequal(final, state.model.state_dict())
            print(f"{label} [{card}]: --no-device_cache {t_host:.2f} s (the host loader from "
                  f"seed + 1, losses {host_losses}); fit over the host loader in the cached "
                  f"order {time.perf_counter() - t0:.2f} s: {len(diff)} of {len(final)} "
                  "tensors differ from the cached run's (bit for bit)")
            if diff:
                raise AssertionError(f"{label}: the host loader's final parameters differ from "
                                     f"the cached route's: {diff}")
            del trainer, state

        predict = argv + ["--predict", "--eval_batch", "1", "--results_save_path",
                          os.path.join(work, "results")]
        runs = {}
        sweeps = (("cuda", []), ("cuda_host", ["--no-device_cache"]), ("cpu", ["--cpu"]))
        for run, extra in sweeps if cached else (sweeps[0], sweeps[2]):
            for k in kernels:
                k.launches = 0
            quiet = io.StringIO() if run != "cuda" else sys.stdout
            sweep_log = []
            with SweepRecorder(kernels) as rec, contextlib.redirect_stdout(quiet):
                t0 = time.perf_counter()
                results = run_from_argv(name, predict + extra, log=sweep_log.append)
                if run != "cpu":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            if (CLI_SWEEP_ROUTE in sweep_log) != (cached and run != "cuda_host"):
                raise AssertionError(f"{label} sweep {run}: route {sweep_log}")
            runs[run] = (results, rec.chunks, dt, {k.name: k.launches for k in kernels})
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof, contextlib.redirect_stdout(io.StringIO()):
            run_from_argv(name, predict, log=lambda *a: None)
            torch.cuda.synchronize()
        events = card_events(prof)
        sweep_busy = sum(e.self_device_time_total for e in events) / 1e3
        results, chunks, t_sweep, sweep_counts = runs["cuda"]
        per_bucket = {}
        for c in chunks:
            per_bucket[c["S"]] = per_bucket.get(c["S"], 0) + 1
            if len(c["windows"]) != 1:
                raise AssertionError(f"{label} sweep: a chunk of {len(c['windows'])} windows")
            launched = {k: n for k, n in c["launches"].items() if n}
            if launched != chunk_launches(c["S"]):
                raise AssertionError(f"{label} sweep: a {c['S']}-bucket chunk launched "
                                     f"{launched}")
        if not {128, 256, 512, 1024} <= set(per_bucket):
            raise AssertionError(f"{label} sweep: chunks per bucket {per_bucket}")
        cpu_res, cpu_chunks = runs["cpu"][0], runs["cpu"][1]
        others = [cpu_chunks] + ([runs["cuda_host"][1]] if cached else [])
        for other in others:
            if [c["windows"] for c in other] != [c["windows"] for c in chunks]:
                raise AssertionError(f"{label} sweep: the runs swept different windows")
        keys = ("action", "duration") + (("l3",) if cached else ())
        err = max(float(np.abs(a[k] - b[k]).max())
                  for a, b in zip(chunks, cpu_chunks) for k in keys)
        for c in chunks:
            if not all(np.isfinite(c[k]).all() for k in keys):
                raise AssertionError(f"{label} sweep: non-finite outputs in a {c['S']} chunk")
        flipped, unexplained = decode_flips(chunks, cpu_chunks, err, n_class=n_class)
        l3_flipped, l3_unexplained = l3_flips(chunks, cpu_chunks, err)
        diff = [(k, abs(results[o][k] - cpu_res[o][k])) for o in cpu_res for k in cpu_res[o]]
        moc_diff = max(d for k, d in diff if k.startswith("obs"))
        l3_diff = max([d for k, d in diff if k == "l3_acc"], default=0.0)
        n_windows = sum(len(c["windows"]) for c in chunks)
        print(f"{label} sweep on the card [{card}]:\n{moc_table(results)}")
        print(f"{label} sweep on the CPU:\n{moc_table(cpu_res)}")
        host = ""
        if cached:
            cached_vs_host = max(float(np.abs(a[k] - b[k]).max())
                                 for a, b in zip(chunks, runs["cuda_host"][1]) for k in keys)
            host = (f"cached vs host max|diff| {cached_vs_host:.3e} (must be 0), host sweep "
                    f"{runs['cuda_host'][2]:.2f} s; ")
            if cached_vs_host != 0 or results != runs["cuda_host"][0]:
                raise AssertionError(f"{label} sweep: the cached sweep differs from the host "
                                     "sweep")
        print(f"{label} sweep [{card}], eval_batch 1: {n_windows} windows, per bucket "
              f"{dict(sorted(per_bucket.items()))}; each chunk's launches as its bucket's "
              f"route asks; "
              f"launches { {k: c for k, c in sweep_counts.items() if c} }; {host}card vs CPU "
              f"max|logit, duration or L3 logit diff| {err:.3e} (tol {DARAI_E2E_TOL}), max|MoC "
              f"diff| {moc_diff:.3e}, max|l3_acc diff| {l3_diff:.3e}, {flipped} of {n_windows} "
              f"windows decoded differently ({unexplained} not explained), {l3_flipped} L3 "
              f"frames flipped ({l3_unexplained} not explained); wall {t_sweep:.2f} s on the "
              f"card, card busy {sweep_busy:.2f} ms in {sum(e.count for e in events)} launches "
              f"(one profiled sweep), {runs['cpu'][2]:.2f} s on the CPU")
        if cached and any("l3_acc" not in r for r in results.values()):
            raise AssertionError(f"{label} sweep: no l3_acc in {results}")
        if err > DARAI_E2E_TOL:
            raise AssertionError(f"{label} sweep: the card's outputs disagree with the CPU's")
        if (unexplained or l3_unexplained or (moc_diff > 0 and flipped == 0)
                or (l3_diff > 0 and l3_flipped == 0)):
            raise AssertionError(f"{label} sweep: the card's MoC or l3_acc differs from the "
                                 "CPU's where the measured errors cannot explain it")

        # one step of the 512 bucket: kernels against the plain route, and its parts
        batch = one_batch(train, 256, rows=config.train.batch_size)
        if batch["features"].shape[1] != 512:
            raise AssertionError(f"{label}: the held batch fell in bucket "
                                 f"{batch['features'].shape[1]}, not 512")
        fp32_step_kernels_vs_plain(config, final, batch, n_class, kernels)
        train_breakdown(config, final, train, n_class=n_class, label=f" ({label})",
                        make_batch=lambda: one_batch(train, 256, rows=config.train.batch_size))
        if cached:
            validation_per_video(config, final, sources["val"], n_class)
        sticky_dropout_on_card(config, final, batch, n_class)
        return train_counts, sweep_counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- utkinects at UTKinect scale from the device cache ----

SCALE_VIDEOS = 200            # UTKinect: about 200 videos of 150-450 frames
SCALE_LENGTHS = (150, 450)
SCALE_VAL_VIDEOS = 16
SCALE_HOST_STEPS = 16         # steps a round of the host loader against the cache
SCALE_ROUNDS = 4
ACCUM_TOL = 1e-6              # grad_accum=2 against the mean taken by hand, over each
                              # tensor's largest entry: the same products in the same order


def scale_videos(cfg, n=SCALE_VIDEOS, lengths=SCALE_LENGTHS, seed=SEED, n_class=N_CLASS):
    """``n`` videos at the config's widths from a numpy seed: lengths drawn
    from ``lengths``, action runs of 5-14 frames, 2,048-d features that carry
    each frame's class, raw 160x120 depth frames of noise (views into one
    shared pool, so the host holds them once); the dicts ``build_cache``
    takes."""
    rng = np.random.default_rng(seed)
    D, dshape = cfg.model.input_dim, tuple(cfg.data.depth_shape)
    pool = 3 * lengths[1]
    depth_pool = rng.random((pool,) + dshape, dtype=np.float32)
    emb = rng.standard_normal((n_class - 1, D), dtype=np.float32)
    videos = []
    for _ in range(n):
        L = int(rng.integers(lengths[0], lengths[1] + 1))
        ids = []
        a = int(rng.integers(n_class - 1))
        while len(ids) < L:
            ids += [a] * int(rng.integers(5, 15))
            a = (a + 1 + int(rng.integers(n_class - 2))) % (n_class - 1)
        ids = np.array(ids[:L])
        o = int(rng.integers(pool - L))
        videos.append({"features": emb[ids] + 0.5 * rng.standard_normal((L, D), dtype=np.float32),
                       "label_idx": ids, "depth": depth_pool[o:o + L]})
    return videos


def scale_loader(cfg, videos, seed, shuffle=True, n_class=N_CLASS):
    """The host loader (pinned collate) over the views of ``build_cache(videos)``."""
    from r3d_tpu_torch.data.pipeline import BucketedLoader
    from r3d_tpu_torch.data.protocol import make_example_from_indices

    obs = cfg.data.train_obs_percs

    def fn(i):
        v = videos[i // len(obs)]
        return make_example_from_indices(v["features"], v["label_idx"], obs[i % len(obs)],
                                         cfg.data.sample_rate, cfg.model.n_query, n_class + 1,
                                         n_class, depth_features=v["depth"])

    return BucketedLoader(num_examples=len(videos) * len(obs), make_example_fn=fn,
                          batch_size=cfg.train.batch_size, pad_idx=n_class + 1,
                          buckets=cfg.data.seq_buckets, n_query=cfg.model.n_query,
                          with_depth=True, shuffle=shuffle, seed=seed,
                          feature_dtype=cfg.data.feature_dtype, pin_memory=True)


def utkinects_device_cache(kernels, card, state_dict):
    """utkinects at full width and UTKinect scale from the device cache:
    200 videos of 150-450 frames built from a seed (2,048-d features, 160x120
    depth frames, bf16 on the card), ``build_cache`` timed with its bytes;
    every launch count set to 0 and one epoch of ``fit_cached`` (10 ratios,
    batch 8: 250 steps in the 128, 256 and 512 buckets, then validation from
    a cache of 16 of the videos), which must launch the no-blend tail, its
    backward, the dropout attention and the attention backward, with its
    wall time and step time; a window of 8 cached 512-bucket steps in which
    the host may not wait for the card (torch's sync debug mode at 'error'),
    and a profiled window of 4 with the card's busy time and launches a
    step, in which no host-to-device copy may be larger than its index
    table; the same batches through the host loader and the cache, 16 steps
    a route in 4 interleaved rounds; a dispatch of 3
    cached steps, and ``make_multi_step`` over 3 host batches, each equal to
    3 single steps bit for bit; and one ``grad_accum=2`` update against the
    mean of the two microbatch gradients taken by hand (``ACCUM_TOL``).
    Returns the counts of the epoch."""
    import dataclasses
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.data import device_cache as dc
    from r3d_tpu_torch.train.loop import Trainer, _stack

    cfg = get_config("utkinects")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=1))
    trainer = Trainer(cfg, N_CLASS)
    t0 = time.perf_counter()
    videos = scale_videos(cfg)
    t_make = time.perf_counter() - t0
    args = dict(obs_percs=cfg.data.train_obs_percs, sample_rate=cfg.data.sample_rate,
                n_query=cfg.model.n_query, pad_idx=N_CLASS + 1, n_class=N_CLASS,
                buckets=cfg.data.seq_buckets, feature_dtype=cfg.data.feature_dtype,
                device=trainer.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = dc.build_cache(videos, **args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    val_cache = dc.build_cache(videos[:SCALE_VAL_VIDEOS], **args)
    frames = sum(len(v["label_idx"]) for v in videos)
    print(f"cache [{card}]: {len(videos)} videos, {frames} frames (made on the host in "
          f"{t_make:.2f} s), {cache.n_views} views; build_cache {cache.nbytes / 2**30:.3f} GiB "
          f"on the card in {t_build:.2f} s ({cache.nbytes / t_build / 1e9:.2f} GB/s); val cache "
          f"{val_cache.n_views} views, {val_cache.nbytes / 2**30:.3f} GiB")

    plan = dc.epoch_plan(cache, cfg.train.batch_size, SEED, 0, drop_remainder=False)
    steps = len(plan)
    buckets = {S: sum(p[0] == S for p in plan) for S in sorted({p[0] for p in plan})}
    state = trainer.init_state(steps, state_dict)
    marks = {}

    def log(line):
        torch.cuda.synchronize()
        marks.setdefault("trained", time.perf_counter())
        marks.setdefault("counts", {k.name: k.launches for k in kernels})
        print(f"  {line}")

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit_cached(state, cache, None, seed=SEED, log=log, val_cache=val_cache)
    torch.cuda.synchronize()
    t_epoch = time.perf_counter() - t0
    t_train = marks["trained"] - t0
    counts = marks["counts"]
    missing = [n for n in ("fused_safuser_tail", "fused_tail_bwd", "flash_attention_dropout",
                           "attention_bwd") if counts[n] == 0]
    if missing:
        raise AssertionError(f"cache: the cached epoch never launched {missing}")

    # a window of cached steps in the 512 bucket: the host must not wait for
    # the card inside it (torch's sync debug mode raises on any call that
    # would), then the same window profiled
    step_fn = trainer.make_cached_train_fn(cache)
    rows = [idx for S, idx in plan if S == 512 and len(idx) == 8][:8]
    step_fn(state, cache.data, trainer._index_table(rows[:1]), 512, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        step_fn(state, cache.data, trainer._index_table(rows), 512, 0)
        t_enqueue = (time.perf_counter() - t0) / len(rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_window = (time.perf_counter() - t0) / len(rows)
    traced = rows[:4]
    for _ in range(5):   # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(3):   # a fresh trace can miss its first events: spin first
                torch.cuda._sleep(1000)
            step_fn(state, cache.data, trainer._index_table(traced), 512, 0)
            torch.cuda.synchronize()
        events = [e for e in card_events(prof) if "spin" not in e.key]
        if events:
            break
    if not events:
        raise AssertionError("cache: the profiler saw nothing on the card in 5 traces")
    busy = sum(e.self_device_time_total for e in events) / 1e3 / len(traced)
    launches = sum(e.count for e in events) / len(traced)
    copies = htod_copies(prof, os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                            "cached_step_trace.json"))
    table_bytes = 8 * len(traced) * len(traced[0])
    print(f"cache [{card}]: one epoch of fit_cached, {steps} steps (per bucket {buckets}), "
          f"{t_train:.2f} s of training ({1e3 * t_train / steps:.2f} ms a step), "
          f"{t_epoch:.2f} s with validation; 512-bucket window of {len(rows)} cached steps "
          f"{1e3 * t_window:.2f} ms a step, enqueued by the host in {1e3 * t_enqueue:.2f} ms a "
          f"step with no synchronisation (sync debug mode 'error'); card busy {busy:.3f} ms "
          f"in {launches:.0f} launches a step (a profiled window of {len(traced)}); the port's "
          f"kernels in the epoch { {k: c for k, c in counts.items() if c} }")
    print(f"cache [{card}]: a profiled window of cached 512-bucket steps, card time by event "
          f"a step:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / len(traced):.3f} ms "
              f"x{e.count / len(traced):g} {e.key[:90]}")
    print(f"cache [{card}]: host-to-device copies in the profiled window: {copies} bytes "
          f"(its index table: {table_bytes} bytes)")
    if max(copies, default=0) > table_bytes:
        raise AssertionError("cache: a cached step copied more than its index table to the card")

    # the host loader over the same views, whose epoch-0 batches are the
    # plan's: the same batches on both routes, in interleaved rounds
    loader = scale_loader(cfg, videos, SEED)
    it = iter(loader)
    host_state = trainer.init_state(steps, state_dict)
    trainer.train_step(host_state, next(it), 0)   # warm, and the loader's thread started
    times = {"cached": [], "host": []}
    pos = 1
    for r in range(SCALE_ROUNDS):
        for route in ("host", "cached") if r % 2 == 0 else ("cached", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "host":
                for _ in range(SCALE_HOST_STEPS):
                    trainer.train_step(host_state, next(it), 0)
            else:
                for S, idx in plan[pos: pos + SCALE_HOST_STEPS]:
                    step_fn(state, cache.data, trainer._index_table([idx]), S, 0)
            torch.cuda.synchronize()
            times[route].append(1e3 * (time.perf_counter() - t0) / SCALE_HOST_STEPS)
        pos += SCALE_HOST_STEPS
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"cache [{card}]: the same batches on both routes, {SCALE_ROUNDS} interleaved rounds "
          f"of {SCALE_HOST_STEPS} steps, ms a step: host loader (pinned collate on a thread, "
          f"H2D, step) {[round(t, 2) for t in times['host']]}, median {med['host']:.2f}; cached "
          f"{[round(t, 2) for t in times['cached']]}, median {med['cached']:.2f}; host / "
          f"cached {med['host'] / med['cached']:.2f}x")

    # 3 steps a dispatch == 3 single steps, cached and host
    three = [idx for S, idx in plan if S == 256 and len(idx) == 8][:3]
    states = [trainer.init_state(steps, state_dict) for _ in range(4)]
    for st in states:
        trainer._seed_dropout(st, SEED, 0)
    step_fn(states[0], cache.data, trainer._index_table(three), 256, 0)
    for idx in three:
        step_fn(states[1], cache.data, trainer._index_table([idx]), 256, 0)
    host = [dc.assemble(cache.data, torch.from_numpy(idx).to(trainer.device), 256, 1,
                        N_CLASS + 1, None) for idx in three]
    host = [{k: v.cpu() for k, v in b.items()} for b in host]
    trainer.make_multi_step()(states[2], _stack(host), 0)
    for b in host:
        trainer.train_step(states[3], b, 0)
    sd = [st.model.state_dict() for st in states]
    cached_diff, host_diff = unequal(sd[0], sd[1]), unequal(sd[2], sd[3])
    print(f"cache [{card}]: steps_per_dispatch=3 against 3 single steps, bit for bit: cached "
          f"{len(cached_diff)} of {len(sd[0])} tensors differ, host make_multi_step "
          f"{len(host_diff)}")
    if cached_diff or host_diff:
        raise AssertionError(f"cache: 3 steps a dispatch differ from 3 steps: {cached_diff} "
                             f"{host_diff}")

    # grad_accum=2 against the mean of the two microbatch gradients
    acfg = cfg.replace(train=dataclasses.replace(cfg.train, grad_accum=2))
    atrainer = Trainer(acfg, N_CLASS)
    accum, oracle = (atrainer.init_state(steps, state_dict) for _ in range(2))
    for st in (accum, oracle):
        atrainer._seed_dropout(st, SEED, 0)
    atrainer.make_accum_step()(accum, _stack(host[:2]), 0)
    oracle.model.train()
    grads = []
    for b in host[:2]:
        oracle.optimizer.zero_grad(set_to_none=True)
        atrainer._grad_core(oracle.model, atrainer.to_device(b))
        grads.append({n: p.grad.clone() for n, p in oracle.model.named_parameters()
                      if p.grad is not None})
    for n, p in oracle.model.named_parameters():
        p.grad = (grads[0][n] + grads[1][n]) / 2 if n in grads[0] else None
    oracle.apply_gradients()
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(accum.model.state_dict().values(),
                                oracle.model.state_dict().values()) if a.is_floating_point())
    bn = unequal({k: v for k, v in accum.model.state_dict().items() if "running" in k},
                 {k: v for k, v in oracle.model.state_dict().items() if "running" in k})
    print(f"cache [{card}]: grad_accum=2 against the mean microbatch gradient by hand: "
          f"parameters within {worst:.3e} of each tensor's largest entry (tol {ACCUM_TOL}), "
          f"BN statistics {len(bn)} tensors differ; step {accum.step}, updates {accum.updates}")
    if worst > ACCUM_TOL or bn or (accum.step, accum.updates) != (2, 1):
        raise AssertionError("cache: grad_accum=2 is not the mean microbatch gradient")
    return counts


# ---- fp32 K3, K4 and K5 with S queries against S keys: the encoder's self-attention ----

# (B, H, S, D) of the utkinects encoder (use_encoder=True: 8 heads of 16,
# batch 8) in its 256-2,000 buckets and a ragged S; the kernels line's rows
# at 512 and 2,000
SELF32_SHAPES = ((8, 8, 256, 16), (8, 8, 512, 16), (8, 8, 777, 16), (8, 8, 1024, 16),
                 (8, 8, 2000, 16))
SELF32_TIMED = (512, 2000)
FP32_MANY_QUERIES = 64   # csrc/attention_many_f32.cu: BQ, queries a block
SELF32_BWD_TOL = 1e-4   # K5 fp32 over each gradient's largest entry past 512: its sums run
                        # over up to 2,000 queries or keys (fp32 K7's bound over 3,100 keys)


def check_attention_fp32_self(gen, device):
    """fp32 K3, K4 and K5 at Lq = Lk = S (``SELF32_SHAPES``, the encoder's
    self-attention), on the many-query bodies: K3 and K4 on the forward
    (``csrc/attention_many_f32.cu``, 64 queries a block against every key),
    K5 on the backward (``csrc/attention_many_bwd_f32.cu``, two launches from
    what the forward kept), each against its plain version with random key
    lengths per row and one fully masked row, twice bit-equal (K5 at rate 0
    and 0.1, within ``K3_TOL`` to 512 and ``SELF32_BWD_TOL`` past it, of
    max(1, each gradient's largest entry), with the saved tensors given and
    not given bit-equal); the forward's output bit-equal with and without
    ``for_grad``; each call one launch on its counter (``flash_attention_many``,
    ``flash_attention_dropout_many``, ``attention_bwd_many``) at every
    shape; the launch shapes; at ``SELF32_TIMED`` each timed: the C launcher
    by events and the profiler's device time (K3 and K4 also as a training
    call runs them, keeping the statistics and bits; all three the cluster
    body they replace at this shape), the plain version, SDPA (forward, and
    forward + backward for K5) and the bound (at the 3xTF32 rate, with the
    fp32 rate's beside it), one call of each audited at 512 as its own
    launches, and K3's and K5's distance from an fp64 reference beside the
    cluster body's and the plain version's. Returns (worst (abs, rel) error
    per kernel, timing per kernel and S)."""
    import torch
    import torch.nn.functional as F

    from r3d_tpu_torch.ops import attention as att

    rate = 0.1
    worst = {"K3": (0.0, 0.0), "K4": (0.0, 0.0), "K5": (0.0, 0.0)}
    timing = {"K3": {}, "K4": {}, "K5": {}}
    stream = torch.cuda.current_stream().cuda_stream
    for B, H, S, D in SELF32_SHAPES:
        scale = 1.0 / math.sqrt(D)
        q, k, v, bias = attention_inputs(B, H, S, S, D, gen, device, all_masked_row=True)
        g = torch.randn(q.shape, generator=gen).to(device)
        seed = 5000 + S
        label = f"B={B} H={H} Lq=Lk={S} D={D}"
        for name, kernel, fn, plain in (
                ("K3", att.KERNEL_MANY, lambda: att.flash_attention(q, k, v, bias, scale),
                 lambda: att.composed_attention(q, k, v, bias, scale)),
                ("K4", att.DROPOUT_KERNEL_MANY,
                 lambda: att.flash_attention_dropout(q, k, v, bias, seed, scale, rate),
                 lambda: att.composed_attention_dropout(q, k, v, bias, seed, scale, rate))):
            before = kernel.launches
            got = fn()
            launched = kernel.launches - before
            err = errs([got], [plain()])
            print(f"{name} fp32 {label}: max|kernel - plain| = {err[0]:.3e} (tol {K3_TOL}), "
                  f"{launched} launch on {kernel.name}")
            if not (err[0] <= K3_TOL and torch.isfinite(got).all()):
                raise AssertionError(f"{name} fp32 disagrees with its plain version at {label}")
            if launched != 1:
                raise AssertionError(f"{name} fp32 at {label}: {launched} launches on "
                                     f"{kernel.name}, not 1")
            if not torch.equal(got, fn()):
                raise AssertionError(f"{name} fp32 is not deterministic at {label}")
            worst[name] = worse(worst[name], err)
        tol = K3_TOL if S <= 512 else SELF32_BWD_TOL
        for r_ in (0.0, rate):
            def forward(for_grad, r_=r_):
                if r_ > 0.0:
                    return att._attention_fwd_dropout(q, k, v, bias, seed, scale, r_, for_grad)
                return att._attention_fwd(q, k, v, bias, scale, for_grad)

            out, saved = forward(True)
            if not torch.equal(out, forward(False)[0]):
                raise AssertionError(f"fp32 forward at {label}, rate={r_}: the output of a "
                                     "training call differs from a call without gradients")
            before = att.BWD_KERNEL_MANY.launches
            got = att.attention_bwd(q, k, v, bias, seed, scale, r_, g, need_dbias=True,
                                    saved=saved)
            launched = att.BWD_KERNEL_MANY.launches - before
            err = errs(got, att.composed_attention_bwd(q, k, v, bias, seed, scale, r_, g))
            print(f"K5 fp32 {label} rate={r_}: over dq, dk, dv, dbias max|kernel - plain| = "
                  f"{err[0]:.3e}, over each one's max(1, max|plain|) {err[1]:.3e} (tol {tol}), "
                  f"{launched} launch on {att.BWD_KERNEL_MANY.name}")
            if not (err[1] <= tol and all(torch.isfinite(t).all() for t in got)):
                raise AssertionError(f"K5 fp32 disagrees at {label}, rate={r_}")
            if launched != 1:
                raise AssertionError(f"K5 fp32 at {label}: {launched} launches on "
                                     f"{att.BWD_KERNEL_MANY.name}, not 1")
            worst["K5"] = worse(worst["K5"], err)
            again = att.attention_bwd(q, k, v, bias, seed, scale, r_, g, need_dbias=True,
                                      saved=saved)
            unsaved = att.attention_bwd(q, k, v, bias, seed, scale, r_, g, need_dbias=True)
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(got, again, unsaved)):
                raise AssertionError(f"K5 fp32 is not deterministic at {label}, rate={r_} "
                                     "(again, or with its forward run anew)")
            del got, again, unsaved, out, saved
        split = att.fp32_split_keys(S)
        print(f"  fp32 K3/K4 at {label}: {-(-S // FP32_MANY_QUERIES)} query blocks of "
              f"{FP32_MANY_QUERIES} x {B * H} (batch, head), each walking {-(-S // 64)} key "
              f"tiles; K5: {-(-S // FP32_MANY_QUERIES)} query blocks walking the key tiles, "
              f"then {-(-S // 64)} key blocks of 64 walking {-(-S // 64)} query tiles, each "
              f"x {B * H}")
        torch.cuda.empty_cache()
        if S not in SELF32_TIMED:
            continue
        iters = 10 if S > 1024 else 30
        mask = bias == 0
        out_t = torch.empty_like(q)   # what the timed launches write
        stats_t = torch.empty((2, B * H, S), device=device)
        bits_t = torch.empty(att.keep_bits_shape(B, H, S, S), dtype=torch.int32, device=device)
        shape = f"{label} fp32"
        fwd_bound = attention_bound_ms(B, H, S, S, D, H100_TF32X3_FLOPS)
        fwd_bound_fp32 = attention_bound_ms(B, H, S, S, D)[0]
        bwd_bound = attention_bwd_bound_ms(B, H, S, S, D, H100_TF32X3_FLOPS)
        bwd_bound_fp32 = attention_bwd_bound_ms(B, H, S, S, D)[0]
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out_t.data_ptr())
        drop = (seed, att.dropout_threshold(rate), 1.0 / (1.0 - rate))
        launch = raw_launcher(att.KERNEL_MANY, *ptrs, None, B, H, S, S, D, scale, stream)
        train = raw_launcher(att.KERNEL_MANY, *ptrs, stats_t.data_ptr(), B, H, S, S, D, scale,
                             stream)
        cluster = raw_launcher(att.KERNEL, *ptrs, B, H, S, S, D, split, scale, stream)
        timing["K3"][S] = {
            "shape": shape, "ms": time_ms(launch, iters=iters),
            "device_ms": device_ms(launch, "attention_fwd_many_f32_kernel<16, false, false"),
            "train_ms": time_ms(train, iters=iters),
            "train_device_ms": device_ms(train, "attention_fwd_many_f32_kernel<16, false, true"),
            "cluster_ms": time_ms(cluster, iters=iters),
            "cluster_device_ms": device_ms(cluster, "attention_fwd_cluster_kernel<16, false"),
            "plain_ms": time_ms(lambda: att.composed_attention(q, k, v, bias, scale), iters=3),
            **library_times(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                   scale=scale), iters=iters),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "bound_fp32_ms": fwd_bound_fp32}
        launch = raw_launcher(att.DROPOUT_KERNEL_MANY, *ptrs, None, None, B, H, S, S, D, scale,
                              *drop, stream)
        train = raw_launcher(att.DROPOUT_KERNEL_MANY, *ptrs, stats_t.data_ptr(),
                             bits_t.data_ptr(), B, H, S, S, D, scale, *drop, stream)
        cluster = raw_launcher(att.DROPOUT_KERNEL, *ptrs, B, H, S, S, D, split, scale, *drop,
                               stream)
        timing["K4"][S] = {
            "shape": shape + f" p={rate}", "ms": time_ms(launch, iters=iters),
            "device_ms": device_ms(launch, "attention_fwd_many_f32_kernel<16, true, false"),
            "train_ms": time_ms(train, iters=iters),
            "train_device_ms": device_ms(train, "attention_fwd_many_f32_kernel<16, true, true"),
            "cluster_ms": time_ms(cluster, iters=iters),
            "cluster_device_ms": device_ms(cluster, "attention_fwd_cluster_kernel<16, true"),
            "plain_ms": time_ms(lambda: att.composed_attention_dropout(
                q, k, v, bias, seed, scale, rate), iters=3),
            **library_times(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=rate, scale=scale), iters=iters),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "bound_fp32_ms": fwd_bound_fp32}
        _, (stats, _, bits) = att._attention_fwd_dropout(q, k, v, bias, seed, scale, rate,
                                                         for_grad=True)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B * H, S), device=device)
        grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None)
        launch = raw_launcher(att.BWD_KERNEL_MANY, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              bias.data_ptr(), g.data_ptr(), stats.data_ptr(), bits.data_ptr(),
                              delta.data_ptr(), *grads, B, H, S, S, D, scale, 1, drop[2], stream)
        cluster = raw_launcher(att.BWD_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               bias.data_ptr(), g.data_ptr(), *grads, B, H, S, S, D, split, scale,
                               1, *drop, stream)
        k5_ms = time_ms(launch, iters=iters)
        k5_device = device_ms(launch, BWD_MANY_F32)
        k5_dq_device = device_ms(launch, BWD_MANY_F32[0])
        k5_cluster_ms = time_ms(cluster, iters=iters)
        k5_cluster_device = device_ms(cluster, "attention_bwd_cluster_kernel<16")
        if S == 512:   # one wrapper call each: its own launches, nothing else
            own_launches_per_call(lambda: att.flash_attention(q, k, v, bias, scale),
                                  ("attention_fwd_many_f32_kernel",), 1, f"K3 fp32 {label}")
            own_launches_per_call(
                lambda: att.flash_attention_dropout(q, k, v, bias, seed, scale, rate),
                ("attention_fwd_many_f32_kernel",), 1, f"K4 fp32 {label}")
            own_launches_per_call(lambda: att.attention_bwd(q, k, v, bias, seed, scale, rate, g,
                                                            saved=(stats, None, bits)),
                                  BWD_MANY_F32, 2, f"K5 fp32 {label}")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def library_bwd():
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate,
                                               scale=scale)
            torch.autograd.grad(o, leaves, g)

        timing["K5"][S] = {
            "shape": shape + f" p={rate}", "ms": k5_ms, "device_ms": k5_device,
            "dq_launch_device_ms": k5_dq_device, "cluster_ms": k5_cluster_ms,
            "cluster_device_ms": k5_cluster_device,
            "plain_ms": time_ms(lambda: att.composed_attention_bwd(
                q, k, v, bias, seed, scale, rate, g, False), iters=3),
            **library_times(library_bwd, iters=iters),
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "bound_fp32_ms": bwd_bound_fp32}
        del leaves
        # the distance from an fp64 reference of K3's output and of K5's dq,
        # dk, dv (over each one's max(1, max|reference|)): the kernel, the
        # cluster body it replaces, the plain version
        ref = attention_fp64(q, k, v, bias, scale)
        raw_launcher(att.KERNEL, *ptrs, B, H, S, S, D, split, scale, stream)()
        timing["K3"][S].update({
            "err_vs_fp64": errs_fp64([att.flash_attention(q, k, v, bias, scale)], [ref]),
            "cluster_err_vs_fp64": errs_fp64([out_t], [ref]),
            "plain_err_vs_fp64": errs_fp64([att.composed_attention(q, k, v, bias, scale)],
                                           [ref])})
        del ref
        ref = attention_fp64(q, k, v, bias, scale, seed, rate, g)
        cluster()
        timing["K5"][S].update({
            "err_vs_fp64": errs_fp64(att.attention_bwd(q, k, v, bias, seed, scale, rate, g)[:3],
                                     ref),
            "cluster_err_vs_fp64": errs_fp64((dq, dk, dv), ref),
            "plain_err_vs_fp64": errs_fp64(att.composed_attention_bwd(
                q, k, v, bias, seed, scale, rate, g, False)[:3], ref)})
        del ref, stats, bits, out_t, stats_t, bits_t
        for name in ("K3", "K4", "K5"):
            t = timing[name][S]
            extra = (f" (the cluster body at this shape {t['cluster_ms']:.4f} / "
                     f"{fmt_ms(t['cluster_device_ms'])}; bound at the fp32 rate "
                     f"{t['bound_fp32_ms']:.4f})")
            if "train_ms" in t:
                extra += (f"; as a training call runs it (the statistics"
                          f"{' and keep bits' if name == 'K4' else ''} kept) {t['train_ms']:.4f}"
                          f" / {fmt_ms(t['train_device_ms'])}")
            if "dq_launch_device_ms" in t:
                extra += f"; its dq launch {fmt_ms(t['dq_launch_device_ms'])} on the device"
            if "err_vs_fp64" in t:
                extra += (f"; max|kernel - fp64 reference| over max(1, max|reference|) "
                          f"{t['err_vs_fp64']:.3e}, cluster body {t['cluster_err_vs_fp64']:.3e}, "
                          f"plain version {t['plain_err_vs_fp64']:.3e}")
            print(f"{name} fp32 {t['shape']}: kernel {t['ms']:.4f} ms by events, "
                  f"{fmt_ms(t['device_ms'])} on the device; plain {t['plain_ms']:.3f}; SDPA "
                  f"{t['library_ms']:.4f} / {fmt_ms(t['library_device_ms'])}"
                  f"{' (forward + backward)' if name == 'K5' else ''}; bound "
                  f"{t['bound_ms']:.4f} ({t['bound_by']}){extra}")
        del dq, dk, dv, delta
        torch.cuda.empty_cache()
    return worst, timing


def fp32_threshold_ab(gen, device, B=8, H=8, Lk=256, D=16):
    """Which fp32 bodies an Lq takes (``FP32_MANY_QUERY_MIN``): the cluster
    bodies and the many-query bodies, K3, K4 (p = 0.1; the many-query body
    as a training call runs it, keeping the statistics and keep bits) and K5
    (p = 0.1, from those), launched by hand on the same inputs at Lk = 256,
    Lq = 8-256, device time each, and a training step's forward + backward
    on each side. Returns Lq -> (K3 cluster, K3 many, K4 cluster, K4 many,
    K5 cluster, K5 many) in ms."""
    import torch

    from r3d_tpu_torch.ops import attention as att

    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    drop = (77, att.dropout_threshold(0.1), 1.0 / 0.9)
    readings = {}
    for Lq in (8, 16, 17, 18, 19, 20, 32, 33, 64, 128, 256):
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device)
        g = torch.randn(q.shape, generator=gen).to(device)
        # the many-query forward's statistics and bits at any Lq (the wrapper
        # routes fewer than FP32_MANY_QUERY_MIN queries to the cluster body)
        _, (stats, _, bits) = att._many_fwd_f32(q, k, v, bias, scale, True, drop)
        o = torch.empty_like(q)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B * H, Lq), device=device)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), o.data_ptr())
        grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None)
        split = att.fp32_split_keys(Lk)
        calls = (
            (raw_launcher(att.KERNEL, *ptrs, B, H, Lq, Lk, D, split, scale, stream),
             "attention_fwd_cluster_kernel"),
            (raw_launcher(att.KERNEL_MANY, *ptrs, None, B, H, Lq, Lk, D, scale, stream),
             "attention_fwd_many_f32_kernel"),
            (raw_launcher(att.DROPOUT_KERNEL, *ptrs, B, H, Lq, Lk, D, split, scale, *drop,
                          stream), "attention_fwd_cluster_kernel"),
            (raw_launcher(att.DROPOUT_KERNEL_MANY, *ptrs, stats.data_ptr(), bits.data_ptr(), B, H,
                          Lq, Lk, D, scale, *drop, stream), "attention_fwd_many_f32_kernel"),
            (raw_launcher(att.BWD_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), g.data_ptr(), *grads, B, H, Lq, Lk, D, split, scale,
                          1, *drop, stream), "attention_bwd_cluster_kernel"),
            (raw_launcher(att.BWD_KERNEL_MANY, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), g.data_ptr(), stats.data_ptr(), bits.data_ptr(),
                          delta.data_ptr(), *grads, B, H, Lq, Lk, D, scale, 1, drop[2], stream),
             BWD_MANY_F32))
        readings[Lq] = t = [device_ms(fn, name) for fn, name in calls]
        pair = lambda a, b: (fmt_ms(t[a] + t[b]) if t[a] is not None and t[b] is not None
                             else "not measured")
        print(f"threshold A/B fp32 B={B} H={H} Lq={Lq} Lk={Lk} D={D} (FP32_MANY_QUERY_MIN "
              f"{att.FP32_MANY_QUERY_MIN}): K3 cluster {fmt_ms(t[0])} / many-query "
              f"{fmt_ms(t[1])} ms, K4 cluster {fmt_ms(t[2])} / many-query (keeping the "
              f"statistics and bits) {fmt_ms(t[3])} ms, K5 cluster {fmt_ms(t[4])} / many-query "
              f"{fmt_ms(t[5])} ms on the device; a training step's K4 + K5 cluster "
              f"{pair(2, 4)} / many-query {pair(3, 5)} ms")
    return readings


def bf16_steps_off(got, want):
    """(largest |got - want| in bf16 steps of want's largest entry, the
    share of entries that differ), in fp32."""
    diff = (got.float() - want.float()).abs()
    big = float(want.float().abs().max())
    return float(diff.max()) / (2.0 ** -7 * max(big, 1e-30)), float((diff > 0).float().mean())


def fuser_bf16_bound_ms(N, C=128, Ch=512, with_blend=True, backward=False):
    """bf16 K1: bf16 streams in and out once, the fp32 parameters (and
    blend vectors) once, the three products at the bf16 tensor-core rate.
    bf16 K2: bf16 r, d, g in and dr, dd out, the fp32 parameters in and
    their gradients out, its products fp32-accurate as JAX computes them
    (3xTF32, as fp32 K2)."""
    n_params = C * C + 2 * C * Ch + Ch + 8 * C
    if backward:
        return _bound(2 * 5 * N * C + 4 * 2 * n_params, 6 * N * (2 * C * C + 4 * C * Ch),
                      H100_TF32X3_FLOPS)
    n_bytes = 2 * 3 * N * C + 4 * (n_params + (7 * C if with_blend else 0))
    return _bound(n_bytes, N * 2 * (2 * C * C + 4 * C * Ch), H100_BF16_FLOPS)


def check_fuser_bf16_kernels(gen, device):
    """The bf16 instantiations of K1 (both routes, the outer residual off and
    on) and K2 (off and on) against their plain versions in bf16 (bf16
    streams, fp32 parameters) at N = 1, 16, the utkinects buckets' N = 8 x
    256, 512, 1,024 and 2,000 rows and a ragged N; each
    call twice bit-equal; each timed at 8 x 512 (events around the C
    launcher, the profiler's device time of all of a call's launches)
    beside its plain version and its bound. Returns {counter name: (worst
    (max|kernel - plain|, bf16 steps off, share of entries off for K1 or
    the parameter gradients' relative error for K2), timing)}."""
    import torch

    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    stream = torch.cuda.current_stream().cuda_stream
    worst = {}
    timing = {}

    def note(name, err):
        old = worst.get(name, (0.0, 0.0, 0.0))
        worst[name] = tuple(max(a, b) for a, b in zip(old, err))

    for N in (1, 16) + K1_ROWS + (8 * 256 + 5,):
        r, d, blend, params = fuser_inputs(N, gen, device)
        r, d = r.bfloat16(), d.bfloat16()
        g = torch.randn(N, 128, generator=gen).to(device).bfloat16()
        for outer in (False, True):
            calls = {
                fk.KERNEL_BF16.name: (
                    lambda: fk.fused_bn_blend_tail(r, d, blend, params, outer),
                    lambda: fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params, outer)),
                (fk.TAIL_KERNEL_BF16_OUTER if outer else fk.TAIL_KERNEL_BF16).name: (
                    lambda: fk.fused_safuser_tail(r, d, params, outer),
                    lambda: fk.composed_tail(r, d, params, outer)),
            }
            for name, (fn, plain) in calls.items():
                got = fn()
                steps, share = bf16_steps_off(got, plain())
                print(f"{name} N={N} outer_residual={outer}: {steps:.2f} bf16 steps of the "
                      f"largest entry at most, {100 * share:.3f} % of the entries off (tol "
                      f"{BF16_STEPS} steps, {100 * BF16_SHARE:.0f} %)")
                if not (got.dtype == torch.bfloat16 and steps <= BF16_STEPS
                        and share <= BF16_SHARE and torch.isfinite(got.float()).all()):
                    raise AssertionError(f"{name} disagrees with its plain version at N={N}")
                if not torch.equal(got, fn()):
                    raise AssertionError(f"{name} is not deterministic at N={N}")
                note(name, (errs([got], [plain()])[0], steps, share))
            name = (fkb.KERNEL_BF16_OUTER if outer else fkb.KERNEL_BF16).name
            got = fkb.fused_tail_bwd(r, d, g, params, outer)
            want = fkb.composed_tail_bwd(r, d, g, params, outer)
            steps = max(bf16_steps_off(a, b)[0] for a, b in zip(got[:2], want[:2]))
            ea, er = errs(got[2], want[2])
            again = fkb.fused_tail_bwd(r, d, g, params, outer)
            same = all(torch.equal(a, b) for a, b in zip((got[0], got[1], *got[2]),
                                                          (again[0], again[1], *again[2])))
            print(f"{name} N={N}: dr, dd {steps:.2f} bf16 steps off at most (tol 1); 12 fp32 "
                  f"gradients max|kernel - plain| {ea:.3e}, relative {er:.3e} (tol {K2_TOL}); "
                  f"two calls bit-equal: {same}")
            if not (steps <= 1.0 and er <= K2_TOL and same and got[0].dtype == torch.bfloat16):
                raise AssertionError(f"{name} disagrees or is not deterministic at N={N}")
            note(name, (max(ea, errs(got[:2], want[:2])[0]), steps, er))
        if N != 8 * 512:
            continue
        out = torch.empty_like(r)
        ptrs = [t.data_ptr() for t in params]
        launches = {
            fk.KERNEL_BF16.name: (raw_launcher(
                fk.KERNEL_BF16, r.data_ptr(), d.data_ptr(), *(t.data_ptr() for t in blend),
                *ptrs, out.data_ptr(), N, 128, 512, 0, stream),
                lambda: fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params),
                fuser_bf16_bound_ms(N)),
        }
        for outer, k in ((0, fk.TAIL_KERNEL_BF16), (1, fk.TAIL_KERNEL_BF16_OUTER)):
            launches[k.name] = (
                raw_launcher(k, r.data_ptr(), d.data_ptr(), *ptrs, out.data_ptr(), N, 128, 512,
                             outer, stream),
                lambda outer=outer: fk.composed_tail(r, d, params, bool(outer)),
                fuser_bf16_bound_ms(N, with_blend=False))
        plan = fkb.bwd_plan(N, 512, torch.cuda.get_device_properties(device).multi_processor_count)
        dr, dd = torch.empty_like(r), torch.empty_like(d)
        scratch = torch.empty(fkb.scratch_floats(128, 512, plan), device=device)
        flat = torch.empty(fkb.grad_layout(128, 512)[1], device=device)
        for outer, k in ((0, fkb.KERNEL_BF16), (1, fkb.KERNEL_BF16_OUTER)):
            launches[k.name] = (
                raw_launcher(k, r.data_ptr(), d.data_ptr(), g.data_ptr(), *ptrs, dr.data_ptr(),
                             dd.data_ptr(), scratch.data_ptr(), flat.data_ptr(), N, 128, 512,
                             plan.tile_rows, plan.split_rows, outer, stream),
                lambda outer=outer: fkb.composed_tail_bwd(r, d, g, params, bool(outer)),
                fuser_bf16_bound_ms(N, backward=True))
        for name, (launch, plain, (bound, bound_by)) in launches.items():
            backward = "bwd" in name
            t = {"shape": f"N={N} C=128 Ch=512 bf16" + (" outer_residual" if "outer" in name
                                                          else ""),
                 "ms": time_ms(launch, iters=20 if backward else 50),
                 "device_ms": device_ms(launch, None if backward else "fuser_tail_bf16_kernel"),
                 "plain_ms": time_ms(plain, iters=20), "library_ms": None,
                 "library_device_ms": None, "bound_ms": bound, "bound_by": bound_by}
            print(f"{name} N={N}: {t['ms']:.4f} ms by events, {fmt_ms(t['device_ms'])} on the "
                  f"device{' (every launch of a call)' if backward else ''}, plain "
                  f"{t['plain_ms']:.4f}, bound {bound:.4f} ({bound_by})")
            timing[name] = t
    return {name: (worst[name], timing[name]) for name in timing}


def time_outer_residual(gen, device, N=8 * 512):
    """K1's no-blend route and K2 with the outer residual on (the
    ``futr_fusion_grad`` tail) at N rows: the C launchers by events and the
    profiler's device time beside the plain versions and the bounds, as
    ``check_fuser_kernel`` and ``check_fuser_bwd_kernel`` time them with it
    off. Returns (K1 timing, K2 timing)."""
    import torch

    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    stream = torch.cuda.current_stream().cuda_stream
    r, d, _, params = fuser_inputs(N, gen, device)
    g = torch.randn(N, 128, generator=gen).to(device)
    out = torch.empty_like(r)
    launch = raw_launcher(fk.TAIL_KERNEL, r.data_ptr(), d.data_ptr(),
                          *(t.data_ptr() for t in params), out.data_ptr(), N, 128, 512, 1,
                          stream)
    bound, bound_by = fuser_bound_ms(N, with_blend=False)
    t1 = {"shape": f"N={N} C=128 Ch=512 outer_residual", "ms": time_ms(launch),
          "device_ms": device_ms(launch, "fuser_tail_tf32_kernel<false"),
          "plain_ms": time_ms(lambda: fk.composed_tail(r, d, params, True)),
          "library_ms": None, "library_device_ms": None, "bound_ms": bound,
          "bound_by": bound_by}
    plan = fkb.bwd_plan(N, 512, torch.cuda.get_device_properties(device).multi_processor_count)
    dr, dd = torch.empty_like(r), torch.empty_like(d)
    scratch = torch.empty(fkb.scratch_floats(128, 512, plan), device=device)
    flat = torch.empty(fkb.grad_layout(128, 512)[1], device=device)
    launch = raw_launcher(fkb.KERNEL, r.data_ptr(), d.data_ptr(), g.data_ptr(),
                          *(t.data_ptr() for t in params), dr.data_ptr(), dd.data_ptr(),
                          scratch.data_ptr(), flat.data_ptr(), N, 128, 512, plan.tile_rows,
                          plan.split_rows, 1, stream)
    bound, bound_by = fuser_bwd_bound_ms(N)
    t2 = {"shape": f"N={N} C=128 Ch=512 outer_residual", "ms": time_ms(launch, iters=20),
          "device_ms": device_ms(launch, None),
          "plain_ms": time_ms(lambda: fkb.composed_tail_bwd(r, d, g, params, True), iters=20),
          "library_ms": None, "library_device_ms": None, "bound_ms": bound,
          "bound_by": bound_by}
    for name, t in (("K1 no-blend", t1), ("K2", t2)):
        print(f"{name} with the outer residual, N={N}: {t['ms']:.4f} ms by events, "
              f"{fmt_ms(t['device_ms'])} on the device, plain {t['plain_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']})")
    return t1, t2


@contextlib.contextmanager
def k2_outer_residual_flipped():
    """Within: K2 runs with its outer-residual flag flipped (the forward
    keeps its own), a planted fault for a control reading only."""
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    bwd = fkb.fused_tail_bwd
    fkb.fused_tail_bwd = lambda r, d, g, params, outer=False: bwd(r, d, g, params, not outer)
    try:
        yield
    finally:
        fkb.fused_tail_bwd = bwd


@contextlib.contextmanager
def plain_routes():
    """Within: the attention modules and the fuser tail take their plain
    routes on the card (``plain_attention_route``, and the fuser module's
    two tail wrappers swapped for the plain tail), for a comparison only."""
    from r3d_tpu_torch.models import fuser
    from r3d_tpu_torch.ops import fuser_kernel as fk

    orig = fuser.fused_safuser_tail, fuser.fused_bn_blend_tail
    fuser.fused_safuser_tail = lambda r, d, p, outer=False: fk.composed_tail(r, d, p, outer)
    fuser.fused_bn_blend_tail = lambda r, d, blend, p, outer=False: fk.composed_tail(
        *fk.composed_bn_blend(r, d, blend), p, outer)
    try:
        with plain_attention_route():
            yield
    finally:
        fuser.fused_safuser_tail, fuser.fused_bn_blend_tail = orig


# ---- the fuser ablations through the CLI: futr_fusion_grad, _vary, _nox and afft ----

ABLATIONS = ("futr_fusion_grad", "futr_fusion_vary", "futr_fusion_nox", "afft")
# The grad variant's sticky step, kernels vs the plain routes on the card:
# utkinects runs its two embeds in bf16, so a gradient into an embed's
# weight moves by a bf16 step (2**-8 of an entry) wherever the fp32
# cotangent at the embed's output rounds to the neighbouring bf16 value:
# 6.1e-4 of the model's largest gradient entry in
# depth_embed.depth_projection.weight on an H100 (4.1e-4 in a CPU
# rehearsal of the two routes). Over the model's largest gradient entry:
ABLATION_GRAD_TOL = 2e-3
# the fuser's own parameters (fp32 from the embeds' outputs on), each
# entry over the fuser's largest gradient entry
FUSER_GRAD_TOL = 1e-4
ABLATION_DIR = "build/ablation_phase"   # under the checkout (git-ignored), removed after


def phase_launches(snapshots, label):
    """The launches of each phase of a 2-epoch ``cli_train`` run (the
    differences between its snapshots), each printed under ``label``."""
    phases = ["epoch 0 train", "epoch 0 validation", "epoch 1 train", "epoch 1 validation"]
    per_phase, prev = {}, {}
    for phase, snap in zip(phases, snapshots):
        per_phase[phase] = {k: snap[k] - prev.get(k, 0) for k in snap
                            if snap[k] - prev.get(k, 0)}
        prev = snap
        print(f"{label}: launches in {phase}: {per_phase[phase]}")
    return per_phase


def sweep_card_and_cpu(predict, kernels):
    """The utkinects CLI's sweep ``predict`` (argv) on the card and with
    ``--cpu`` (its output silenced), the launch counts set to 0 before each:
    {"cuda" or "cpu": (results, the ``SweepRecorder`` chunks, wall s, the
    counts)}."""
    import io

    import torch

    from r3d_tpu_torch.cli.opts import run_from_argv

    runs = {}
    for run, extra in (("cuda", []), ("cpu", ["--cpu"])):
        for k in kernels:
            k.launches = 0
        quiet = io.StringIO() if run != "cuda" else sys.stdout
        with SweepRecorder(kernels) as rec, contextlib.redirect_stdout(quiet):
            t0 = time.perf_counter()
            results = run_from_argv("utkinects", predict + extra, log=lambda *a: None)
            if run != "cpu":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        runs[run] = (results, rec.chunks, dt, {k.name: k.launches for k in kernels})
    return runs


def ablation_cli(kernels, card, model, root):
    """``--config utkinects --model <model>`` at full width through the CLI
    over the dataset at ``root`` (the CLI phase's 5 + 2 videos): every
    launch count set to 0, ``train`` one seed for 2 epochs on the device
    cache, where each training phase (epoch 0, train mode; epoch 1, sticky)
    must launch K1's no-blend route and K2, both with the outer residual on
    for ``futr_fusion_grad`` and off for the others (their ``*_OUTER``
    counters or the plain ones), never K1's blend route nor the other flag,
    and, but for ``afft`` (no transformer), the attention kernels (K4 and
    K5 in epoch 0, K3 and K5 sticky); each validation K1's
    no-blend route; the checkpoint's files; the 9-ratio sweep from the best
    checkpoint and the cached val videos on the card (K1's no-blend route in
    every chunk, K3 in the 256/512 chunks but for ``afft``) and with
    ``--cpu``, held window by window (logits and durations within
    ``E2E_TOL``, a MoC difference only where a decode flip is explained).
    For ``futr_fusion_grad`` also: its training ranking on the card swaps
    channels [0, 32), in train mode and sticky; one sticky 512-bucket step
    through the kernels against the plain routes, and a control: the same
    step with K2's outer-residual flag flipped must fail both its bounds.
    Returns (train counts, sweep counts). Also the parts of a 512-bucket
    step in epoch 0 and sticky (``train_breakdown``)."""
    import os
    import shutil

    import torch

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args
    from r3d_tpu_torch.cli.run import save_path
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.models import build_model
    from r3d_tpu_torch.models.fuser import mark_sticky
    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), ABLATION_DIR, model)
    shutil.rmtree(work, ignore_errors=True)
    try:
        argv = ["--config", "utkinects", "--model", model, "--data_root", root,
                "--model_save_path", os.path.join(work, "save"), "--seed", "1"]
        config = config_from_args(build_parser("utkinects").parse_args(argv))
        outer = model == "futr_fusion_grad"
        lines, snapshots, train_counts, t_train = cli_train(argv, kernels)
        if not any(line.startswith(CLI_ROUTE) and "views" in line for line in lines):
            raise AssertionError(f"{model} train: the cached route's line is missing: {lines}")
        per_phase = phase_launches(snapshots, model)
        tail, bwd = ((fk.TAIL_KERNEL_OUTER, fkb.KERNEL_OUTER) if outer
                     else (fk.TAIL_KERNEL, fkb.KERNEL))
        tail, bwd = tail.name, bwd.name
        never = {fk.KERNEL.name, fk.TAIL_KERNEL.name, fk.TAIL_KERNEL_OUTER.name,
                 fkb.KERNEL.name, fkb.KERNEL_OUTER.name} - {tail, bwd}
        attn = model != "afft"
        want = {"epoch 0 train": (tail, bwd) + (("flash_attention_dropout", "attention_bwd")
                                                if attn else ()),
                "epoch 1 train": (tail, bwd) + (("flash_attention", "attention_bwd")
                                                if attn else ()),
                "epoch 0 validation": (tail,) + (("flash_attention",) if attn else ()),
                "epoch 1 validation": (tail,) + (("flash_attention",) if attn else ())}
        for phase, names in want.items():
            missing = [n for n in names if per_phase.get(phase, {}).get(n, 0) == 0]
            if missing:
                raise AssertionError(f"{model} train: {phase} never launched {missing}")
        wrong = {k: c for p in per_phase.values() for k, c in p.items()
                 if k in never or (not attn and "attention" in k)
                 or (k == "flash_attention_dropout" and p is per_phase["epoch 1 train"])}
        if wrong:
            raise AssertionError(f"{model} train: launched what its route must not: {wrong}")
        losses = [float(x) for line in lines
                  for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{model} train: a loss is missing or not finite: {lines}")
        ckpt_dir = save_path(config)
        names = sorted(os.listdir(ckpt_dir))
        for need in ("seed_1_best", "seed_1_last", "seed_1_metrics.jsonl"):
            if need not in names:
                raise AssertionError(f"{model} train: no {need} in {ckpt_dir}")
        gate = [line for line in lines if line.startswith("Best model saved")]
        print(f"{model} [{card}]: train 2 epochs on the cached route in {t_train:.2f} s, the "
              f"gate opened {len(gate)} times; {names}")

        predict = argv + ["--predict", "--results_save_path", os.path.join(work, "results")]
        runs = sweep_card_and_cpu(predict, kernels)
        results, chunks, t_sweep, sweep_counts = runs["cuda"]
        cpu_res, cpu_chunks = runs["cpu"][0], runs["cpu"][1]
        per_bucket = {}
        for c in chunks:
            per_bucket[c["S"]] = per_bucket.get(c["S"], 0) + 1
            n = c["launches"]
            if n[tail] == 0 or any(n[k] for k in never):
                raise AssertionError(f"{model} sweep: a {c['S']}-bucket chunk launched {n}")
            if (n["flash_attention"] > 0) != (attn and c["S"] in (256, 512)):
                raise AssertionError(f"{model} sweep: a {c['S']}-bucket chunk launched "
                                     f"{n['flash_attention']} K3")
        if [c["windows"] for c in cpu_chunks] != [c["windows"] for c in chunks]:
            raise AssertionError(f"{model} sweep: the card and the CPU swept different windows")
        err = max(float(np.abs(a[key] - b[key]).max())
                  for a, b in zip(chunks, cpu_chunks) for key in ("action", "duration"))
        for c in chunks:
            if not (np.isfinite(c["action"]).all() and np.isfinite(c["duration"]).all()):
                raise AssertionError(f"{model} sweep: non-finite outputs in a {c['S']} chunk")
        flipped, unexplained = decode_flips(chunks, cpu_chunks, err)
        diff = [(k, abs(results[o][k] - cpu_res[o][k])) for o in cpu_res for k in cpu_res[o]]
        moc_diff = max(d for k, d in diff if k.startswith("obs"))
        n_windows = sum(len(c["windows"]) for c in chunks)
        print(f"{model} sweep on the card [{card}]:\n{moc_table(results)}")
        print(f"{model} sweep [{card}]: {n_windows} windows, per bucket "
              f"{dict(sorted(per_bucket.items()))}; launches "
              f"{ {k: c for k, c in sweep_counts.items() if c} }; card vs CPU max|logit or "
              f"duration diff| {err:.3e} (tol {E2E_TOL}), max|MoC diff| {moc_diff:.3e}, "
              f"{flipped} of {n_windows} windows decoded differently ({unexplained} not "
              f"explained); MoC tables equal: {results == cpu_res}; wall {t_sweep:.2f} s on the "
              f"card, {runs['cpu'][2]:.2f} s on the CPU")
        if err > E2E_TOL:
            raise AssertionError(f"{model} sweep: the card's outputs disagree with the CPU's")
        if unexplained or (moc_diff > 0 and flipped == 0):
            raise AssertionError(f"{model} sweep: the card's MoC table differs from the CPU's "
                                 "where the measured errors cannot explain it")

        final = final_model(ckpt_dir, "seed_1_last")
        sources = build_source(config.data, "train_split.txt")
        train = build_loader(sources, config.data, config.train.batch_size,
                             config.model.n_query, seed=1, pin_memory=True)
        batch = one_batch(train, 256, rows=config.train.batch_size)
        if batch["features"].shape[1] != 512:
            raise AssertionError(f"{model}: the held batch fell in bucket "
                                 f"{batch['features'].shape[1]}, not 512")
        train_breakdown(config, final, train, n_class=sources.n_class, label=f" ({model})",
                        make_batch=lambda: one_batch(train, 256, rows=config.train.batch_size))
        if outer:
            m = build_model(config.model, sources.n_class, config.data.depth_shape).cuda()
            m.load_state_dict(final)
            with torch.no_grad():
                rgb = m.embed(batch["features"].cuda())
                dep = m.depth_embed(batch["depth_features"].cuda())
            first = torch.arange(rgb.shape[-1], device=rgb.device) < rgb.shape[-1] // 4
            m.train()
            train_masks = m.fuser.masks(rgb, dep)
            m.eval()
            mark_sticky(m)
            sticky_masks = m.fuser.masks(rgb, dep)
            m.eval()
            eval_masks = m.fuser.masks(rgb, dep)
            ok = all(torch.equal(x, first) for x in train_masks + sticky_masks)
            print(f"{model} [{card}]: the training ranking swaps channels "
                  f"{torch.nonzero(train_masks[0]).flatten().tolist()} of rgb and "
                  f"{torch.nonzero(train_masks[1]).flatten().tolist()} of depth, the sticky "
                  f"step the same: {ok}; the eval ranking (by activation) swaps "
                  f"{int((eval_masks[0] & first).sum())} of [0, 32) in rgb")
            if not ok:
                raise AssertionError(f"{model}: the training ranking on the card is not "
                                     "channels [0, 32)")
            plain = fp32_step_kernels_vs_plain(config, final, batch, sources.n_class, kernels)
            with k2_outer_residual_flipped():   # a control: a K2 fault must fail the bounds
                control = fp32_step(config, final, batch, sources.n_class, kernels)
            _, (model_gap, worst, fuser_gap, f_worst) = grad_gaps(control[2], plain[2])
            print(f"{model} control, K2's outer-residual flag flipped: max|grad diff| over the "
                  f"model's largest entry {model_gap:.3e} in {worst} (tol {ABLATION_GRAD_TOL}), "
                  f"the fuser's over its largest {fuser_gap:.3e} in {f_worst} (tol "
                  f"{FUSER_GRAD_TOL})")
            if not (model_gap > ABLATION_GRAD_TOL and fuser_gap > FUSER_GRAD_TOL):
                raise AssertionError(f"{model}: the step's bounds pass a K2 fault")
        return train_counts, sweep_counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def ablations(kernels, card):
    """Write the CLI phase's dataset once, then ``ablation_cli`` for each of
    ``ABLATIONS``. Returns model -> its (train, sweep) counts."""
    import os
    import shutil

    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), ABLATION_DIR, "data")
    shutil.rmtree(data_dir, ignore_errors=True)
    try:
        root = write_utkinect_dataset(data_dir, 5, 2, CLI_TRAIN_LENGTHS,
                                      val_lengths=CLI_VAL_LENGTHS)
        return {model: ablation_cli(kernels, card, model, root) for model in ABLATIONS}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


# ---- the fusion models in bf16: utkinects with --compute_dtype bfloat16 ----

BF16_DIR = "build/bf16_phase"   # under the checkout (git-ignored), removed after the phase
BF16_FLAGS = ["--compute_dtype", "bfloat16", "--opt_mu_dtype", "bfloat16"]


def bf16_fuser_counters():
    """The five bf16 K1/K2 counters, then the five fp32 ones."""
    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    return ([fk.KERNEL_BF16, fk.TAIL_KERNEL_BF16, fk.TAIL_KERNEL_BF16_OUTER, fkb.KERNEL_BF16,
             fkb.KERNEL_BF16_OUTER],
            [fk.KERNEL, fk.TAIL_KERNEL, fk.TAIL_KERNEL_OUTER, fkb.KERNEL, fkb.KERNEL_OUTER])


def utkinects_bf16(kernels, card):
    """``--config utkinects --compute_dtype bfloat16 --opt_mu_dtype
    bfloat16`` at full width through the CLI on the CLI phase's dataset
    (written anew): every launch count set to 0, ``train`` one seed for 2
    epochs on the device cache, where epoch 0 (dropout on) must launch bf16
    K1's no-blend route and bf16 K2, the sticky epoch 1 and both
    validations bf16 K1's blend route, and nothing may launch an fp32 K1/K2;
    the checkpoint's AdamW first moment must be bf16; the 9-ratio sweep from
    the best checkpoint on the card (bf16 K1's blend route in every chunk)
    and with ``--cpu``, held window by window (logits and durations within
    ``E2E_TOL``, a MoC difference only where a decode flip is explained);
    then one bf16 training step of each fuser ablation (dropout off: K1's
    no-blend route and K2, the outer residual on for ``futr_fusion_grad``)
    from a seeded init on a 512-bucket batch, on the card and on the CPU
    (``train_step_on_card_and_cpu``: the loss, each gradient within
    ``BF16_GRAD_TOL`` of its largest entry, the gradient's cosine at least
    ``BF16_COS_MIN``); and the parts of a 512-bucket step of the trained
    bf16 model beside the same step in fp32 (``train_breakdown``). Returns
    (the phase's counts: training, sweep and the four steps; the sweep's
    counts; the steps' counts)."""
    import dataclasses
    import os
    import shutil

    import torch

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args
    from r3d_tpu_torch.cli.run import save_path
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.models import build_model, init_weights

    bf16_k, fp32_k = bf16_fuser_counters()
    blend, tail, tail_outer, bwd, bwd_outer = (k.name for k in bf16_k)
    never = {k.name for k in fp32_k}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), BF16_DIR)
    shutil.rmtree(work, ignore_errors=True)
    try:
        root = write_utkinect_dataset(os.path.join(work, "data"), 5, 2, CLI_TRAIN_LENGTHS,
                                      val_lengths=CLI_VAL_LENGTHS)
        argv = ["--config", "utkinects", "--data_root", root, "--model_save_path",
                os.path.join(work, "save"), "--seed", "1", *BF16_FLAGS]
        config = config_from_args(build_parser("utkinects").parse_args(argv))
        if (config.model.compute_dtype, config.train.opt_mu_dtype) != ("bfloat16", "bfloat16"):
            raise AssertionError(f"bf16: the flags did not reach the config: {config}")
        lines, snapshots, train_counts, t_train = cli_train(argv, kernels)
        if not any(line.startswith(CLI_ROUTE) and "views" in line for line in lines):
            raise AssertionError(f"bf16 train: the cached route's line is missing: {lines}")
        per_phase = phase_launches(snapshots, "bf16 utkinects")
        k3, k4, k5 = "flash_attention_bf16", "flash_attention_dropout_bf16", "attention_bwd_bf16"
        want = {"epoch 0 train": (tail, bwd, k4, k5), "epoch 0 validation": (blend, k3),
                "epoch 1 train": (blend, k3, k5), "epoch 1 validation": (blend, k3)}
        never |= {"flash_attention", "flash_attention_dropout", "attention_bwd"}   # fp32 K3-K5
        for phase, names in want.items():
            missing = [n for n in names if per_phase.get(phase, {}).get(n, 0) == 0]
            if missing:
                raise AssertionError(f"bf16 train: {phase} never launched {missing}")
        wrong = {k: c for k, c in train_counts.items() if c and k in never}
        if wrong:
            raise AssertionError(f"bf16 train: launched fp32 kernels: {wrong}")
        losses = [float(x) for line in lines
                  for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"bf16 train: a loss is missing or not finite: {lines}")
        ckpt_dir = save_path(config)
        blob = torch.load(os.path.join(ckpt_dir, "seed_1_last", "state.pt"), map_location="cpu",
                          weights_only=True)
        mu_dtypes = {str(st["exp_avg"].dtype) for st in blob["optimizer"]["state"].values()}
        nu_dtypes = {str(st["exp_avg_sq"].dtype) for st in blob["optimizer"]["state"].values()}
        gate = [line for line in lines if line.startswith("Best model saved")]
        print(f"bf16 utkinects [{card}]: train 2 epochs on the cached route in {t_train:.2f} s, "
              f"the gate opened {len(gate)} times; {sorted(os.listdir(ckpt_dir))}; AdamW's "
              f"first moment {mu_dtypes}, second {nu_dtypes}")
        if mu_dtypes != {"torch.bfloat16"} or nu_dtypes != {"torch.float32"}:
            raise AssertionError("bf16 train: the checkpoint's AdamW moments are not bf16/fp32")

        predict = argv + ["--predict", "--results_save_path", os.path.join(work, "results")]
        runs = sweep_card_and_cpu(predict, kernels)
        results, chunks, t_sweep, sweep_counts = runs["cuda"]
        cpu_res, cpu_chunks = runs["cpu"][0], runs["cpu"][1]
        for c in chunks:
            n = c["launches"]
            if n[blend] == 0 or any(n[k] for k in never):
                raise AssertionError(f"bf16 sweep: a {c['S']}-bucket chunk launched {n}")
            if not (np.isfinite(c["action"]).all() and np.isfinite(c["duration"]).all()):
                raise AssertionError(f"bf16 sweep: non-finite outputs in a {c['S']} chunk")
        if [c["windows"] for c in cpu_chunks] != [c["windows"] for c in chunks]:
            raise AssertionError("bf16 sweep: the card and the CPU swept different windows")
        err = max(float(np.abs(a[key] - b[key]).max())
                  for a, b in zip(chunks, cpu_chunks) for key in ("action", "duration"))
        flipped, unexplained = decode_flips(chunks, cpu_chunks, err)
        moc_diff = max(abs(results[o][k] - cpu_res[o][k]) for o in cpu_res for k in cpu_res[o]
                       if k.startswith("obs"))
        other = {f"{o} {k}": abs(results[o][k] - cpu_res[o][k]) for o in cpu_res
                 for k in cpu_res[o] if not k.startswith("obs") and results[o][k] != cpu_res[o][k]}
        n_windows = sum(len(c["windows"]) for c in chunks)
        print(f"bf16 utkinects sweep on the card [{card}]:\n{moc_table(results)}")
        print(f"bf16 utkinects sweep [{card}]: {n_windows} windows in {len(chunks)} chunks; "
              f"launches { {k: c for k, c in sweep_counts.items() if c} }; card vs CPU "
              f"max|logit or duration diff| {err:.3e} (tol {E2E_TOL}), max|MoC diff| "
              f"{moc_diff:.3e}, {flipped} of {n_windows} windows decoded differently "
              f"({unexplained} not explained); MoC entries equal: {moc_diff == 0}, the other "
              f"entries that differ: {other or 'none'}; wall "
              f"{t_sweep:.2f} s on the card, {runs['cpu'][2]:.2f} s on the CPU")
        if err > E2E_TOL:
            raise AssertionError("bf16 sweep: the card's outputs disagree with the CPU's")
        if unexplained or (moc_diff > 0 and flipped == 0):
            raise AssertionError("bf16 sweep: the card's MoC table differs from the CPU's "
                                 "where the measured errors cannot explain it")

        sources = build_source(config.data, "train_split.txt")
        loader = build_loader(sources, config.data, config.train.batch_size,
                              config.model.n_query, seed=1, pin_memory=True)
        batch = one_batch(loader, 256, rows=config.train.batch_size)
        step_counts = {}
        for model in ABLATIONS:
            cfg = config.replace(model=dataclasses.replace(config.model, model=model))
            state_dict = init_weights(build_model(cfg.model, sources.n_class,
                                                  cfg.data.depth_shape),
                                      torch.Generator().manual_seed(SEED)).state_dict()
            for k in kernels:
                k.launches = 0
            loss_gap = train_step_on_card_and_cpu(cfg, state_dict, batch, sources.n_class,
                                                  grad_tol=BF16_GRAD_TOL, cos_min=BF16_COS_MIN)
            step_counts[model] = {k.name: k.launches for k in kernels}
            used = (tail_outer, bwd_outer) if model == "futr_fusion_grad" else (tail, bwd)
            print(f"bf16 {model} step [{card}]: batch {tuple(batch['features'].shape[:2])}, "
                  f"|loss card - CPU| {loss_gap:.3e}; launches "
                  f"{ {k: c for k, c in step_counts[model].items() if c} }")
            if any(step_counts[model][n] == 0 for n in used) or any(
                    step_counts[model][n] for n in never | {blend}):
                raise AssertionError(f"bf16 {model} step: launched {step_counts[model]}, "
                                     f"wanted {used}")
        # where a 512-bucket step's time goes, bf16 beside fp32 on the same batch and weights
        final = final_model(ckpt_dir, "seed_1_last")
        same_batch = lambda: one_batch(loader, 256, rows=config.train.batch_size)
        fp32 = config.replace(
            model=dataclasses.replace(config.model, compute_dtype="float32"),
            train=dataclasses.replace(config.train, opt_mu_dtype=None))
        for cfg, label in ((config, " (utkinects bf16)"), (fp32, " (utkinects fp32)")):
            train_breakdown(cfg, final, loader, n_class=sources.n_class, label=label,
                            make_batch=same_batch)
        names = train_counts.keys()
        total = {k: train_counts[k] + sweep_counts[k] + sum(c[k] for c in step_counts.values())
                 for k in names}
        steps = {k: sum(c[k] for c in step_counts.values()) for k in names}
        return total, sweep_counts, steps
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- fuser_depth = 2: the composed fuser stack ----

def fuser_depth_2(kernels, loaders):
    """``futr_fusion_bn`` with ``fuser_depth=2`` at the utkinects widths from
    the seeded init: one serving chunk of the 256 bucket and one dropout-off
    train step (the 512 bucket), each on the card against the CPU, with
    every launch count set to 0: the fuser runs its composed blocks (no K1,
    no K2, as in JAX), the attention its kernels. Returns the counts."""
    import dataclasses

    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights
    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb
    from r3d_tpu_torch.serving import InferenceSession

    base = get_config("utkinects")
    cfg = base.replace(model=dataclasses.replace(base.model, fuser_depth=2))
    model = init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                         torch.Generator().manual_seed(SEED))
    if not hasattr(model.fuser.safuser, "block1"):
        raise AssertionError("fuser_depth=2 built one block")
    state_dict = model.state_dict()
    for k in kernels:
        k.launches = 0
    session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8)
    compare_with_cpu(session, cfg, state_dict, np.random.default_rng(SEED + 2))
    del session
    train_step_on_card_and_cpu(cfg, state_dict, one_batch(loaders[1], 256))
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels}
    print(f"fuser_depth=2: launches of a serving chunk and a train step "
          f"{ {k: c for k, c in counts.items() if c} }")
    fuser_launches = sum(counts[k.name] for k in (fk.KERNEL, fk.TAIL_KERNEL, fk.TAIL_KERNEL_OUTER,
                                                   fkb.KERNEL, fkb.KERNEL_OUTER))
    if fuser_launches or not counts["flash_attention"] or not counts["attention_bwd"]:
        raise AssertionError(f"fuser_depth=2 took the wrong routes: {counts}")
    return counts


# ---- the FUTR encoder (use_encoder=True): fp32 K3-K5 with S queries ----

ENCODER_SERVE = {256: (200, 256, 131, 240), 512: (400, 512, 300, 480),
                 1024: (900, 700, 1000, 600), 2000: (1900, 1500, 2000, 1200)}
ENCODER_FUTR_BUCKET = 3100   # the futr step's bucket: 50salads' largest
# The futr step with the encoder against its fp32 witness, per tensor: the
# kernels' route (fp32 scores, the weights rounded once) against the bf16
# plain route (bf16 scores). Two encoder layers ahead of the decoder spread
# the per-tensor ratio of their errors. On an NVIDIA H100 80GB HBM3 at
# 700.00 W at seeds 0, 1, 2 (``encoder_witness_readings``): the kernels
# 2.676 (heads.fc.bias), 1.431, 1.426; the many-query algorithm in PyTorch
# (the kernels' rounding points: unnormalised bf16 weights, bf16 ds) 2.676
# (heads.fc.bias), 1.505, 1.484; the plain version (normalised weights, an
# fp32 backward) 1.666, 1.723, 1.571. The kernels read what their algorithm
# reads, where the decoder-only step read 1.961 against
# ``PROPOSED_WITNESS_FACTOR``. Every other bound of
# ``step_kernels_vs_plain`` is the decoder-only step's.
ENCODER_WITNESS_FACTOR = 3.0
ENCODER_WITNESS_SEEDS = (SEED, SEED + 1, SEED + 2)
# the encoder fit's videos: 16 of 2,100-3,400 frames, whose windows at 0.15
# (315-510 rows) fill two batches of 8 in the 512 bucket and at 0.5
# (1,050-1,700) two in the 2000 bucket
# 8 videos: one batch of 8 a bucket and epoch (16 made two; their synthetic
# depth frames, made on the host, were most of the phase's time)
ENCODER_FIT = dict(n_videos=8, vid_len_range=(2100, 3400), obs=(0.15, 0.5))


@contextlib.contextmanager
def composed_attention_route():
    """Within: the attention modules' kernel branch runs the plain versions
    on the card under autograd (``composed_attention`` and
    ``composed_attention_dropout``: fp32 scores, the weights rounded once,
    no kernel), for a reading only."""
    from r3d_tpu_torch.models import layers
    from r3d_tpu_torch.ops import attention as att

    orig = layers.flash_attention, layers.flash_attention_dropout
    layers.flash_attention = att.composed_attention
    layers.flash_attention_dropout = att.composed_attention_dropout
    try:
        yield
    finally:
        layers.flash_attention, layers.flash_attention_dropout = orig


def many_query_emulated(q, k, v, bias, scale):
    """bf16 K3 and K5 (rate 0) as the many-query kernels compute them, in
    plain PyTorch under autograd: the keys in tiles of ``MANY_KEY_TILE``,
    an fp32 online softmax, the weights rounded to bf16 unnormalised
    against the running max, out = acc / l in bf16; the backward from (m,
    1 / l) and out in fp32 from the weights' bf16 high and low parts, ds
    rounded to bf16 before the dq and dk products, dv from the weights'
    high and low parts (``tests/test_torch_attention_rows.py``, which holds
    the same algorithm to the plain versions and to JAX)."""
    import torch

    from r3d_tpu_torch.ops import attention as att

    tile = att.MANY_KEY_TILE
    bf = lambda x: x.to(torch.bfloat16).float()

    class Emulated(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            s = att._scores(q, k, bias, scale)
            m = torch.full(s.shape[:-1], -torch.inf, device=q.device)
            l = torch.zeros(s.shape[:-1], device=q.device)
            acc, acc_lo = torch.zeros(q.shape, device=q.device), torch.zeros(q.shape,
                                                                             device=q.device)
            for j0 in range(0, s.shape[-1], tile):
                st, vt = s[..., j0:j0 + tile], v[:, :, j0:j0 + tile].float()
                m_new = torch.maximum(m, st.amax(-1))
                corr = torch.where(m_new == -torch.inf, torch.ones_like(m), torch.exp(m - m_new))
                pt = torch.where(st == -torch.inf, 0.0, torch.exp(st - m_new[..., None]))
                l = l * corr + pt.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", bf(pt), vt)
                acc_lo = acc_lo * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                                 bf(pt - bf(pt)), vt)
                m = m_new
            inv_l = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
            ctx.save_for_backward(q, k, v, m, inv_l, (acc + acc_lo) * inv_l[..., None])
            return (acc * inv_l[..., None]).to(q.dtype)

        @staticmethod
        def backward(ctx, g):
            q, k, v, m, inv_l, out32 = ctx.saved_tensors
            s = att._scores(q, k, bias, scale)
            qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
            w = torch.where(s == -torch.inf, 0.0, torch.exp(s - m[..., None]) * inv_l[..., None])
            ds = w * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - (gf * out32).sum(-1)[..., None])
            dq = torch.einsum("bhqk,bhkd->bhqd", bf(ds), kf) * scale
            dk = torch.einsum("bhqk,bhqd->bhkd", bf(ds), qf) * scale
            dv = (torch.einsum("bhqk,bhqd->bhkd", bf(w), gf)
                  + torch.einsum("bhqk,bhqd->bhkd", bf(w - bf(w)), gf))
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

    return Emulated.apply(q, k, v)


@contextlib.contextmanager
def emulated_attention_route():
    """Within: the attention modules' kernel branch runs
    ``many_query_emulated`` for the calls the many-query bodies take and
    the kernels for the rest, for a reading only."""
    from r3d_tpu_torch.models import layers
    from r3d_tpu_torch.ops import attention as att

    orig = layers.flash_attention
    layers.flash_attention = lambda q, k, v, bias, scale: (
        many_query_emulated(q, k, v, bias, scale) if att.many_query(q)
        else orig(q, k, v, bias, scale))
    try:
        yield
    finally:
        layers.flash_attention = orig


def encoder_witness_readings(cfg, batch, kernels):
    """The futr step with the encoder (``cfg``, bf16, dropout off) from the
    initial weights of each of ``ENCODER_WITNESS_SEEDS``, against its fp32
    witness: the largest ratio over outputs and gradients of an error over
    the bf16 plain route's error, for the kernels' route, for the plain
    version (``composed_attention_route``: fp32 scores, the normalised
    weights rounded once, the backward in fp32) and for the many-query
    algorithm in plain PyTorch (``emulated_attention_route``: the kernels'
    rounding points). The kernels' ratio must be at most
    ``ENCODER_WITNESS_FACTOR`` at every seed. Returns seed -> route ->
    (ratio, where)."""
    import dataclasses

    import torch

    from r3d_tpu_torch.models import build_model, init_weights

    model = dataclasses.replace(cfg.model, dropout=0.0)
    cfg = cfg.replace(model=model)
    cfg32 = cfg.replace(model=dataclasses.replace(model, compute_dtype="float32",
                                                  embed_dtype=None))
    readings = {}
    for seed in ENCODER_WITNESS_SEEDS:
        state_dict = init_weights(build_model(model, SALADS_CLASSES),
                                  torch.Generator().manual_seed(seed)).state_dict()
        steps = {"kernels": bf16_step(cfg, state_dict, batch, SALADS_CLASSES, kernels)}
        for route, within in (("plain version", composed_attention_route),
                              ("emulation", emulated_attention_route)):
            with within():
                steps[route] = bf16_step(cfg, state_dict, batch, SALADS_CLASSES, kernels)
            if steps[route][3]:
                raise AssertionError(f"the {route}'s route launched {steps[route][3]}")
        with plain_attention_route():
            plain = bf16_step(cfg, state_dict, batch, SALADS_CLASSES, kernels)
            fp32 = bf16_step(cfg32, state_dict, batch, SALADS_CLASSES, kernels)
        readings[seed] = {}
        for route, step in steps.items():
            ratio = {k: a / max(b, 1e-30)
                     for k, (a, b) in witness_errors(step, plain, fp32).items()}
            far = max(ratio, key=ratio.get)
            readings[seed][route] = (ratio[far], far)
        print(f"futr with the encoder, bucket {batch['features'].shape[1]}, seed {seed}: "
              f"against fp32, over the bf16 plain route's error: " + ", ".join(
                  f"{route} {r:.3f} in {where}" for route, (r, where) in readings[seed].items())
              + f" (tol for the kernels {ENCODER_WITNESS_FACTOR})")
        if not readings[seed]["kernels"][0] <= ENCODER_WITNESS_FACTOR:
            raise AssertionError(f"futr with the encoder, seed {seed}: against fp32, the "
                                 "kernels' route is further off than the bf16 plain route")
    return readings


def encoder(kernels, loaders):
    """``futr_fusion_bn`` with ``use_encoder=True`` (two encoder layers) at
    the utkinects widths from the seeded init: requests through
    ``ServingQueue`` in the 256-2,000 buckets, every count set to 0, where
    each bucket must launch fp32 K3 with S queries against S keys (the
    encoder) and the 256/512 buckets also with 8 (the decoder); the card's
    logits against the CPU's in the 2000 bucket; ``fit`` of 2 epochs (the
    videos of ``ENCODER_FIT``, batches in the 512 and 2000 buckets), where
    epoch 0 must launch K4 and K5 at Lq = Lk and epoch 1 (sticky) K3 and K5
    at Lq = Lk; one dropout-off 512-bucket train step (of ``loaders``) on
    the card against the CPU; the parts of a 2000-bucket step in epoch 0
    and sticky (``train_breakdown``). Then ``futr`` at the 50salads widths
    in bf16 with the encoder: one dropout-off 3100-bucket train step through
    the kernels (the encoder's S queries on the many-query bodies) against
    the plain route (``step_kernels_vs_plain``), and the witness readings
    at three seeds (``encoder_witness_readings``). Returns the counts of the
    serving run, of the fit and of each serving bucket."""
    import dataclasses

    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights
    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.serving import InferenceSession

    base = get_config("utkinects")
    cfg = base.replace(model=dataclasses.replace(base.model, use_encoder=True))
    model = init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                         torch.Generator().manual_seed(SEED))
    layers = len(model.transformer.encoder.layers)
    state_dict = model.state_dict()
    session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8)
    rng = np.random.default_rng(SEED + 3)
    latencies, serving_counts, per_bucket = serve(session, kernels, cfg, rng, ENCODER_SERVE)
    for S, lat in latencies.items():
        print(f"encoder ({layers} layers) bucket {S}: {lat['requests']} requests, latency p50 "
              f"{lat['p50_ms']:.2f} ms, max {lat['max_ms']:.2f} ms; launches "
              f"{ {k: c for k, c in per_bucket[S].items() if c} }")
        if not per_bucket[S][att.KERNEL_MANY.name] or S <= 512 and not per_bucket[S][
                att.KERNEL.name]:
            raise AssertionError(f"encoder serving: bucket {S} launched {per_bucket[S]}")
    compare_with_cpu(session, cfg, state_dict, rng, lengths=ENCODER_SERVE[2000])
    del session
    want = {"epoch 0 train": (att.DROPOUT_KERNEL_MANY.name, att.BWD_KERNEL_MANY.name),
            "epoch 1 train": (att.KERNEL_MANY.name, att.BWD_KERNEL_MANY.name)}
    fit_loaders = train_loaders(cfg, **ENCODER_FIT)
    fit_counts = train(cfg, state_dict, kernels, fit_loaders, want)
    print(f"encoder fit: launches {fit_counts}")
    train_step_on_card_and_cpu(cfg, state_dict, one_batch(loaders[1], 256))
    train_breakdown(cfg, state_dict, fit_loaders[1], min_len=1024, label=" (encoder, 2000)")

    # futr (50salads widths, bf16) with the encoder: a 3100-bucket step
    s_base = get_config("50salads")
    s_cfg = s_base.replace(model=dataclasses.replace(s_base.model, use_encoder=True))
    s_model = init_weights(build_model(s_cfg.model, SALADS_CLASSES),
                           torch.Generator().manual_seed(SEED))
    s_loaders = salads_loaders(s_cfg)
    batch = one_batch(s_loaders[1], 1024)
    if batch["features"].shape[1] != ENCODER_FUTR_BUCKET:
        raise AssertionError(f"encoder: the futr batch fell in bucket "
                             f"{batch['features'].shape[1]}, not {ENCODER_FUTR_BUCKET}")
    step = step_kernels_vs_plain(s_cfg, s_model.state_dict(), batch, SALADS_CLASSES, kernels)
    many = {k.name: step["launches"].get(k.name, 0)
            for k in (att.KERNEL_BF16_MANY, att.DROPOUT_KERNEL_BF16_MANY,
                      att.BWD_KERNEL_BF16_MANY)}
    print(f"futr with the encoder, bf16, 3100 bucket: many-query launches {many}")
    if not many[att.KERNEL_BF16_MANY.name] or not many[att.BWD_KERNEL_BF16_MANY.name]:
        raise AssertionError(f"futr with the encoder: no S-query kernel launched: {many}")
    encoder_witness_readings(s_cfg, batch, kernels)
    return {"serving": serving_counts, "fit": fit_counts, "per_bucket": per_bucket}


# ---- A11.4: the baselines, the depth source, MoE, the gt embed, L3 generation ----

NTU_DIR = "build/ntu_phase"   # under the checkout (git-ignored), removed after the phase
NTU_CLASSES = 121             # NTU RGB+D: 120 actions + NONE
NTU_TRAIN, NTU_VAL = 5, 2     # videos of the written dataset
NTU_LENGTHS = (100, 300)      # NTU RGB+D clips: a few seconds at 30 fps
NTU_TOL = E2E_TOL             # outputs, card vs CPU: nturgbd embeds in bf16, as utkinects
BASELINES = ("rnn", "cnn", "tcn")
BASELINE_LOOPS = {"rnn": "unimodal", "tcn": "tcn"}   # the loops the JAX package pairs them with
DEPTH_MODEL = "futr_unsupervised_depth"
MOE = dict(moe_experts=4, moe_top_k=2)
BREAKFAST_CLASSES = 48        # Breakfast: 47 actions + NONE
GT_TOL = 1e-3                 # fp32 at the breakfast widths, card vs CPU
L3_TOL = 1e-3                 # L3 generation, fp32, card vs CPU
L3_S = 2000


def sticky_dropout_on_card(cfg, state_dict, batch, n_class):
    """One sticky train step on the card (``Trainer._train_mode`` at epoch
    1) from the given weights and batch, at the model's real fixed rates
    (ROADMAP C4): every ``FixedDropout`` must run in train mode, keep within
    3 sigma of 1 - rate of its nonzero inputs, scale the kept values by
    1 / (1 - rate), and its backward must pass the gradient through the
    forward's mask. Returns each module's keep rate (none for a model
    without fixed-rate dropouts, such as the gaze source)."""
    import torch

    from r3d_tpu_torch.models.layers import FixedDropout
    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, n_class)
    state = trainer.init_state(1, state_dict)
    trainer._seed_dropout(state, SEED, 0)
    names = {m: n for n, m in state.model.named_modules() if isinstance(m, FixedDropout)}
    if not names:
        return {}
    calls = []

    def hook(module, args, out):
        call = {"name": names[module], "rate": module.rate, "training": module.training,
                "x": args[0].detach(), "y": out.detach()}
        calls.append(call)
        if out is not args[0] and out.requires_grad:
            out.register_hook(lambda g: call.__setitem__("gy", g))
            args[0].register_hook(lambda g: call.__setitem__("gx", g))

    handles = [m.register_forward_hook(hook) for m in names]
    try:
        trainer.train_step(state, trainer._with_seg_ids(batch), 1)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    if not calls or state.model.training:
        raise AssertionError(f"{cfg.name}: the sticky step ran {len(calls)} fixed-rate dropouts "
                             f"with the module in train mode {state.model.training}")
    keep = {}
    for c in calls:
        live = c["x"] != 0
        kept = live & (c["y"] != 0)
        n_live = int(live.sum())
        rate = float(kept.sum()) / max(n_live, 1)
        sigma = math.sqrt(c["rate"] * (1 - c["rate"]) / max(n_live, 1))
        scale_err = float((c["y"][kept] - c["x"][kept] / (1 - c["rate"])).abs().max())
        grad_err = float((c["gx"][live] - (c["gy"] * kept / (1 - c["rate"]))[live]).abs().max())
        keep.setdefault(c["name"], []).append(rate)
        if not (c["training"] and abs(rate - (1 - c["rate"])) <= 3 * sigma and scale_err == 0
                and grad_err <= 1e-6 * max(float(c["gy"].abs().max()), 1e-30)):
            raise AssertionError(
                f"{cfg.name}: the sticky step's {c['name']} (rate {c['rate']}) ran in train mode "
                f"{c['training']}, kept {rate:.4f} of {n_live} (3 sigma {3 * sigma:.4f}), "
                f"scale error {scale_err:.3e}, backward off the forward's mask by {grad_err:.3e}")
    print(f"{cfg.name} sticky train step on the card, the fixed-rate dropouts in train mode: "
          + "; ".join(f"{n} kept " + ", ".join(f"{r:.4f}" for r in rs) for n, rs in keep.items())
          + " of their nonzero inputs (within 3 sigma of 1 - rate); the backward through the "
          "forward's mask")
    return keep


def baseline_cli(kernels, card, model, root):
    """``--config nturgbd --model <model>`` (``rnn``, ``cnn`` or ``tcn``)
    at full width (input 2,048, hidden 128, the config's buckets and bf16
    batches and embed) through the CLI over the NTU-layout dataset at
    ``root``: every launch count set to 0, ``train`` one seed for 2 epochs
    on the device cache (the config's loop, ``proposed_depth``: sticky from
    epoch 1), where no kernel of the port may launch (LSTM and convs run in
    cuDNN, as JAX ran them in XLA); the checkpoint's files; the 9-ratio
    sweep on the card and with ``--cpu``, held window by window (outputs
    within ``NTU_TOL``, a MoC difference only where a decode flip is
    explained; the TCN's slots decode without durations); one dropout-off
    train step on the card against the CPU; the parts of a step; then
    ``Trainer.fit`` of 2 epochs in the loop the JAX package pairs the model
    with (``unimodal`` for ``rnn``: not sticky; ``tcn`` for ``tcn``: sticky,
    its fixed-rate dropouts held by ``sticky_dropout_on_card``). Returns the
    launches of the whole phase."""
    import dataclasses
    import io
    import os
    import shutil

    import torch

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args, run_from_argv
    from r3d_tpu_torch.cli.run import save_path
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.models import baselines
    from r3d_tpu_torch.train.loop import Trainer

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), NTU_DIR, model)
    shutil.rmtree(work, ignore_errors=True)
    try:
        argv = ["--config", "nturgbd", "--model", model, "--data_root", root,
                "--model_save_path", os.path.join(work, "save"), "--seed", "1",
                "--warmup_epochs", "0"]
        config = config_from_args(build_parser("nturgbd").parse_args(argv))
        lines, _, train_counts, t_train = cli_train(argv, kernels)
        if not any(line.startswith(CLI_ROUTE) and "views" in line for line in lines):
            raise AssertionError(f"nturgbd {model} train: the cached route's line is missing")
        losses = [float(x) for line in lines
                  for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"nturgbd {model} train: a loss is missing or not finite")
        ckpt_dir = save_path(config)
        names = sorted(os.listdir(ckpt_dir))
        gate = [line for line in lines if line.startswith("Best model saved")]
        if "seed_1_last" not in names or bool(gate) != ("seed_1_best" in names):
            raise AssertionError(f"nturgbd {model} train: checkpoints {names}, gate {gate}")
        print(f"nturgbd {model} [{card}]: train 2 epochs on the cached route in {t_train:.2f} s, "
              f"losses {losses}; the gate opened {len(gate)} times; {names}")

        predict = argv + ["--predict", "--results_save_path", os.path.join(work, "results")]
        runs = {}
        for run, extra in (("cuda", []), ("cpu", ["--cpu"])):
            quiet = io.StringIO() if run != "cuda" else sys.stdout
            with SweepRecorder(kernels) as rec, contextlib.redirect_stdout(quiet):
                t0 = time.perf_counter()
                results = run_from_argv("nturgbd", predict + extra, log=lambda *a: None)
                if run != "cpu":
                    torch.cuda.synchronize()
                runs[run] = (results, rec.chunks, time.perf_counter() - t0)
        (results, chunks, t_sweep), (cpu_res, cpu_chunks, t_cpu) = runs["cuda"], runs["cpu"]
        if [c["windows"] for c in cpu_chunks] != [c["windows"] for c in chunks]:
            raise AssertionError(f"nturgbd {model} sweep: the card and the CPU swept different "
                                 "windows")
        keys = ("action",) if model == "tcn" else ("action", "duration")
        err = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(chunks, cpu_chunks)
                  for k in keys)
        if not all(np.isfinite(c[k]).all() for c in chunks for k in keys):
            raise AssertionError(f"nturgbd {model} sweep: non-finite outputs")
        flipped, unexplained = decode_flips(chunks, cpu_chunks, err, n_class=NTU_CLASSES)
        diff = [(k, abs(results[o][k] - cpu_res[o][k])) for o in cpu_res for k in cpu_res[o]]
        moc_diff = max(d for k, d in diff if k.startswith("obs"))
        per_bucket = {}
        for c in chunks:
            per_bucket[c["S"]] = per_bucket.get(c["S"], 0) + 1
        n_windows = sum(len(c["windows"]) for c in chunks)
        print(f"nturgbd {model} sweep on the card [{card}]:\n{moc_table(results)}")
        print(f"nturgbd {model} sweep [{card}]: {n_windows} windows, per bucket "
              f"{dict(sorted(per_bucket.items()))}; card vs CPU max|{' or '.join(keys)} diff| {err:.3e} (tol {NTU_TOL}), max|MoC diff| "
              f"{moc_diff:.3e}, {flipped} of {n_windows} windows decoded differently "
              f"({unexplained} not explained); MoC tables equal: {results == cpu_res}; wall "
              f"{t_sweep:.2f} s on the card, {t_cpu:.2f} s on the CPU")
        if err > NTU_TOL or unexplained or (moc_diff > 0 and flipped == 0):
            raise AssertionError(f"nturgbd {model} sweep: the card disagrees with the CPU")

        final = final_model(ckpt_dir, "seed_1_last")
        n_class = NTU_CLASSES
        sources = {s: build_source(config.data, f"{s}_split.txt") for s in ("train", "val")}
        train = build_loader(sources["train"], config.data, config.train.batch_size,
                             config.model.n_query, seed=1, pin_memory=True)
        batch = one_batch(train, 0, rows=config.train.batch_size)
        rate = baselines.TCN_DROPOUT
        baselines.TCN_DROPOUT = 0.0   # the card and the CPU draw different streams
        try:
            train_step_on_card_and_cpu(config, final, batch, n_class)
        finally:
            baselines.TCN_DROPOUT = rate
        train_breakdown(config, final, train, n_class=n_class, label=f" (nturgbd {model})",
                        make_batch=lambda: one_batch(train, 0, rows=config.train.batch_size))
        if model in BASELINE_LOOPS:
            loop = BASELINE_LOOPS[model]
            cfg = config.replace(train=dataclasses.replace(config.train, loop=loop, epochs=2))
            val = build_loader(sources["val"], config.data, config.train.batch_size,
                               config.model.n_query, mode="val", shuffle=False, pin_memory=True)
            trainer = Trainer(cfg, n_class)
            state = trainer.init_state(len(train), final)
            modes, fit_log = [], []
            step = trainer.train_step

            def recorded(st, b, epoch):
                out = step(st, b, epoch)
                modes.append(st.model.training)
                return out

            trainer.train_step = recorded
            t0 = time.perf_counter()
            trainer.fit(state, train, val, seed=1, log=fit_log.append)
            torch.cuda.synchronize()
            fit_losses = [float(x) for line in fit_log
                          for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
            half = len(modes) // 2
            want_modes = [True] * half + [loop != "tcn"] * half
            print(f"nturgbd {model} [{card}]: Trainer.fit of the {loop} loop, 2 epochs in "
                  f"{time.perf_counter() - t0:.2f} s, losses {fit_losses}, train mode by step "
                  f"{modes}, the gate opened at epochs {trainer.best_epochs}")
            if (modes != want_modes or len(fit_losses) != 4
                    or not all(math.isfinite(x) for x in fit_losses)):
                raise AssertionError(f"nturgbd {model}: the {loop} loop's fit went wrong")
            if loop == "tcn":
                sticky_dropout_on_card(cfg, final, batch, n_class)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in kernels}
        if any(counts.values()):
            raise AssertionError(f"nturgbd {model}: launched the port's kernels "
                                 f"{ {k: c for k, c in counts.items() if c} }")
        return dict(train_counts)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def ntu_baselines(kernels, card):
    """Write an NTU-layout dataset (``NTU_TRAIN`` + ``NTU_VAL`` videos of
    ``NTU_LENGTHS`` frames, 2,048-d features, 224x224 depth frames, 120
    actions), then ``baseline_cli`` for each of ``BASELINES``. Returns model
    -> its launches (all 0)."""
    import os
    import shutil

    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), NTU_DIR, "data")
    shutil.rmtree(data_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        root = write_utkinect_dataset(data_dir, NTU_TRAIN, NTU_VAL, NTU_LENGTHS,
                                      n_actions=NTU_CLASSES - 1, depth_shape=(224, 224),
                                      dataset_dir="nturgbd")
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                   for f in fs)
        print(f"nturgbd: dataset of {NTU_TRAIN} + {NTU_VAL} videos of {NTU_LENGTHS[0]}-"
              f"{NTU_LENGTHS[1]} frames, {size / 2**20:.0f} MiB written in "
              f"{time.perf_counter() - t0:.2f} s")
        return {model: baseline_cli(kernels, card, model, root) for model in BASELINES}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def salads_moe(kernels, card, k3b, k4b, k5b, k6, k7):
    """50salads' ``futr`` with MoE FFNs (``MOE``: 4 experts, top 2; hidden
    512, 8 heads, 2 decoder layers, 20 queries, bf16) at full width under
    ``R3D_CROSS_NATIVE=1`` (restored after), from the seeded init: requests
    in the 512 and 3100 buckets (K3 at 512, K6 at 3100); a 3100-bucket
    chunk on the card against the CPU (``SALADS_E2E_TOL``); ``fit`` of 2
    epochs (one 512- and one 3100-bucket batch of 8) where epoch 0 must
    launch K4, K5, K6 and K7 and epoch 1 K3, K5, K6 and K7; one dropout-off
    3100-bucket step through the kernels against the plain route with an
    fp32 witness (``step_kernels_vs_plain``); and the parts of that step beside the
    dense ``futr``'s, from the same seed, in the same call. Returns
    (serving counts, training counts)."""
    import dataclasses
    import os

    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights
    from r3d_tpu_torch.serving import InferenceSession

    before = os.environ.get("R3D_CROSS_NATIVE")
    os.environ["R3D_CROSS_NATIVE"] = "1"
    try:
        base = get_config("50salads")
        cfg = base.replace(model=dataclasses.replace(base.model, **MOE))
        sds = {}
        for c in (cfg, base):
            m = init_weights(build_model(c.model, SALADS_CLASSES),
                             torch.Generator().manual_seed(SEED))
            sds[c.model.moe_experts] = m.state_dict()
        state_dict = sds[MOE["moe_experts"]]
        n_params = sum(v.numel() for v in state_dict.values())
        print(f"50salads MoE: {MOE['moe_experts']} experts, top {MOE['moe_top_k']}, capacity "
              f"factor {cfg.model.moe_capacity_factor}, aux weight {cfg.model.moe_aux_weight}; "
              f"{n_params} parameters ({sum(v.numel() for v in sds[0].values())} dense); "
              f"hidden {cfg.model.hidden_dim}, {cfg.model.n_decoder_layers} decoder layers, "
              f"{cfg.model.n_query} queries, {cfg.model.compute_dtype}, R3D_CROSS_NATIVE=1")
        session = InferenceSession(cfg, state_dict, SALADS_CLASSES, max_batch=8)
        rng = np.random.default_rng(SEED + 5)
        groups = {S: SALADS_SERVE[S] for S in (512, 3100)}
        latencies, serving, per_bucket = serve(session, kernels, cfg, rng, groups)
        for S, lat in latencies.items():
            print(f"50salads MoE bucket {S}: {lat['requests']} requests through ServingQueue, "
                  f"latency p50 {lat['p50_ms']:.2f} ms, max {lat['max_ms']:.2f} ms; launches "
                  f"{ {k: c for k, c in per_bucket[S].items() if c} }")
        for S, route in ((512, k3b), (3100, k6)):
            if per_bucket[S][route.name] == 0:
                raise AssertionError(f"50salads MoE bucket {S} did not launch {route.name}")
        with MoERouting("50salads MoE, card vs CPU"):
            compare_with_cpu(session, cfg, state_dict, rng, n_class=SALADS_CLASSES,
                             lengths=(3100, 2000, 1500, 2800), tol=SALADS_E2E_TOL)
        del session
        loaders = salads_loaders(cfg)
        want = {"epoch 0 train": (k4b.name, k5b.name, k6.name, k7.name),
                "epoch 1 train": (k3b.name, k5b.name, k6.name, k7.name)}
        train_counts = train(cfg, state_dict, kernels, loaders, want, n_class=SALADS_CLASSES)
        batch = one_batch(loaders[1], 1024)
        if batch["features"].shape[1] != 3100:
            raise AssertionError(f"50salads MoE: the held batch fell in bucket "
                                 f"{batch['features'].shape[1]}, not 3100")
        with MoERouting("50salads MoE, the kernels' route vs the plain and fp32 routes"):
            step_kernels_vs_plain(cfg, state_dict, batch, SALADS_CLASSES, kernels)
        for c, label in ((cfg, "MoE"), (base, "dense")):
            train_breakdown(c, sds[c.model.moe_experts], loaders[1], 1024, SALADS_CLASSES,
                            f" (50salads {label}, 3100 bucket)",
                            make_batch=lambda: one_batch(loaders[1], 1024))
        torch.cuda.synchronize()
        return serving, train_counts
    finally:
        if before is None:
            os.environ.pop("R3D_CROSS_NATIVE", None)
        else:
            os.environ["R3D_CROSS_NATIVE"] = before


def gt_futr(kernels, card):
    """``futr`` with the gt-label embed (``input_type="gt"``) at the
    breakfast widths (hidden 128, 8 heads, 8 queries, fp32) from the seeded
    init, on [8, 512] label ids drawn from a seed with ragged rows: the eval
    forward on the card (K3) against the CPU, and one dropout-off train step
    (K3, K5) against the CPU, each within ``GT_TOL``. Returns the counts."""
    import dataclasses

    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights

    base = get_config("breakfast")
    cfg = base.replace(model=dataclasses.replace(base.model, input_type="gt"))
    n_class = BREAKFAST_CLASSES
    model = init_weights(build_model(cfg.model, n_class), torch.Generator().manual_seed(SEED))
    state_dict = model.state_dict()
    rng = np.random.default_rng(SEED + 6)
    B, S, Q = 8, 512, cfg.model.n_query
    lengths = np.array([512, 480, 400, 333, 300, 290, 270, 257])
    pad = np.arange(S)[None, :] >= lengths[:, None]
    past = rng.integers(0, n_class - 1, (B, S))
    past[pad] = n_class + 1
    feats = np.where(pad, n_class + 1, rng.integers(0, n_class + 2, (B, S)))
    target = rng.integers(0, n_class, (B, Q))
    batch = {"features": torch.from_numpy(feats), "past_label": torch.from_numpy(past),
             "trans_future_target": torch.from_numpy(target),
             "trans_future_dur": torch.from_numpy(rng.random((B, Q), dtype=np.float32))}
    for k in kernels:
        k.launches = 0
    mask = torch.from_numpy(pad)
    with torch.no_grad():
        want = model.eval()(batch["features"], mask)
        got = model.cuda()(batch["features"].cuda(), mask.cuda())
    torch.cuda.synchronize()
    fwd = {k.name: k.launches for k in kernels if k.launches}
    err = max(float((got[k].cpu() - want[k]).abs().max()) for k in want)
    print(f"gt futr [{card}] (breakfast widths, fp32, input_type gt, ids of {n_class + 2} "
          f"rows): eval forward of [{B}, {S}] ids card vs CPU max|output diff| {err:.3e} (tol "
          f"{GT_TOL}); launches {fwd}")
    if err > GT_TOL or not fwd.get("flash_attention"):
        raise AssertionError("gt futr: the card's forward disagrees with the CPU's or took "
                             "the plain route")
    del model, got
    train_step_on_card_and_cpu(cfg, state_dict, batch, n_class, loss_tol=GT_TOL,
                               grad_tol=GT_TOL)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels}
    if not counts["attention_bwd"]:
        raise AssertionError("gt futr: the train step did not launch K5")
    return counts


def l3_generation(kernels, card):
    """``FUTRTransformer(query_pos=None)`` (L3 query generation) at the
    breakfast widths (hidden 128, 8 heads of 16, 8 queries, one decoder
    layer) from the seeded init: one forward of [4, ``L3_S``] ragged rows on
    the card against the CPU (within ``L3_TOL``), where ``l3_attention`` (S
    queries against S keys) must launch fp32 K3 on its many-query counter.
    Returns the counts."""
    import torch

    from r3d_tpu_torch.models import init_weights
    from r3d_tpu_torch.models.transformer import FUTRTransformer

    C, H, B = 128, 8, 4
    m = init_weights(FUTRTransformer(C, H, 1, 4 * C, l3_queries=True, n_query=8,
                                     max_pos_len=L3_S), torch.Generator().manual_seed(SEED))
    m.eval()
    g = torch.Generator().manual_seed(SEED + 7)
    src = torch.randn(B, L3_S, C, generator=g)
    pos = 0.1 * torch.randn(B, L3_S, C, generator=g)
    mask = torch.arange(L3_S)[None, :] >= torch.tensor([2000, 1700, 1100, 600])[:, None]
    with torch.no_grad():
        want = m(src, pos, None, mask)[1]
        for k in kernels:
            k.launches = 0
        m.cuda()
        t0 = time.perf_counter()
        got = m(src.cuda(), pos.cuda(), None, mask.cuda())[1]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    err = float((got.cpu() - want).abs().max())
    print(f"L3 query generation [{card}]: [{B}, {L3_S}] -> {tuple(got.shape)} queries' decoder "
          f"output, card vs CPU max|diff| {err:.3e} (tol {L3_TOL}), {1e3 * dt:.1f} ms (first "
          f"call); launches { {k: c for k, c in counts.items() if c} }")
    if err > L3_TOL or not counts["flash_attention_many"]:
        raise AssertionError("L3 generation: the card disagrees with the CPU or l3_attention "
                             "took the plain route")
    return counts


# ---- serving deployment (A13): int8 weights, uint8 depth, export ----

DEPLOY_DIR = "build/deploy_phase"   # under the checkout (git-ignored), removed after the phase
DEPLOY_SERVE = {256: (200, 256, 131, 240), 512: (400, 512, 300, 480), 1024: (900, 1024),
                2000: (1900, 2000)}
DEPLOY_KINDS = {"float": {}, "int8": {"quantize": "int8"}, "uint8": {"input_dtype": "uint8"},
                "int8+uint8": {"quantize": "int8", "input_dtype": "uint8"}}
DEPLOY_EXPORTED = ("float", "int8+uint8")
SALADS_DEPLOY = {256: (200,), 512: (400,), 1024: (900,), 3100: (3000,)}
# A quantized session's logits against the float session's, over their
# largest entry: JAX's bound for both options (tests/test_quant.py, "within a
# few percent"). Each option's own error is the quantizer's: a weight within
# scale/2 = absmax/254 of its float value, a depth value within scale/2 =
# range/510, checked directly.
QUANT_LOGIT_TOL = 5e-2


def same_results(got, want):
    """Whether two sessions' results (bucket -> result dicts) are equal bit
    for bit."""
    return all(np.array_equal(g[k], w[k]) for S in want for g, w in zip(got[S], want[S])
               for k in ("transcript", "durations", "future_frames", "seg"))


def same_chunk(a, b, batch):
    """Whether two sessions give the same outputs, bit for bit, on one
    collated chunk."""
    import torch

    x, y = a._run(*batch), b._run(*batch)
    return x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


def chunk_ab(live, served, batch, rounds=8):
    """One chunk's ``_run`` to a synchronised end, live and exported in
    turns (live, exported, exported, live), ``rounds`` times: the medians
    in ms (2 * ``rounds`` calls each)."""
    import torch

    times = {"live": [], "exported": []}
    for name in ("live", "exported", "exported", "live") * rounds:
        session = live if name == "live" else served
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session._run(*batch)["action"].cpu()
        times[name].append(1e3 * (time.perf_counter() - t0))
    return {name: float(np.median(t)) for name, t in times.items()}


def artifact_bytes(path):
    """(all files, the weights file, the largest program) in bytes."""
    import os

    sizes = {f: os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)}
    programs = [n for f, n in sizes.items() if f.endswith(".pt2")]
    return sum(sizes.values()), sizes["weights.pt"], max(programs), len(programs)


def htod_bytes(session, batch, path):
    """Host-to-device bytes of one chunk's ``_run``, from a profiler trace
    (spun first: a fresh trace can miss its first events, here the copies;
    traced again, up to 5 times, where it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
            session._run(*batch)["action"].cpu()
            torch.cuda.synchronize()
        copies = htod_copies(prof, path)
        if copies:
            return sum(copies)
    raise AssertionError("the profiler saw no host-to-device copy of a chunk in 5 traces")


def deploy_htod(card, state_dict):
    """Serving deployment (A13): the host-to-device bytes of one 2000-bucket
    chunk of utkinects (``DEPLOY_SERVE``'s 2 requests) with bf16 depth and
    with uint8 depth, from profiler traces. Run before the training phases:
    traces taken after the device-cache phase in the same process show no
    copies at all (``PERF.md`` §7)."""
    import os

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.serving import InferenceSession

    cfg = get_config("utkinects")
    videos = make_videos(np.random.default_rng(SEED + 9), DEPLOY_SERVE[2000], cfg)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "deploy_htod.json")
    for kind in ("float", "uint8"):
        session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8, **DEPLOY_KINDS[kind])
        batch = session._collate(videos, 2000)
        session._run(*batch)["action"].cpu()   # warm
        print(f"utkinects {kind} session: one 2000-bucket chunk of {len(videos)} (batch "
              f"{batch[0].shape[0]}) copies {htod_bytes(session, batch, path)} bytes host to "
              f"device [{card}]")


def serve_and_print(session, kernels, cfg, videos, label, card):
    """``serve_videos`` and a latency line a bucket, with the card."""
    lat, counts, per_bucket, results = serve_videos(session, kernels, cfg, videos)
    for S, t in lat.items():
        print(f"{label} bucket {S} [{card}]: {t['requests']} requests through ServingQueue, "
              f"latency p50 {t['p50_ms']:.2f} ms, max {t['max_ms']:.2f} ms; launches "
              f"{ {k: c for k, c in per_bucket[S].items() if c} }")
    return lat, counts, per_bucket, results


def serving_deploy(kernels, card, state_dict):
    """The rest of serving (A13) at full width. ``utkinects`` from the seeded
    init in four sessions (``max_batch`` 4), float, ``quantize="int8"``, ``input_dtype="uint8"``
    and both: every count set to 0, requests through ``ServingQueue`` in the
    256-2,000 buckets (each chunk must launch K1's blend route, the 256/512
    chunks fp32 K3), each session against the same session on the CPU
    (``E2E_TOL``), the uint8 session also with uint8 depth from the client
    (no host quantizer), the quantized sessions' logits against the float
    session's (``QUANT_LOGIT_TOL``), the depth quantizer's error (scale/2),
    and the weights' bytes on the card in fp32 and int8 (a 2000-bucket
    chunk's host-to-device bytes with float and uint8 depth come earlier,
    ``deploy_htod``). The float and
    the int8 + uint8 sessions exported (the export's time and the
    artifact's bytes), loaded as ``ExportedSession``s and served the same
    requests, equal to the live session bit for bit, K1's blend route and
    fp32 K3 launched, and a 512- and a 2000-bucket chunk timed live against
    exported in turns. Then ``50salads`` (bf16, one request at a time:
    ``max_batch=1``, 4 programs) with ``R3D_CROSS_NATIVE=1`` exported,
    loaded and served in the 256-3,100 buckets, equal to its live session
    bit for bit, bf16 K3 at 256/512 and bf16 K6 at 1,024/3,100. Each
    session's buckets are the served ones (``DEPLOY_SERVE``,
    ``SALADS_DEPLOY``), the utkinects sessions' ``max_batch`` 4.
    Returns (the live sessions' counts, the exported sessions' counts)."""
    import dataclasses
    import os
    import shutil

    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights
    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca
    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops.quant import quantized_nbytes
    from r3d_tpu_torch.serving import ExportedSession, InferenceSession, dequantize_depth

    # the served buckets alone, max_batch 4 (no bucket gets more than 4
    # requests): 12 programs an artifact, where the config's 5 buckets and
    # max_batch 8 made 20, about 2 s each to export
    base = get_config("utkinects")
    cfg = base.replace(data=dataclasses.replace(base.data, seq_buckets=tuple(DEPLOY_SERVE)))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), DEPLOY_DIR)
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 9)
    videos = {S: make_videos(rng, lens, cfg) for S, lens in DEPLOY_SERVE.items()}
    live_counts = {k.name: 0 for k in kernels}
    exported_counts = {k.name: 0 for k in kernels}

    def add(total, counts):
        for name, c in counts.items():
            total[name] += c

    def check_route(label, per_bucket, want):
        for S, names in want.items():
            missing = [n for n in names if per_bucket[S][n] == 0]
            if missing:
                raise AssertionError(f"{label} bucket {S} never launched {missing}: "
                                     f"{per_bucket[S]}")

    utk_want = {S: ((fk.KERNEL.name, att.KERNEL.name) if S <= 512 else (fk.KERNEL.name,))
                for S in DEPLOY_SERVE}
    try:
        sessions, chunk_out, live_results, live_lat = {}, {}, {}, {}
        chunk = {}
        for kind, kw in DEPLOY_KINDS.items():
            session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=4, **kw)
            label = f"utkinects {kind} session"
            live_lat[kind], counts, per_bucket, live_results[kind] = serve_and_print(
                session, kernels, cfg, videos, label, card)
            check_route(label, per_bucket, utk_want)
            add(live_counts, counts)
            print(f"{label}: card vs CPU")
            compare_with_cpu(session, cfg, state_dict, rng, **kw)
            chunk[kind] = session._collate(videos[2000], 2000)
            out = session._run(*session._collate(videos[512], 512))
            chunk_out[kind] = {k: out[k].float().cpu() for k in ("action", "duration")}
            print(f"{label}: weights on the card {quantized_nbytes(session.weights)} bytes "
                  f"[{card}]")
            if kind == "uint8":   # a client that ships uint8 depth: no host quantizer
                u8_videos = {S: [{**v, "depth": np.rint(v["depth"] * 255).astype(np.uint8)}
                                 for v in vids] for S, vids in videos.items()}
                serve_and_print(session, kernels, cfg, u8_videos,
                                f"{label}, uint8 depth from the client", card)
            if kind in DEPLOY_EXPORTED:
                sessions[kind] = session
            del session

        for kind in ("int8", "uint8", "int8+uint8"):
            ref = chunk_out["float"]
            worst = {k: float((chunk_out[kind][k] - ref[k]).abs().max())
                     / max(float(ref[k].abs().max()), 1e-6) for k in ref}
            print(f"utkinects {kind} vs float session, 512-bucket chunk: max|diff| over the "
                  f"largest entry {worst} (tol {QUANT_LOGIT_TOL})")
            if max(worst.values()) > QUANT_LOGIT_TOL:
                raise AssertionError(f"the {kind} session strays from the float session")
        d = videos[2000][0]["depth"]
        u, lo, scale = InferenceSession.quantize_depth(d)
        device = sessions["float"].device
        qp = torch.tensor([[lo, scale]], dtype=torch.float32, device=device)
        deq = dequantize_depth(torch.from_numpy(u)[None].to(device), qp, torch.float32)[0].cpu()
        err = float((deq - torch.from_numpy(d)).abs().max())
        print(f"uint8 depth: max|dequantized - float| {err:.3e} for scale {scale:.3e} "
              f"(bound scale/2 = {scale / 2:.3e}, + 1e-6 for fp32 roundings of values up to 1)")
        if err > scale / 2 + 1e-6:
            raise AssertionError("the depth quantizer strays beyond scale/2")

        for kind in DEPLOY_EXPORTED:
            path = os.path.join(root, kind.replace("+", "_"))
            t0 = time.perf_counter()
            sessions[kind].export(path)
            dt = time.perf_counter() - t0
            total, weights, program, n = artifact_bytes(path)
            print(f"utkinects {kind} export [{card}]: {n} programs in {dt:.1f} s, artifact "
                  f"{total} bytes (weights {weights} once, largest program {program})")
            t0 = time.perf_counter()
            served = ExportedSession.load(path)
            label = f"utkinects {kind} exported"
            lat, counts, per_bucket, results = serve_and_print(
                served, kernels, cfg, videos, label, card)
            print(f"{label}: loaded and served (programs loaded lazily) in "
                  f"{time.perf_counter() - t0:.1f} s")
            check_route(label, per_bucket, utk_want)
            add(exported_counts, counts)
            for S in DEPLOY_SERVE:
                print(f"utkinects {kind} bucket {S} [{card}]: p50 live "
                      f"{live_lat[kind][S]['p50_ms']:.2f} ms, exported {lat[S]['p50_ms']:.2f} "
                      f"ms; max live {live_lat[kind][S]['max_ms']:.2f} ms, exported "
                      f"{lat[S]['max_ms']:.2f} ms")
            for S in (512, 2000):
                ab = chunk_ab(sessions[kind], served, sessions[kind]._collate(videos[S], S))
                print(f"utkinects {kind} {S}-bucket chunk of {len(videos[S])} [{card}]: "
                      f"live {ab['live']:.2f} ms, exported {ab['exported']:.2f} ms (medians of "
                      f"16 calls each, in turns)")
            equal = same_results(results, live_results[kind])
            equal_chunk = same_chunk(served, sessions[kind], chunk[kind])
            print(f"{label} vs live: results bit-equal {equal}, a 2000-bucket chunk's outputs "
                  f"bit-equal {equal_chunk}")
            if not (equal and equal_chunk):
                raise AssertionError(f"the exported {kind} session differs from the live one")
            del served
        del sessions

        before = os.environ.get("R3D_CROSS_NATIVE")
        os.environ["R3D_CROSS_NATIVE"] = "1"
        try:
            sbase = get_config("50salads")
            scfg = sbase.replace(data=dataclasses.replace(sbase.data,
                                                          seq_buckets=tuple(SALADS_DEPLOY)))
            model = init_weights(build_model(scfg.model, SALADS_CLASSES),
                                 torch.Generator().manual_seed(SEED))
            # one request at a time: the artifact's programs are the 4 of batch 1
            live = InferenceSession(scfg, model.state_dict(), SALADS_CLASSES, max_batch=1)
            del model
            svideos = {S: make_videos(rng, lens, scfg) for S, lens in SALADS_DEPLOY.items()}
            want = {S: ((att.KERNEL_BF16.name,) if S <= 512 else (ca.FWD_KERNEL.name,))
                    for S in SALADS_DEPLOY}
            lat_l, counts, per_bucket, res_l = serve_and_print(
                live, kernels, scfg, svideos, "50salads live", card)
            check_route("50salads live", per_bucket, want)
            add(live_counts, counts)
            path = os.path.join(root, "50salads")
            t0 = time.perf_counter()
            live.export(path)
            dt = time.perf_counter() - t0
            total, weights, program, n = artifact_bytes(path)
            print(f"50salads export, R3D_CROSS_NATIVE=1 [{card}]: {n} programs in {dt:.1f} s, "
                  f"artifact {total} bytes (weights {weights} once, largest program {program})")
            served = ExportedSession.load(path)
            lat_e, counts, per_bucket, res_e = serve_and_print(
                served, kernels, scfg, svideos, "50salads exported", card)
            check_route("50salads exported", per_bucket, want)
            add(exported_counts, counts)
            for S in SALADS_DEPLOY:
                print(f"50salads bucket {S} [{card}]: p50 live {lat_l[S]['p50_ms']:.2f} ms, "
                      f"exported {lat_e[S]['p50_ms']:.2f} ms; max live {lat_l[S]['max_ms']:.2f} "
                      f"ms, exported {lat_e[S]['max_ms']:.2f} ms")
            for S in (512, 3100):
                ab = chunk_ab(live, served, live._collate(svideos[S], S))
                print(f"50salads {S}-bucket chunk of 1 [{card}]: live {ab['live']:.2f} ms, "
                      f"exported {ab['exported']:.2f} ms (medians of 16 calls each, in turns)")
            equal = same_results(res_e, res_l)
            equal_chunk = same_chunk(served, live, live._collate(svideos[3100], 3100))
            print(f"50salads exported vs live: results bit-equal {equal}, a 3100-bucket chunk's "
                  f"outputs bit-equal {equal_chunk}")
            if not (equal and equal_chunk):
                raise AssertionError("the exported 50salads session differs from the live one")
        finally:
            if before is None:
                os.environ.pop("R3D_CROSS_NATIVE", None)
            else:
                os.environ["R3D_CROSS_NATIVE"] = before
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return live_counts, exported_counts

DP_DIR = "build/dp_phase"   # under the checkout (git-ignored), removed after the phase
DP_STEPS = 4                # 512-bucket steps of a global batch of 8 on two gloo ranks
DP_DROPOUT_STEPS = 2        # then steps with dropout 0.1: the ranks' masks differ
DP_TIMEOUT = 300            # s: a rank or a collective that takes longer fails the phase
# Two ranks vs one process on the card, the CPU tests' fit bounds taken
# relative to each tensor's largest entry (at least 1), as their gradient
# bounds are: the BN statistics read in the tens at full width, where the
# CPU tests' read near 1
DP_LOSS_TOL = 1e-4          # the global loss a step, over max(1, |loss|)
DP_STATE_TOL = 1e-4         # final parameters and BN statistics on 99 % of each tensor's
                            # entries, and 2 lr an update on all (``_close_states``)
DP_LOG_TOL = 2e-3           # a logged loss or accuracy of N cards vs one (printed to 3 decimals)
DP_MOC_TOL = 1e-6           # a MoC entry of one checkpoint's sweep, N cards vs one
SP_RING_LOG_RTOL = 1e-2     # a logged number over max(1, |it|), N cards with the encoder on sp
                            # (the ring) vs one card (the fp32 many-query kernel): two attention
                            # algorithms, so the trained states drift apart within the fit bounds;
                            # read 7.1e-3 on 4 H100s (700 W), a sticky validation loss 6.736
                            # vs 6.784, while the same arm without the encoder read 0
PP_LOG_RTOL = SP_RING_LOG_RTOL   # a logged number over max(1, |it|), N cards on dp x pp 2 vs
                            # one card: on the CLI phase's dataset dp 2 alone drifts from one
                            # process (gloo on the CPU, dropout off: a sticky validation loss
                            # 8.623 vs 8.590, as on dp 2 x pp 2), where dp 4 reads 0 apart
SP_RING_MOC_TOL = 1e-2      # a MoC entry of the one-card checkpoint swept on N cards where the
                            # S-query decoder's self-attention is the ring (fp32 scores of bf16
                            # q, k, v) vs one card's bf16 many-query K3: outputs about 1e-2 apart
                            # (the sequence_parallel_families eval forward), enough to flip a
                            # frame's argmax; read 1.25e-3 on 4 H100s (700 W) for
                            # 50salads_proposed, whose training logs and states matched
CLI_WORKER = "--cli-worker"  # chip_smoke.py --cli-worker DROPOUT ENCODER FLAGS: the CLI, dropout at
                             # DROPOUT, ENCODER encoder layers (0: none)
CARDS = "--cards"            # chip_smoke.py --cards: cli_under_torchrun on every card, alone


def _dp_fit(kernels, config, route, sources, work, mesh=None, fsdp=False):
    """A 2-epoch utkinects fit on ``route`` ('fit': the host loader,
    'fit_cached': the device cache), on ``mesh`` where one is given, with
    its checkpoints under ``work``: (final model state, gathered whole
    where FSDP shards it, log lines, launch counts, wall time, the
    parameters FSDP sharded of all)."""
    import torch

    from r3d_tpu_torch.data import device_cache as dc
    from r3d_tpu_torch.data.datasets import build_loader
    from r3d_tpu_torch.parallel.mesh import full_tensors, is_sharded, shard_state
    from r3d_tpu_torch.train.checkpoint import Checkpointer
    from r3d_tpu_torch.train.loop import Trainer

    B, nq = config.train.batch_size, config.model.n_query
    train = build_loader(sources["train"], config.data, B, nq, seed=1, pin_memory=True)
    val = build_loader(sources["val"], config.data, B, nq, mode="val", shuffle=False,
                       pin_memory=True)
    trainer = Trainer(config, sources["train"].n_class, mesh=mesh)
    state = trainer.init_state(len(train), seed=1)
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp)
    lines = []
    kw = dict(log=lines.append, checkpointer=Checkpointer(work))
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    if route == "fit":
        trainer.fit(state, train, val, seed=1, **kw)
    else:
        cache = dc.cache_from_source(sources["train"], config.data, nq, device="cuda")
        val_cache = dc.cache_from_source(sources["val"], config.data, nq, device="cuda")
        trainer.fit_cached(state, cache, val, seed=1, val_cache=val_cache, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    final = {k: v.detach().clone() for k, v in full_tensors(state.model.state_dict()).items()}
    params = list(state.model.parameters())
    return (final, lines, {k.name: k.launches for k in kernels}, dt,
            (sum(is_sharded(p) for p in params), len(params)))


def saved_tensors(path):
    """{checkpoint file relative to ``path``: its tensors by name (the
    model's, and the optimizer's as ``optimizer/{i}/{key}``)}."""
    import os

    import torch

    out = {}
    for d, _, files in os.walk(path):
        if "state.pt" in files:
            blob = torch.load(os.path.join(d, "state.pt"), map_location="cpu", weights_only=True)
            t = dict(blob["model"])
            for i, st in blob["optimizer"]["state"].items():
                t.update({f"optimizer/{i}/{k}": v for k, v in st.items()})
            t["step"] = torch.tensor(blob["step"])
            out[os.path.relpath(d, path)] = t
    return out


def same_checkpoints(a, b):
    """The checkpoint files and tensors where two ``saved_tensors`` differ."""
    import torch

    if sorted(a) != sorted(b):
        return [f"files {sorted(a)} vs {sorted(b)}"]
    return [f"{f}:{k}" for f in a for k in b[f] if k not in a[f] or not
            (a[f][k].dtype == b[f][k].dtype and torch.equal(a[f][k], b[f][k]))]


DP_KERNELS = ("fused_bn_blend_tail", "fused_safuser_tail", "fused_tail_bwd", "flash_attention",
              "flash_attention_dropout", "attention_bwd")   # K1 (both routes), K2, K3, K4, K5


_DP_BATCHES = {}   # the data's fields -> the batches: the parallel phases share them


def _dp_batches(cfg):
    """``DP_STEPS`` host batches of 8 windows of 257-512 rows (the 512
    bucket), cycling over the distinct ones the utkinects loader has; made
    once for each layout of the data (its synthetic depth frames are made on
    the host)."""
    m, d = cfg.model, cfg.data
    key = (m.input_dim, m.n_query, tuple(d.depth_shape), tuple(d.seq_buckets), d.feature_dtype,
           d.depth_features_dir is not None)
    if key not in _DP_BATCHES:
        _DP_BATCHES[key] = _make_dp_batches(cfg)
    return list(_DP_BATCHES[key])


def _make_dp_batches(cfg):
    from r3d_tpu_torch.data.pipeline import pad_batch

    _, loader, _ = train_loaders(cfg)
    examples = [e for e in (loader.make_example_fn(int(j)) for j in loader._order())
                if 256 < e.features.shape[0] <= 512]
    batches = [pad_batch(examples[i: i + 8], loader.pad_idx, loader.buckets, loader.n_query,
                         loader.with_depth, loader.feature_dtype, False)
               for i in range(0, len(examples) - 7, 8)]
    if not batches:
        raise AssertionError("data_parallel: the loader has no 8 windows in the 512 bucket")
    return [batches[i % len(batches)] for i in range(DP_STEPS)]


def _dp_steps(trainer, state, batches, seed_dropout=False):
    """``train_step`` over ``batches`` in train mode (BN batch statistics):
    (the global loss of each, the wall time of each)."""
    import torch

    if seed_dropout:
        trainer._seed_dropout(state, SEED, 0)
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(state, b, 0)
        losses.append(trainer._to_host({"loss": metrics["loss"]})["loss"])
        times.append(time.perf_counter() - t0)
    return losses, times


def _dp_rank(rank, world, work):
    """One gloo rank on the card (``cuda:0``, shared): the dropout-off steps
    and the dropout-on steps of ``data_parallel``'s third arm; writes its
    results to ``work/rank{rank}.pt``."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=DP_TIMEOUT))
        from r3d_tpu_torch.ops import attention as att
        from r3d_tpu_torch.ops import fuser_kernel as fk
        from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb
        from r3d_tpu_torch.parallel.mesh import make_mesh, shard_state
        from r3d_tpu_torch.train.loop import Trainer

        kernels = [fk.KERNEL, fk.TAIL_KERNEL, fkb.KERNEL, att.KERNEL, att.DROPOUT_KERNEL,
                   att.BWD_KERNEL]
        mesh = make_mesh(dp=world)
        batches = torch.load(os.path.join(work, "batches.pt"), weights_only=True)
        out = {}
        for tag, steps, drop in (("off", batches, 0.0), ("on", batches[:DP_DROPOUT_STEPS], 0.1)):
            cfg = dp_config(drop)
            trainer = Trainer(cfg, N_CLASS, mesh=mesh)
            state = shard_state(trainer.init_state(1, dp_init(cfg)), mesh)
            for k in kernels:
                k.launches = 0
            losses, times = _dp_steps(trainer, state, steps, seed_dropout=drop > 0)
            torch.cuda.synchronize()
            out[tag] = dict(losses=losses, times=times,
                            launches={k.name: k.launches for k in kernels},
                            state={k: v.detach().cpu() for k, v in
                                   state.model.state_dict().items()})
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def dp_config(dropout):
    """utkinects at full width with both dropout rates at ``dropout``."""
    import dataclasses

    from r3d_tpu_torch.config import get_config

    cfg = get_config("utkinects")
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=dropout,
                                                 fuser_dropout=dropout))


def dp_init(cfg):
    """The port's seeded init of ``cfg``'s model (the same in every process)."""
    import torch

    from r3d_tpu_torch.models import build_model, init_weights

    return init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                        torch.Generator().manual_seed(SEED)).state_dict()


def _close_states(got, want, lr, updates, share=True):
    """The tensors of two model states outside the fit bounds: over the
    scale max(1, the tensor's largest entry), ``DP_STATE_TOL`` on 99 % of
    its entries (but ``GRAD_NOISE_ONLY``'s; not with ``share`` False) and 2
    ``lr`` an update on all (Adam moves an entry by at most about lr an
    update). (name, max|diff|, scale) each."""
    bad = []
    for k, w in want.items():
        if k not in got:
            bad.append((k, "missing", None))
            continue
        w = w.float().cpu()
        d = (got[k].float().cpu() - w).abs()
        scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        if d.numel() and (float(d.max()) > 2 * lr * updates * scale or (
                share and not k.endswith(GRAD_NOISE_ONLY)
                and float((d > DP_STATE_TOL * scale).float().mean()) > 0.01)):
            bad.append((k, float(d.max()), scale))
    return bad


def dp_cli_argv(work):
    """Write the CLI phase's utkinects dataset (5 + 2 videos) under
    ``work``: the CLI flags that train on it, 2 epochs, seed 1."""
    import os

    root = write_utkinect_dataset(os.path.join(work, "data"), 5, 2, CLI_TRAIN_LENGTHS,
                                  val_lengths=CLI_VAL_LENGTHS)
    return ["--config", "utkinects", "--data_root", root, "--seed", "1", "--epochs", "2"]


def _cli_main(flags, dropout=None, log=print, encoder=0):
    """``cli.run.main`` with ``flags`` parsed as ``python -m r3d_tpu_torch.cli``
    parses them, both dropout rates at ``dropout`` where it is set
    (``--fuser_dropout`` has no flag) and ``encoder`` encoder layers where it
    is above 0 (``use_encoder`` has no flag); ``main`` forms the group where
    ``torchrun`` started the process."""
    import dataclasses

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args
    from r3d_tpu_torch.cli.run import main as cli_main

    args = build_parser("utkinects").parse_args(flags)
    cfg = config_from_args(args)
    if dropout is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=dropout,
                                                    fuser_dropout=dropout))
    if encoder:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_encoder=True,
                                                    n_encoder_layers=encoder))
    with fixed_dropouts(dropout):
        return cli_main(cfg, mode="predict" if args.predict else args.mode, log=log,
                        results_save_path=args.results_save_path,
                        device="cpu" if args.cpu else "cuda")


@contextlib.contextmanager
def fixed_dropouts(rate):
    """Within: the dropouts whose rate is written into the models (the
    self-attention and depth sources', the TCN's) at ``rate``, read when a
    model is built (as they were where ``rate`` is None): on N cards the dp
    ranks draw their own masks, so a run held to one card's turns them off
    as it turns off the configured ones."""
    from r3d_tpu_torch.models import baselines
    from r3d_tpu_torch.models import futr_unsupervised as fu

    saved = baselines.TCN_DROPOUT, fu.SRC_DROPOUT, fu.DEPTH_QUERY_DROPOUT
    if rate is not None:
        baselines.TCN_DROPOUT = fu.SRC_DROPOUT = fu.DEPTH_QUERY_DROPOUT = rate
    try:
        yield
    finally:
        baselines.TCN_DROPOUT, fu.SRC_DROPOUT, fu.DEPTH_QUERY_DROPOUT = saved


def cli_worker(argv) -> None:
    """``chip_smoke.py --cli-worker DROPOUT ENCODER FLAGS``: ``_cli_main(FLAGS,
    DROPOUT, encoder=ENCODER)``, the CLI that ``torchrun`` starts on each
    rank."""
    _cli_main(argv[2:], float(argv[0]), encoder=int(argv[1]))


def _cli(flags, here, n_ranks=None, dropout=None, encoder=0):
    """The CLI: (its log lines, its wall time). Without ``n_ranks`` the plain
    CLI in this process; with it, under ``torchrun --standalone
    --nproc_per_node n_ranks`` (``-m r3d_tpu_torch.cli``, or this script's
    ``--cli-worker`` where ``dropout`` is set), rank 0's stdout lines.
    ``encoder``: encoder layers (``_cli_main``; with ``dropout`` set)."""
    import io
    import os

    t0 = time.perf_counter()
    if n_ranks is None:
        lines = []
        with contextlib.redirect_stdout(io.StringIO()):
            _cli_main(flags, dropout, log=lines.append, encoder=encoder)
        return lines, time.perf_counter() - t0
    entry = (["-m", "r3d_tpu_torch.cli"] if dropout is None
             else [os.path.abspath(__file__), CLI_WORKER, str(dropout), str(encoder)])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n_ranks), *entry, *flags]
    done = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=DP_TIMEOUT,
                          env={**os.environ, "PYTHONPATH": here})
    if done.returncode != 0:
        raise AssertionError(f"data_parallel: {' '.join(cmd[:8])} ... exited "
                             f"{done.returncode}: {done.stderr[-3000:]}")
    return done.stdout.splitlines(), time.perf_counter() - t0


def _log_numbers(lines):
    """The numbers of the Epoch and Validation log lines, without the
    clips/s rate."""
    return [[float(x) for x in re.findall(r"-?\d+\.\d+", re.sub(r"\([0-9.]+ clips/s\)", "", l))]
            for l in lines if l.startswith(("Epoch", "Validation"))]


def cli_under_torchrun(n_ranks, argv, work, here, card, tp=1, sp=1, encoder=0,
                       ring_decoder=False, pp=1, pp_flags=()):
    """The CLI (train, checkpoints, sweep) under ``torchrun --standalone
    --nproc_per_node n_ranks ... --fsdp`` (and ``--mesh_tp tp``, ``--mesh_sp
    sp``: a mesh of n_ranks / (tp sp) by tp by sp; ``encoder``: both CLIs
    with that many encoder layers, whose self-attention on sp is the ring
    over NCCL's point-to-point calls, its logged numbers then held to
    ``SP_RING_LOG_RTOL``; ``ring_decoder``: the config's S-query decoder
    takes the ring on sp, its logged numbers held so too and its sweep's
    MoC to ``SP_RING_MOC_TOL``; ``pp``: ``--mesh_pp pp`` and ``pp_flags``,
    without ``--fsdp`` under ``--pp_schedule 1f1b``, which refuses it)
    against the plain CLI on one card (in this process). One rank keeps utkinects' dropout 0.1
    (rank 0 draws one process's masks): the MoC tables and every checkpoint
    tensor equal, bit for bit. More ranks run with dropout off (their masks
    are not one process's): the same log lines with their numbers within
    ``DP_LOG_TOL``, the same checkpoints and step counts, every model
    tensor within the fit bounds (``_close_states``, at the config's lr),
    and the one-process checkpoint swept on the ranks within
    ``DP_MOC_TOL`` of its plain sweep. The wall times include the
    ``torchrun`` processes' start and, in the first run, loading the
    kernels: a reading, not a throughput. Returns them."""
    import json as _json
    import os

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args

    one = n_ranks == 1
    dropout = None if one else 0.0
    mode = "train_eval" if one else "train"
    mesh_flags = ((["--mesh_tp", str(tp)] if tp > 1 else [])
                  + (["--mesh_sp", str(sp)] if sp > 1 else [])
                  + (["--mesh_pp", str(pp)] if pp > 1 else []) + list(pp_flags))
    fsdp = [] if "1f1b" in pp_flags else ["--fsdp"]
    runs = {}
    for tag, n in (("plain", None), ("torchrun", n_ranks)):
        save, res = os.path.join(work, f"cli_{tag}"), os.path.join(work, f"results_{tag}")
        flags = argv + ["--mode", mode, "--model_save_path", save, "--results_save_path", res]
        lines, dt = _cli(flags + (fsdp + mesh_flags if n else []), here, n, dropout, encoder)
        runs[tag] = (lines, saved_tensors(save), dt, res)
    lines = runs["torchrun"][0]
    mesh = (f"mesh: {{'dp': {n_ranks // (tp * sp * pp)}, 'ep': 1, 'tp': {tp}, 'sp': {sp}, "
            f"'pp': {pp}}}")
    for need in (mesh,) + (("fsdp: state sharded over dp",) if fsdp else ()):
        if need not in lines:
            raise AssertionError(f"data_parallel: torchrun CLI on {n_ranks} ranks: no {need!r}")
    want, got = runs["plain"][1], runs["torchrun"][1]
    label = (f"the CLI (2 epochs) under torchrun --standalone --nproc_per_node {n_ranks} "
             f"{' '.join(fsdp + mesh_flags)} "
             f"{runs['torchrun'][2]:.2f} s, plain {runs['plain'][2]:.2f} s (wall time, the "
             f"former with its processes' start)")
    if one:
        tables = [_json.load(open(os.path.join(runs[t][3], "results.json"))) for t in runs]
        ckpt_diff = same_checkpoints(got, want)
        print(f"dp [{card}]: {label}: MoC tables equal {tables[0] == tables[1]}, "
              f"{len(ckpt_diff)} checkpoint tensors differ in {sorted(want)}")
        if tables[0] != tables[1] or ckpt_diff:
            raise AssertionError(f"data_parallel: the torchrun CLI differs from the plain CLI: "
                                 f"{ckpt_diff[:5]} {tables}")
        return dict(train_s=[runs["plain"][2], runs["torchrun"][2]])
    lr = config_from_args(build_parser("utkinects").parse_args(argv)).train.lr
    numbers = [_log_numbers(runs[t][0]) for t in ("plain", "torchrun")]
    ring = sp > 1 and (encoder > 0 or ring_decoder)
    moc_tol = SP_RING_MOC_TOL if sp > 1 and ring_decoder else DP_MOC_TOL
    relative = ring or pp > 1
    scale = (lambda b: max(1.0, abs(b))) if relative else (lambda b: 1.0)
    log_tol = SP_RING_LOG_RTOL if ring else PP_LOG_RTOL if pp > 1 else DP_LOG_TOL
    log_err = max((abs(a - b) / scale(b) for x, y in zip(*numbers) for a, b in zip(x, y)),
                  default=0.0)
    heads = [[l.split(":")[0] for l in runs[t][0] if l.startswith(("Epoch", "Best"))]
             for t in ("plain", "torchrun")]
    bad = [] if sorted(got) == sorted(want) else [f"files {sorted(got)} vs {sorted(want)}"]
    for f, tensors in want.items():
        if f not in got:
            continue
        if int(tensors["step"]) != int(got[f]["step"]):
            bad.append((f, "step"))
        model = {k: v for k, v in tensors.items()
                 if not k.startswith("optimizer/") and v.is_floating_point()}
        bad += [(f, *b) for b in _close_states(got[f], model, lr, int(tensors["step"]))]
    sweeps = {}
    for tag, n in (("plain", None), ("torchrun", n_ranks)):
        res = os.path.join(work, f"sweep_{tag}")
        _, dt = _cli(argv + ["--predict", "--model_save_path", os.path.join(work, "cli_plain"),
                             "--results_save_path", res] + (mesh_flags if n else []),
                     here, n, dropout, encoder)
        sweeps[tag] = (_json.load(open(os.path.join(res, "results.json"))), dt)
    moc_err = max(abs(sweeps["torchrun"][0][o][k] - v) for o, r in sweeps["plain"][0].items()
                  for k, v in r.items())
    if log_err:
        for a, b in zip(*[[l for l in runs[t][0] if l.startswith(("Epoch", "Validation"))]
                          for t in ("plain", "torchrun")]):
            print(f"dp [{card}]:   one card: {a}\n dp [{card}]:   {n_ranks} cards: {b}")
    print(f"dp [{card}]: {label}, dropout off: logged numbers max|diff|"
          f"{' / max(1, |number|)' if relative else ''} {log_err:.3e} (tol {log_tol}), lines alike {heads[0] == heads[1]}, {len(bad)} checkpoint tensors "
          f"outside the fit bounds at lr {lr} {bad[:4]}; the one-process checkpoint swept on "
          f"{n_ranks} ranks {sweeps['torchrun'][1]:.2f} s, plain {sweeps['plain'][1]:.2f} s: "
          f"max|MoC diff| {moc_err:.3e} (tol {moc_tol})")
    if log_err > log_tol or heads[0] != heads[1] or bad or moc_err > moc_tol:
        raise AssertionError(f"data_parallel: the CLI on {n_ranks} cards differs from one card")
    return dict(train_s=[runs["plain"][2], runs["torchrun"][2]],
                sweep_s=[sweeps["plain"][1], sweeps["torchrun"][1]], log_err=log_err,
                moc_err=moc_err)


def data_parallel(kernels, card):
    """Phase 21: see the module docstring. Returns the launch counts of the
    one-rank group's three fits."""
    import datetime
    import os
    import shutil

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from r3d_tpu_torch.cli.opts import build_parser, config_from_args
    from r3d_tpu_torch.data.datasets import build_source
    from r3d_tpu_torch.parallel.mesh import make_mesh
    from r3d_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, DP_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    try:
        argv = dp_cli_argv(work)
        config = config_from_args(build_parser("utkinects").parse_args(argv))
        sources = {s: build_source(config.data, f"{s}_split.txt") for s in ("train", "val")}

        # arm 1: a one-rank NCCL group on cuda:0, in this process
        total = {k.name: 0 for k in kernels}
        plain = {}
        for route, fsdp in (("fit", False), ("fit_cached", False), ("fit_cached", True)):
            tag = route + ("_fsdp" if fsdp else "")
            if route not in plain:
                plain[route] = _dp_fit(kernels, config, route, sources,
                                       os.path.join(work, f"plain_{tag}"))
            dist.init_process_group("nccl", init_method=f"file://{work}/store_{tag}", rank=0,
                                    world_size=1, timeout=datetime.timedelta(seconds=DP_TIMEOUT))
            try:
                mesh = make_mesh(dp=1)
                got = _dp_fit(kernels, config, route, sources, os.path.join(work, f"group_{tag}"),
                              mesh=mesh, fsdp=fsdp)
            finally:
                dist.destroy_process_group()
            want = plain[route]
            strip = lambda lines: [line.split("(")[0] for line in lines]
            diff = unequal(got[0], want[0])
            ckpt_diff = same_checkpoints(saved_tensors(os.path.join(work, f"group_{tag}")),
                                         saved_tensors(os.path.join(work, f"plain_{route}")))
            launched = {n: got[2][n] for n in DP_KERNELS}
            print(f"dp [{card}]: {tag} on a one-rank NCCL group {got[3]:.2f} s (without a group "
                  f"{want[3]:.2f} s; {got[4][0]} of {got[4][1]} parameters DTensors): "
                  f"{len(diff)} of {len(want[0])} final tensors and "
                  f"{len(ckpt_diff)} checkpoint tensors differ (bit for bit); launches inside "
                  f"the group {launched}")
            if got[4][0] != (got[4][1] if fsdp else 0):
                raise AssertionError(f"data_parallel: {tag}: {got[4][0]} of {got[4][1]} "
                                     "parameters sharded")
            if diff or ckpt_diff or strip(got[1]) != strip(want[1]):
                raise AssertionError(f"data_parallel: {tag} on a one-rank group differs from "
                                     f"the run without one: {diff} {ckpt_diff[:5]} "
                                     f"{got[1]} {want[1]}")
            missing = [n for n, c in launched.items() if c == 0]
            if missing:
                raise AssertionError(f"data_parallel: {tag} in the group never launched "
                                     f"{missing}")
            for k, c in got[2].items():
                total[k] += c

        # arm 2: the CLI under torchrun (one process) against the plain CLI, and
        # on every card where the script sees more than one
        cli_under_torchrun(1, argv, work, here, card)
        if torch.cuda.device_count() > 1:
            cli_under_torchrun(torch.cuda.device_count(), argv, work, here, card)

        # arm 3: two gloo ranks sharing the card against one process
        batches = _dp_batches(dp_config(0.0))
        torch.save(batches, os.path.join(work, "batches.pt"))
        cfg = dp_config(0.0)
        trainer = Trainer(cfg, N_CLASS)
        state = trainer.init_state(1, dp_init(cfg))
        one_losses, one_times = _dp_steps(trainer, state, batches)
        one_state = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        del trainer, state
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_dp_rank, args=(r, 2, work), daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))
        errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
                  if f.endswith(".err")]
        if any(p.is_alive() or p.exitcode != 0 for p in procs) or errors:
            raise AssertionError(f"data_parallel: a gloo rank failed: exit codes "
                                 f"{[p.exitcode for p in procs]} {errors}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
                 for r in range(2)]
        t_ranks = time.perf_counter() - t0
        loss_err = max(abs(a - b) / max(1.0, abs(b))
                       for a, b in zip(ranks[0]["off"]["losses"], one_losses))
        bad = _close_states(ranks[0]["off"]["state"], one_state, dp_config(0.0).train.lr,
                            DP_STEPS)
        split = [k for k in one_state if not torch.equal(ranks[0]["off"]["state"][k],
                                                         ranks[1]["off"]["state"][k])]
        split_on = [k for k in one_state if not torch.equal(ranks[0]["on"]["state"][k],
                                                            ranks[1]["on"]["state"][k])]
        finite = all(torch.isfinite(v).all() for r in ranks for v in r["on"]["state"].values()
                     if v.is_floating_point())
        for r, out in enumerate(ranks):
            launched = {n: out["off"]["launches"].get(n, 0) + out["on"]["launches"].get(n, 0)
                        for n in DP_KERNELS}
            print(f"dp [{card}]: gloo rank {r} of 2 on the one card: launches {launched}; "
                  f"median step {1e3 * float(np.median(out['off']['times'][1:])):.2f} ms over "
                  f"{DP_STEPS - 1} steps of 4 rows (the first, {1e3 * out['off']['times'][0]:.2f}"
                  f" ms, aside)")
            missing = [n for n, c in launched.items() if c == 0]
            if missing:
                raise AssertionError(f"data_parallel: gloo rank {r} never launched {missing}")
        print(f"dp [{card}]: 2 gloo ranks ({t_ranks:.1f} s with their start) vs one process "
              f"(median step {1e3 * float(np.median(one_times[1:])):.2f} ms over 8 rows): "
              f"{DP_STEPS} steps, max|loss diff| / max(1, |loss|) {loss_err:.3e} (tol "
              f"{DP_LOSS_TOL}), losses "
              f"{ranks[0]['off']['losses']} vs {one_losses}; {len(bad)} of {len(one_state)} "
              f"final tensors outside the fit bounds {bad[:3]}; the ranks' states differ in "
              f"{len(split)} tensors, after {DP_DROPOUT_STEPS} dropout steps in "
              f"{len(split_on)} (finite {finite})")
        if loss_err > DP_LOSS_TOL or bad or split or split_on or not finite:
            raise AssertionError("data_parallel: two gloo ranks disagree with one process "
                                 "or with each other")
        print(f"dp [{card}]: the data_parallel phase took {time.perf_counter() - t_phase:.1f} s")
        return total
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------- phase 22: tensor and expert parallelism

TP_DIR = "build/tp_phase"   # under the checkout (git-ignored), removed after the phase
TP_TIMEOUT = 300            # s: a rank or a collective that takes longer fails the phase
TP_STEPS = 4                # steps of each arm, dropout off, on two gloo ranks and in one process
TP_DROPOUT_STEPS = 2        # then steps of the tp arms with dropout 0.1 (K4, K6 and K7's masks)
TP_ROWS_2000 = 2            # rows of the 2000-bucket batch (154 MB of bf16 depth)
TP_BF16_LOSS_TOL = 1e-2     # the bf16 arms' loss, two ranks vs one process (SALADS_LOSS_TOL);
                            # their states within Adam's 2 lr an update on every entry alone: a
                            # near-zero bf16 gradient that flips sign moves an entry by 2 lr
DARAI_TP = dict(warmup_loss_epochs=(1, 3), supcon_weight=0.5)   # epoch 2: every term weighs in
GLOO_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "reduce_scatter",
            "reduce_scatter_tensor", "all_to_all", "reduce")


def check_tp_shapes(gen, device):
    """K3-K7 at the shapes a rank of tp 2 gives them (its half of the
    heads), against their plain versions: fp32 K3, K4 and K5 at B 8, H 4, Lq
    8, Lk 512, D 16 (utkinects, hidden 128 over 8 heads) and bf16 at H 4, Lq
    20, D 64 (50salads); fp32 K6 and K7 at C 64 (H 4, D 16, Lq 8, S 2,000)
    and bf16 at C 256 (H 4, D 64, Lq 20, S 3,100); rate 0 and 0.1. Returns
    {kernel: (max|kernel - plain|, over max(1, max|plain|))}."""
    import torch

    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca

    worst = {}
    rate = 0.1
    for dtype, Lq, D, tol in ((torch.float32, 8, 16, K3_TOL), (torch.bfloat16, 20, 64, BF16_TOL)):
        B, H, Lk = 8, 4, 512
        name = "fp32" if dtype == torch.float32 else "bf16"
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        g = torch.randn(q.shape, generator=gen).to(device, dtype)
        scale = 1.0 / math.sqrt(D)
        got = {f"K3 {name}": errs([att.flash_attention(q, k, v, bias, scale)],
                                  [att.composed_attention(q, k, v, bias, scale)]),
               f"K4 {name}": errs([att.flash_attention_dropout(q, k, v, bias, 7, scale, rate)],
                                  [att.composed_attention_dropout(q, k, v, bias, 7, scale, rate)]),
               f"K5 {name}": worse(*(errs(att.attention_bwd(q, k, v, bias, 7, scale, r, g,
                                                            need_dbias=True),
                                          att.composed_attention_bwd(q, k, v, bias, 7, scale, r, g))
                                     for r in (0.0, rate)))}
        for key, e in got.items():
            print(f"tp shapes: {key} B={B} H={H} Lq={Lq} Lk={Lk} D={D}: max|kernel - plain| "
                  f"{e[0]:.3e}, relative {e[1]:.3e} (tol {tol})")
            if not e[1] <= tol:
                raise AssertionError(f"tensor_parallel: {key} disagrees at H={H}")
        worst.update(got)
    for dtype, Lq, C, S, (ftol, btol) in (
            (torch.float32, 8, 64, 2000, (CROSS_FWD_TOL, CROSS_BWD_TOL)),
            (torch.bfloat16, 20, 256, 3100, (BF16_TOL, BF16_TOL))):
        B, H = 8, 4
        name = "fp32" if dtype == torch.float32 else "bf16"
        q, k, v, bias = cross_inputs(B, Lq, S, C, gen, device, dtype)
        g = torch.randn(q.shape, generator=gen).to(device, dtype)
        scale = 1.0 / math.sqrt(C // H)
        e6 = e7 = (0.0, 0.0)
        for r in (0.0, rate):
            out, m, l = ca.cross_attention_fwd(q, k, v, bias, 5, scale, r, H)
            want = ca.composed_cross_attention(q, k, v, bias, 5, scale, r, H)
            e6 = worse(e6, errs([out], want[:1]))
            e7 = worse(e7, errs(ca.cross_attention_bwd(q, k, v, bias, 5, scale, r, H, g, out, m, l,
                                                       need_dbias=True),
                                ca.composed_cross_attention_bwd(q, k, v, bias, 5, scale, r, H, g,
                                                                out, m, l)))
        print(f"tp shapes: K6/K7 {name} B={B} Lq={Lq} S={S} C={C} H={H}: forward relative "
              f"{e6[1]:.3e} (tol {ftol}), backward relative {e7[1]:.3e} (tol {btol})")
        if not (e6[1] <= ftol and e7[1] <= btol):
            raise AssertionError(f"tensor_parallel: K6/K7 {name} disagree at C={C}")
        worst[f"K6 {name}"], worst[f"K7 {name}"] = e6, e7
    return worst


def tp_configs():
    """The phase's configs: utkinects at full width (dropout off), 50salads
    with MoE (4 experts, top 2) and dropout off, darai (futr_unsupervised,
    the unsupervised loop, SupCon on) and 50salads' futr loop on the
    self-attention source, both without dropout."""
    import dataclasses

    from r3d_tpu_torch.config import get_config

    salads = get_config("50salads")
    moe = salads.replace(model=dataclasses.replace(salads.model, dropout=0.0, **MOE))
    darai = get_config("darai")
    darai = darai.replace(model=dataclasses.replace(darai.model, dropout=0.0),
                          train=dataclasses.replace(darai.train, **DARAI_TP))
    unsup = salads.replace(model=dataclasses.replace(salads.model, model="futr_unsupervised",
                                                     dropout=0.0, query_num=darai.model.query_num))
    return dict(utk=dp_config(0.0), moe=moe, darai=darai, unsup=unsup)


def tp_inits(cfgs):
    """The seeded init of each config's model (the same in every process)."""
    import torch

    from r3d_tpu_torch.models import build_model, futr_unsupervised, init_weights

    saved, futr_unsupervised.SRC_DROPOUT = futr_unsupervised.SRC_DROPOUT, 0.0
    try:
        return {k: init_weights(build_model(c.model, tp_classes(k), c.data.depth_shape),
                                torch.Generator().manual_seed(SEED)).state_dict()
                for k, c in cfgs.items()}
    finally:
        futr_unsupervised.SRC_DROPOUT = saved


def tp_classes(key):
    return N_CLASS if key == "utk" else DARAI_CLASSES if key == "darai" else SALADS_CLASSES


DARAI_CLASSES = 11   # the darai arm's synthetic actions: 10 + NONE


def tp_batches(cfgs):
    """The host batches of each arm: utkinects' ``TP_STEPS`` 512-bucket
    batches of 8 and a 2000-bucket batch of ``TP_ROWS_2000``; 50salads'
    512-bucket batch of 8; darai's of 4 (synthetic videos with 47 L3
    labels, padded with 47)."""
    from r3d_tpu_torch.data.pipeline import BucketedLoader
    from r3d_tpu_torch.data.synthetic import SyntheticSource

    utk = cfgs["utk"]
    out = dict(utk=_dp_batches(utk)[:TP_STEPS],
               utk2000=[one_batch(utkinects_native_loaders(utk)[1], 1024, rows=TP_ROWS_2000)],
               salads=[one_batch(salads_loaders(cfgs["moe"])[1], 256, 512)])
    d = cfgs["darai"]
    src = SyntheticSource(n_videos=6, n_actions=DARAI_CLASSES - 1, vid_len_range=(600, 1000),
                          input_dim=d.model.input_dim, n_query_classes=d.train.l3_pad_idx,
                          seed=SEED)
    fn, n = src.make_example_fn((0.5,), 1, d.model.n_query)
    loader = BucketedLoader(num_examples=n, make_example_fn=fn, batch_size=4,
                            pad_idx=src.pad_idx, buckets=d.data.seq_buckets,
                            n_query=d.model.n_query, with_query=True,
                            query_pad_idx=d.train.l3_pad_idx, shuffle=False)
    out["darai"] = [next(iter(loader))]
    for key, want in (("utk", 512), ("utk2000", 2000), ("salads", 512), ("darai", 512)):
        if out[key][0]["features"].shape[1] != want:
            raise AssertionError(f"tensor_parallel: the {key} batch fell in bucket "
                                 f"{out[key][0]['features'].shape[1]}, not {want}")
    return out


# arm -> (config, batches, mesh sizes, dropout steps too, R3D_CROSS_NATIVE, epoch)
TP_ARMS = {
    "utkinects tp 2, 512": ("utk", "utk", dict(dp=1, tp=2), True, False, 0),
    "utkinects tp 2, 2000, R3D_CROSS_NATIVE=1": ("utk", "utk2000", dict(dp=1, tp=2), True, True, 0),
    "50salads MoE ep 2": ("moe", "salads", dict(dp=1, ep=2), False, False, 0),
    "darai dp 2": ("darai", "darai", dict(dp=2), False, False, 2),
    "futr_unsupervised (50salads futr loop) dp 2": ("unsup", "salads", dict(dp=2), False, False, 0),
}


def _tp_steps(trainer, state, batches, epoch, seed_dropout=False):
    """``train_step`` over ``batches`` in ``epoch``: (the global loss of
    each, the wall time of each)."""
    import torch

    if seed_dropout:
        trainer._seed_dropout(state, SEED, 0)
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(state, trainer._with_seg_ids(b), epoch)
        losses.append(trainer._to_host({"loss": metrics["loss"]})["loss"])
        times.append(time.perf_counter() - t0)
    return losses, times


def _gloo_probe(rank):
    """Which gloo collectives accept CUDA tensors in this torch: {op: "ok"
    or the error's first line}. A probe, not an arm: it only records."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device="cuda")

    calls = {"all_reduce": lambda: dist.all_reduce(x.clone()),
             "broadcast": lambda: dist.broadcast(x.clone(), src=0),
             "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                 x.new_empty(8), x),
             "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                 x.new_empty(2), x.clone()),
             "reduce_scatter": lambda: dist.reduce_scatter(torch.empty_like(x),
                                                           [x.clone(), x.clone()]),
             "all_to_all": lambda: dist.all_to_all([torch.empty_like(x) for _ in range(2)],
                                                   [x.clone(), x.clone()]),
             "reduce": lambda: dist.reduce(x.clone(), dst=0)}
    out = {}
    for op in GLOO_OPS:
        try:
            calls[op]()
            torch.cuda.synchronize()
            out[op] = "ok"
        except Exception as e:   # noqa: BLE001 -- the answer recorded is the error itself
            out[op] = str(e).splitlines()[0][:120]
        dist.barrier()
    return out


def _tp_rank(rank, world, work):
    """One gloo rank on the card (``cuda:0``, shared): every ``TP_ARMS`` arm
    on its mesh, each with the counts set to 0 before it and read after,
    the attention calls' heads and channels recorded; writes its results to
    ``work/rank{rank}.pt``."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=TP_TIMEOUT))
        out = {"gloo": _gloo_probe(rank)}
        kernels = tp_kernels()
        batches = torch.load(os.path.join(work, "batches.pt"), weights_only=True)
        inits = torch.load(os.path.join(work, "inits.pt"), weights_only=True)
        from r3d_tpu_torch.parallel.mesh import make_mesh

        out["arms"] = {tag: _tp_arm(tag, kernels, batches, inits, make_mesh(**arm[2]))
                       for tag, arm in TP_ARMS.items()}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def tp_kernels():
    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca
    from r3d_tpu_torch.ops import fuser_kernel as fk
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    return [fk.KERNEL, fk.TAIL_KERNEL, fkb.KERNEL, att.KERNEL, att.DROPOUT_KERNEL, att.BWD_KERNEL,
            att.KERNEL_BF16, att.DROPOUT_KERNEL_BF16, att.BWD_KERNEL_BF16, ca.FWD_KERNEL_FP32,
            ca.BWD_KERNEL_FP32]


@contextlib.contextmanager
def _attention_shapes(seen):
    """Within: every attention route a layer calls records (route, heads,
    channels a head times heads) into ``seen``."""
    from r3d_tpu_torch.models import layers

    saved = layers.flash_attention, layers.flash_attention_dropout, layers.cross_attention_native

    def spy(route, fn, native=False):
        def call(*a):
            q = a[0]
            seen.add((route, a[7], q.shape[-1]) if native else (route, q.shape[1],
                                                                q.shape[1] * q.shape[-1]))
            return fn(*a)
        return call

    layers.flash_attention = spy("K3", saved[0])
    layers.flash_attention_dropout = spy("K4", saved[1])
    layers.cross_attention_native = spy("K6", saved[2], native=True)
    try:
        yield
    finally:
        (layers.flash_attention, layers.flash_attention_dropout,
         layers.cross_attention_native) = saved


def _tp_arm(tag, kernels, batches, inits, mesh=None):
    """One ``TP_ARMS`` arm on ``mesh`` (None: one process): the dropout-off
    steps (their losses, times, launches, the attention shapes, the whole
    final state), then, for the tp arms on a mesh, the dropout steps
    (losses, whether every tensor is finite, this rank's replicated
    tensors)."""
    import dataclasses
    import os

    import torch

    from r3d_tpu_torch.models import futr_unsupervised
    from r3d_tpu_torch.parallel.mesh import shard_state, whole_model_state
    from r3d_tpu_torch.train.loop import Trainer

    key, batch_key, _, dropout, native, epoch = TP_ARMS[tag]
    cfg = tp_configs()[key]
    before = os.environ.get("R3D_CROSS_NATIVE")
    if native:
        os.environ["R3D_CROSS_NATIVE"] = "1"
    saved, futr_unsupervised.SRC_DROPOUT = futr_unsupervised.SRC_DROPOUT, 0.0
    try:
        res = {}
        for drop in ((0.0, 0.1) if dropout and mesh is not None else (0.0,)):
            c = cfg.replace(model=dataclasses.replace(cfg.model, dropout=drop,
                                                      fuser_dropout=drop)) if drop else cfg
            trainer = Trainer(c, tp_classes(key), mesh=mesh)
            state = trainer.init_state(1, inits[key])
            if mesh is not None:
                state = shard_state(state, mesh)
            n = TP_DROPOUT_STEPS if drop else TP_STEPS
            steps = (batches[batch_key] * n)[:n]
            seen = set()
            for k in kernels:
                k.launches = 0
            with _attention_shapes(seen):
                losses, times = _tp_steps(trainer, state, steps, epoch, seed_dropout=drop > 0)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in kernels}
            whole = {k: v.detach().cpu() for k, v in whole_model_state(state.model).items()}
            placed = getattr(state.model, "placement", {})
            r = dict(losses=losses, times=times, launches=launches, seen=sorted(seen),
                     finite=all(bool(torch.isfinite(v).all()) for v in whole.values()
                                if v.is_floating_point()),
                     sliced=len(placed))
            if drop:
                r["replicated"] = {k: v.detach().cpu() for k, v in state.model.state_dict().items()
                                   if k not in placed}
            else:
                r["state"] = whole
            res["on" if drop else "off"] = r
        return res
    finally:
        futr_unsupervised.SRC_DROPOUT = saved
        if before is None:
            os.environ.pop("R3D_CROSS_NATIVE", None)
        else:
            os.environ["R3D_CROSS_NATIVE"] = before


def tensor_parallel(kernels, card):
    """Phase 22: see the module docstring. Returns each kernel's launches
    on the two ranks' arms (both ranks summed) and the tp-shape checks'
    errors."""
    import os
    import shutil

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    shapes = check_tp_shapes(torch.Generator().manual_seed(SEED + 22), torch.device("cuda"))
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, TP_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    try:
        cfgs = tp_configs()
        batches = tp_batches(cfgs)
        inits = tp_inits(cfgs)
        torch.save(batches, os.path.join(work, "batches.pt"))
        torch.save(inits, os.path.join(work, "inits.pt"))
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_tp_rank, args=(r, 2, work), daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        # while the ranks start: one process on the same card
        one = {tag: _tp_arm(tag, kernels, batches, inits) for tag in TP_ARMS}
        for p in procs:
            p.join(max(1.0, TP_TIMEOUT - (time.perf_counter() - t0)))
        errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
                  if f.endswith(".err")]
        if any(p.is_alive() or p.exitcode != 0 for p in procs) or errors:
            raise AssertionError(f"tensor_parallel: a gloo rank failed: exit codes "
                                 f"{[p.exitcode for p in procs]} {errors}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        t_ranks = time.perf_counter() - t0
        print(f"tp [{card}]: gloo collectives on CUDA tensors in torch {torch.__version__}: "
              f"{ranks[0]['gloo']}")
        total = {k.name: 0 for k in kernels}
        for tag, (key, _, sizes, dropout, native, epoch) in TP_ARMS.items():
            lr = tp_configs()[key].train.lr
            got = [r["arms"][tag] for r in ranks]
            want = one[tag]["off"]
            bf16 = tp_configs()[key].model.compute_dtype == "bfloat16"
            tol = TP_BF16_LOSS_TOL if bf16 else DP_LOSS_TOL
            loss_err = max(abs(a - b) / max(1.0, abs(b))
                           for a, b in zip(got[0]["off"]["losses"], want["losses"]))
            bad = _close_states(got[0]["off"]["state"], want["state"], lr, TP_STEPS,
                                share=not bf16)
            split = [k for k in want["state"] if not torch.equal(got[0]["off"]["state"][k],
                                                                 got[1]["off"]["state"][k])]
            line = (f"tp [{card}]: {tag} (epoch {epoch}), {TP_STEPS} steps on 2 gloo ranks vs one "
                    f"process: max|loss diff| / max(1, |loss|) {loss_err:.3e} (tol {tol}), "
                    f"losses {got[0]['off']['losses']} vs {want['losses']}; {len(bad)} of "
                    f"{len(want['state'])} final tensors outside the fit bounds {bad[:3]}; the "
                    f"ranks' whole states differ in {len(split)} tensors; each rank holds "
                    f"{got[0]['off']['sliced']} sliced tensors")
            print(line)
            if loss_err > tol or bad or split or not got[0]["off"]["finite"]:
                raise AssertionError(f"tensor_parallel: {tag} disagrees with one process")
            for r, g in enumerate(got):
                launched = {n: sum(part["launches"].get(n, 0) for part in g.values())
                            for n in total}
                seen = sorted({s for part in g.values() for s in part["seen"]})
                print(f"tp [{card}]: {tag}: gloo rank {r}: launches "
                      f"{ {n: c for n, c in launched.items() if c} }; attention calls (route, "
                      f"heads, channels) {seen}; median step "
                      f"{1e3 * float(np.median(g['off']['times'][1:])):.2f} ms (one process "
                      f"{1e3 * float(np.median(want['times'][1:])):.2f}; the first step "
                      f"aside)")
                for n, c in launched.items():
                    total[n] += c
                if sizes.get("tp", 1) > 1:
                    heads = {s[1] for s in seen}
                    if heads != {4}:
                        raise AssertionError(f"tensor_parallel: {tag}: rank {r}'s attention "
                                             f"ran on {heads} heads, not 4 of 8")
                    routes = {s[0] for s in seen}
                    need = {"K6"} if native else {"K3", "K4"}
                    if not need <= routes:
                        raise AssertionError(f"tensor_parallel: {tag}: rank {r} took routes "
                                             f"{routes}, not {need}")
            if dropout:
                on = [g["on"] for g in got]
                rep = [k for k in on[0]["replicated"] if not torch.equal(
                    on[0]["replicated"][k], on[1]["replicated"][k])]
                print(f"tp [{card}]: {tag}: {TP_DROPOUT_STEPS} steps with dropout 0.1: losses "
                      f"{on[0]['losses']}, finite {on[0]['finite'] and on[1]['finite']}; the tp "
                      f"ranks' replicated tensors differ in {len(rep)} of "
                      f"{len(on[0]['replicated'])}")
                if rep or not (on[0]["finite"] and on[1]["finite"]):
                    raise AssertionError(f"tensor_parallel: {tag} with dropout: replicas "
                                         f"differ {rep[:5]} or a value is not finite")
        print(f"tp [{card}]: 2 gloo ranks, {len(TP_ARMS)} arms, {t_ranks:.1f} s with their "
              f"start; the tensor_parallel phase took {time.perf_counter() - t_phase:.1f} s")
        return total, shapes
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


SP_DIR = "build/sp_phase"   # under the checkout (git-ignored), removed after the phase
SP_TIMEOUT = 300            # s: a rank or a collective that takes longer fails the phase
SP_ROWS_2000 = 4            # rows of the futr arms' 2000-bucket batch (50salads widths)
SP_BUCKETS_2000 = (1024, 2000)   # the futr arms' buckets: their windows of 1,560-1,920 frames
SP_EVAL_TOL = SALADS_E2E_TOL     # the futr eval forward's action and duration outputs, two
                                 # ranks vs one process: the ring (fp32 scores of bf16 q, k, v)
                                 # against bf16 K3 on the whole sequence
# arm -> (config, dropout, R3D_CROSS_NATIVE, the epochs of its steps (one batch each, from
# the same init), the kernels each rank must launch in it)
SP_ARMS = {
    "utkinects sp 2, 512: epoch 0 with dropout 0.1, then the sticky epoch": (
        "utk", 0.1, False, (0, 1),
        ("fused_safuser_tail", "fused_bn_blend_tail", "fused_tail_bwd", "flash_attention",
         "flash_attention_dropout", "attention_bwd")),
    "futr (50salads widths, 2 encoder layers) sp 2, 2000, dropout off: the ring": (
        "futr", 0.0, False, (0,), ()),
    "futr sp 2, 2000, dropout 0.1: the encoder's attention gathered": (
        "futr", 0.1, False, (0,), ("flash_attention_dropout_bf16_many",
                                   "attention_bwd_bf16_many")),
    "futr sp 2, 2000, dropout off, R3D_CROSS_NATIVE=1: the ring, K6/K7 in the decoder": (
        "futr", 0.0, True, (0,), ("cross_attention", "cross_attention_bwd")),
}


def sp_configs():
    """(utk) utkinects at full width: K1 no-blend and K4 in epoch 0, K1
    blend and K3 in the sticky epoch, K3-K5 in the decoder over the 512
    gathered keys; (futr) futr at 50salads widths (bf16, hidden 512, 8
    heads, 20 queries, 2 decoder layers) with its 2 encoder layers, in
    ``SP_BUCKETS_2000``."""
    import dataclasses

    from r3d_tpu_torch.config import get_config

    salads = get_config("50salads")
    futr = salads.replace(
        model=dataclasses.replace(salads.model, use_encoder=True),
        data=dataclasses.replace(salads.data, seq_buckets=SP_BUCKETS_2000))
    return dict(utk=get_config("utkinects"), futr=futr)


def sp_config(key, dropout):
    import dataclasses

    cfg = sp_configs()[key]
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=dropout,
                                                 fuser_dropout=dropout))


def sp_classes(key):
    return N_CLASS if key == "utk" else SALADS_CLASSES


def sp_batches(cfgs):
    """utkinects' first two 512-bucket batches of 8; futr's 2000-bucket
    batch of ``SP_ROWS_2000`` (synthetic 50salads videos of 2,600-3,200
    frames observed at 0.6)."""
    utk = _dp_batches(cfgs["utk"])[:2]
    _, loader, _ = train_loaders(cfgs["futr"], n_class=SALADS_CLASSES, n_videos=6,
                                 vid_len_range=(2600, 3200), obs=(0.6,), val_videos=1,
                                 val_obs=(0.6,), val_batch=1)
    futr = [one_batch(loader, 1024, 2000, rows=SP_ROWS_2000)]
    for key, got, want in (("utk", utk[0], 512), ("futr", futr[0], 2000)):
        if got["features"].shape[1] != want:
            raise AssertionError(f"sequence_parallel: the {key} batch fell in bucket "
                                 f"{got['features'].shape[1]}, not {want}")
    return dict(utk=utk, futr=futr)


def sp_inits(cfgs):
    """The seeded init of each config's model (the same in every process)."""
    import torch

    from r3d_tpu_torch.models import build_model, init_weights

    return {k: init_weights(build_model(c.model, sp_classes(k), c.data.depth_shape),
                            torch.Generator().manual_seed(SEED)).state_dict()
            for k, c in cfgs.items()}


@contextlib.contextmanager
def _sp_spy(seen):
    """Within: each sequence-parallel self-attention records its route
    (``ring`` with its rank's queries, or ``gathered``: the whole call on
    its inputs gathered over sp), each attention kernel call its (route,
    queries, keys), and each fuser tail its rows, into ``seen``."""
    from r3d_tpu_torch.models import fuser, layers

    names = ((layers, "ring_attention"), (layers, "cut_seq"), (layers, "flash_attention"),
             (layers, "flash_attention_dropout"), (layers, "cross_attention_native"),
             (fuser, "fused_safuser_tail"), (fuser, "fused_bn_blend_tail"))
    record = {
        "ring_attention": lambda a: ("ring", a[0].shape[2]),
        "cut_seq": lambda a: ("gathered", a[0].shape[1]),   # the whole call's output
        "flash_attention": lambda a: ("K3", a[0].shape[2], a[1].shape[2]),
        "flash_attention_dropout": lambda a: ("K4", a[0].shape[2], a[1].shape[2]),
        "cross_attention_native": lambda a: ("K6", a[0].shape[1], a[1].shape[1]),
        "fused_safuser_tail": lambda a: ("K1 no-blend rows", a[0].shape[0]),
        "fused_bn_blend_tail": lambda a: ("K1 blend rows", a[0].shape[0])}
    saved = [getattr(mod, n) for mod, n in names]

    def spy(n, fn):
        def call(*a):
            seen.add(record[n](a))
            return fn(*a)
        return call

    for (mod, n), fn in zip(names, saved):
        setattr(mod, n, spy(n, fn))
    try:
        yield
    finally:
        for (mod, n), fn in zip(names, saved):
            setattr(mod, n, fn)


def _sp_rank_faults(arm, launched, seen, shape):
    """What a rank's run of ``arm`` on a batch of ``shape`` (B, S) did that
    the arm's path does not: a kernel of it never launched; the encoder's
    self-attention (futr) not the ring on the rank's S/2 queries, or with
    dropout not the whole call over the S gathered frames; utkinects' fuser
    tail not on its B S/2 rows, or its decoder's K3/K4 not over the S
    gathered keys; K6 (under R3D_CROSS_NATIVE=1) not over them. [] where
    none."""
    key, drop, native, _, need = arm
    B, S = shape
    wrong = [f"never launched {n}" for n in need if launched.get(n, 0) == 0]
    routes = {x for x in seen if x[0] in ("ring", "gathered")}
    want = (set() if key == "utk" else {("gathered", S)} if drop else {("ring", S // 2)})
    if routes != want:
        wrong.append(f"took {routes}, not {want}")
    if key == "utk":
        rows = {x[1] for x in seen if x[0].startswith("K1")}
        keys = {x[2] for x in seen if x[0] in ("K3", "K4")}
        if rows != {B * S // 2} or keys != {S}:
            wrong.append(f"fuser rows {rows}, decoder keys {keys}")
    if native and {x[2] for x in seen if x[0] == "K6"} != {S}:
        wrong.append(f"K6 calls not over the {S} gathered keys: {seen}")
    return wrong


P2P_OPS = ("send_recv", "batch_isend_irecv")
P2P_TIMEOUT = 90   # s: a pair of probe processes still running then is killed and recorded so


def _p2p_probe_rank(rank, op, work):
    """One rank of a throwaway pair: ``op`` (``P2P_OPS``) of a CUDA tensor
    over gloo; writes "ok" or the error's first line to ``work``."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/{op}.store", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=P2P_TIMEOUT // 2))
    x = torch.ones(4, device="cuda")
    peer = 1 - rank
    try:
        if op == "send_recv":
            (dist.send(x, dst=peer) if rank == 0 else dist.recv(torch.empty_like(x), src=peer))
        else:
            ops = [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, torch.empty_like(x), peer)]
            for w in dist.batch_isend_irecv(ops if rank == 0 else ops[::-1]):
                w.wait()
        torch.cuda.synchronize()
        out = "ok"
    except Exception as e:   # noqa: BLE001 -- the answer recorded is the error itself
        out = str(e).splitlines()[0][:120]
    with open(os.path.join(work, f"{op}.rank{rank}"), "w") as f:
        f.write(out)
    os._exit(0)


def gloo_p2p_probe(work):
    """Whether gloo carries point-to-point calls of CUDA tensors, the ring's
    transport (``ops/ring_attention.py``): {op: each rank's answer, "ok",
    the error's first line, or how its process ended}. Each op runs in a
    pair of throwaway processes: in this probe's first run (torch 2.11, an
    H100 machine) gloo aborted the process that sent a CUDA tensor
    (``gloo::IoException``, ``tcp/pair.cc`` ``writev``: Bad address), which
    would have ended any rank that tried. A probe, not an arm: it only
    records."""
    import os

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = {(op, r): ctx.Process(target=_p2p_probe_rank, args=(r, op, work), daemon=True)
             for op in P2P_OPS for r in range(2)}
    t0 = time.perf_counter()
    for p in procs.values():
        p.start()
    out = {}
    for (op, r), p in procs.items():
        p.join(max(1.0, P2P_TIMEOUT - (time.perf_counter() - t0)))
        if p.is_alive():
            p.kill()
            p.join()
        path = os.path.join(work, f"{op}.rank{r}")
        out.setdefault(op, []).append(open(path).read() if os.path.exists(path) else
                                      f"the process ended with exit code {p.exitcode}")
    return out


def sp_kernels():
    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca

    return tp_kernels() + [att.KERNEL_BF16_MANY, att.DROPOUT_KERNEL_BF16_MANY,
                           att.BWD_KERNEL_BF16_MANY, ca.FWD_KERNEL, ca.BWD_KERNEL]


def _sp_arm(tag, kernels, batches, inits, mesh=None):
    """One ``SP_ARMS`` arm on ``mesh`` (None: one process on the card): its
    steps from the init after the trainer seeds dropout, each with the
    counts set to 0 before and read after, the routes and shapes seen, its
    loss, wall time and the peak bytes allocated in this process; the whole
    final state."""
    import os

    import torch

    from r3d_tpu_torch.parallel.mesh import shard_state, whole_model_state
    from r3d_tpu_torch.train.loop import Trainer

    key, drop, native, epochs, _ = SP_ARMS[tag]
    before = os.environ.get("R3D_CROSS_NATIVE")
    if native:
        os.environ["R3D_CROSS_NATIVE"] = "1"
    try:
        trainer = Trainer(sp_config(key, drop), sp_classes(key), mesh=mesh)
        state = trainer.init_state(1, inits[key])
        if mesh is not None:
            state = shard_state(state, mesh)
        trainer._seed_dropout(state, SEED, 0)
        steps = []
        for i, epoch in enumerate(epochs):
            seen = set()
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _sp_spy(seen):
                metrics = trainer.train_step(state, batches[key][i % len(batches[key])], epoch)
                loss = trainer._to_host({"loss": metrics["loss"]})["loss"]
            torch.cuda.synchronize()
            steps.append(dict(loss=loss, ms=1e3 * (time.perf_counter() - t0),
                              peak=torch.cuda.max_memory_allocated(),
                              launches={k.name: k.launches for k in kernels}, seen=sorted(seen)))
        whole = {k: v.detach().cpu() for k, v in whole_model_state(state.model).items()}
        return dict(steps=steps, state=whole,
                    finite=all(bool(torch.isfinite(v).all()) for v in whole.values()
                               if v.is_floating_point()))
    finally:
        os.environ.pop("R3D_CROSS_NATIVE", None)
        if before is not None:
            os.environ["R3D_CROSS_NATIVE"] = before


def _sp_eval(batches, inits, mesh=None):
    """futr's module-eval forward of its 2000-bucket batch with the pad mask
    (the ring on each rank): the action and duration outputs, the routes
    seen, the wall time and the peak bytes allocated in this process."""
    import torch

    from r3d_tpu_torch.parallel.mesh import take_rows, take_seq
    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(sp_config("futr", 0.0), SALADS_CLASSES, mesh=mesh)
    state = trainer.init_state(1, inits["futr"])
    model = state.model.eval()
    batch = batches["futr"][0]
    rows = trainer._rows(batch["features"].shape[0])
    seq = trainer._seq(batch["features"].shape[1])
    seen = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad(), trainer._split(rows, seq), _sp_spy(seen):
        out = model(*trainer._model_inputs(
            trainer.to_device(take_seq(take_rows(batch, rows), seq)), with_mask=True))
        got = {k: out[k].float().cpu() for k in ("action", "duration")}
    return dict(out=got, seen=sorted(seen), ms=1e3 * (time.perf_counter() - t0),
                peak=torch.cuda.max_memory_allocated())


def _sp_rank(rank, world, work):
    """One gloo rank on the card (``cuda:0``, shared), on dp 1 x sp 2: every
    ``SP_ARMS`` arm and the eval forward; writes its results to
    ``work/rank{rank}.pt``."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=SP_TIMEOUT))
        from r3d_tpu_torch.parallel.mesh import make_mesh

        kernels = sp_kernels()
        batches = torch.load(os.path.join(work, "batches.pt"), weights_only=True)
        inits = torch.load(os.path.join(work, "inits.pt"), weights_only=True)
        mesh = make_mesh(dp=1, sp=world)
        out = {"arms": {tag: _sp_arm(tag, kernels, batches, inits, mesh) for tag in SP_ARMS},
               "eval": _sp_eval(batches, inits, mesh)}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def sequence_parallel(kernels, card):
    """Phase 23: see the module docstring. Returns each kernel's launches
    on the two ranks' arms (both ranks summed) and each rank's peak bytes
    against one process's in the futr arms."""
    import os
    import shutil

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, SP_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    try:
        cfgs = sp_configs()
        batches = sp_batches(cfgs)
        inits = sp_inits(cfgs)
        torch.save(batches, os.path.join(work, "batches.pt"))
        torch.save(inits, os.path.join(work, "inits.pt"))
        p2p = gloo_p2p_probe(work)
        print(f"sp [{card}]: gloo point-to-point calls of CUDA tensors in torch "
              f"{torch.__version__} (rank 0, rank 1): {p2p}; the ring's hop on gloo with CUDA "
              f"tensors is one all_gather_into_tensor (ops/ring_attention.py)")
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_sp_rank, args=(r, 2, work), daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        # while the ranks start: one process on the same card
        one = {tag: _sp_arm(tag, kernels, batches, inits) for tag in SP_ARMS}
        one_eval = _sp_eval(batches, inits)
        for p in procs:
            p.join(max(1.0, SP_TIMEOUT - (time.perf_counter() - t0)))
        errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
                  if f.endswith(".err")]
        if any(p.is_alive() or p.exitcode != 0 for p in procs) or errors:
            raise AssertionError(f"sequence_parallel: a gloo rank failed: exit codes "
                                 f"{[p.exitcode for p in procs]} {errors}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        t_ranks = time.perf_counter() - t0
        total = {k.name: 0 for k in kernels}
        peaks = {}
        for tag, (key, drop, native, epochs, need) in SP_ARMS.items():
            lr = cfgs[key].train.lr
            got = [r["arms"][tag] for r in ranks]
            want = one[tag]
            bf16 = cfgs[key].model.compute_dtype == "bfloat16"
            tol = TP_BF16_LOSS_TOL if bf16 else DP_LOSS_TOL
            loss_err = max(abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"]))
                           for a, b in zip(got[0]["steps"], want["steps"]))
            bad = _close_states(got[0]["state"], want["state"], lr, len(epochs), share=not bf16)
            split = [k for k in want["state"] if not torch.equal(got[0]["state"][k],
                                                                 got[1]["state"][k])]
            print(f"sp [{card}]: {tag}: {len(epochs)} steps on 2 gloo ranks (dp 1 x sp 2) vs "
                  f"one process: max|loss diff| / max(1, |loss|) {loss_err:.3e} (tol {tol}), "
                  f"losses {[s['loss'] for s in got[0]['steps']]} vs "
                  f"{[s['loss'] for s in want['steps']]}; {len(bad)} of {len(want['state'])} "
                  f"final tensors outside the fit bounds {bad[:3]}; the ranks' whole states "
                  f"differ in {len(split)} tensors")
            if loss_err > tol or bad or split or not (got[0]["finite"] and got[1]["finite"]):
                raise AssertionError(f"sequence_parallel: {tag} disagrees with one process")
            for r, g in enumerate(got):
                launched = {n: sum(s["launches"].get(n, 0) for s in g["steps"]) for n in total}
                seen = sorted({x for s in g["steps"] for x in s["seen"]})
                print(f"sp [{card}]: {tag}: gloo rank {r}: launches "
                      f"{ {n: c for n, c in launched.items() if c} }; routes and shapes {seen}; "
                      f"step ms {[round(s['ms'], 2) for s in g['steps']]} (one process "
                      f"{[round(s['ms'], 2) for s in want['steps']]}); peak allocated bytes "
                      f"{[s['peak'] for s in g['steps']]} (one process "
                      f"{[s['peak'] for s in want['steps']]})")
                for n, c in launched.items():
                    total[n] += c
                wrong = _sp_rank_faults(SP_ARMS[tag], launched, seen,
                                        batches[key][0]["features"].shape[:2])
                if wrong:
                    raise AssertionError(f"sequence_parallel: {tag}: rank {r}: {wrong}")
            if key == "futr":
                peaks[tag] = ([g["steps"][0]["peak"] for g in got], want["steps"][0]["peak"])
        ev = [r["eval"] for r in ranks]
        err = max(float((e["out"][k] - one_eval["out"][k]).abs().max())
                  for e in ev for k in one_eval["out"])
        print(f"sp [{card}]: {SP_ROWS_2000} x 2000 futr eval forward, 2 ranks vs one process: "
              f"max|output diff| {err:.3e} (tol {SP_EVAL_TOL}); routes {ev[0]['seen']} (one "
              f"process {one_eval['seen']}); ms {[round(e['ms'], 2) for e in ev]} (one process "
              f"{one_eval['ms']:.2f}); peak allocated bytes {[e['peak'] for e in ev]} (one "
              f"process {one_eval['peak']})")
        ring = ("ring", batches["futr"][0]["features"].shape[1] // 2)
        if not err <= SP_EVAL_TOL or ring not in ev[0]["seen"]:
            raise AssertionError("sequence_parallel: the futr eval forward disagrees")
        peaks["eval"] = ([e["peak"] for e in ev], one_eval["peak"])
        print(f"sp [{card}]: 2 gloo ranks, {len(SP_ARMS)} arms and the eval forward, "
              f"{t_ranks:.1f} s with their start; the sequence_parallel phase took "
              f"{time.perf_counter() - t_phase:.1f} s")
        return total, peaks
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


# --------------------------- phase 24: sequence parallelism for every family

SPF_DIR = "build/spf_phase"   # under the checkout (git-ignored), removed after the phase
SPF_ROWS = 4                  # rows of each arm's batch
SPF_PROPOSED_QUERIES = 19     # 50salads_proposed's L2 query ids (query_num 20 with the pad)
SPF_GAZE_ROWS = (1200, 1900)  # the gaze stream's true rows, padded to the 2000 bucket
# arm -> (config, dropout, R3D_CROSS_NATIVE, the epochs of its steps (one batch, from the
# same init), its route, the kernels each rank must launch in it)
SPF_ARMS = {
    "50salads_proposed sp 2, 3100, dropout 0.1: the decoder's S queries gathered": (
        "proposed", 0.1, False, (0,), "host",
        ("flash_attention_dropout_bf16_many", "attention_bwd_bf16_many")),
    "darai sp 2, 512, SupCon on: epoch 0 with dropout 0.1, then epoch 2, host route": (
        "darai", 0.1, False, (0, 2), "host",
        ("flash_attention", "flash_attention_dropout", "attention_bwd")),
    "darai sp 2, 512, SupCon on: the same steps on the cached route": (
        "darai", 0.1, False, (0, 2), "cached",
        ("flash_attention", "flash_attention_dropout", "attention_bwd")),
    "darai --model futr_unsupervised_depth sp 2, 512: epoch 0, then epoch 2 (the ring)": (
        "depth", 0.1, False, (0, 2), "host",
        ("flash_attention_many", "flash_attention_dropout_many", "attention_bwd_many")),
    "darai_gaze sp 2, 2000, R3D_CROSS_NATIVE=1: the gaze stream cut": (
        "gaze", 0.1, True, (0,), "host", ("cross_attention_fp32", "cross_attention_bwd_fp32")),
    "50salads MoE, 1 encoder layer, sp 2, 3100, dropout 0.1, R3D_CROSS_NATIVE=1": (
        "moe", 0.1, True, (0,), "host",
        ("flash_attention_dropout_bf16_many", "attention_bwd_bf16_many", "cross_attention",
         "cross_attention_bwd")),
    "50salads MoE, 1 encoder layer, sp 2, 512, dropout off: the ring": (
        "moe512", 0.0, False, (0,), "host", ("flash_attention_bf16", "attention_bwd_bf16")),
    "nturgbd --model rnn sp 2, 512": ("rnn", 0.0, False, (0,), "host", ()),
    "nturgbd --model tcn sp 2, 512": ("tcn", 0.0, False, (0,), "host", ()),
}


def spf_configs():
    """The phase's configs at full width: 50salads_proposed (bf16, hidden
    512, the proposed loop); darai (futr_unsupervised, fp32, hidden 128,
    the unsupervised loop with SupCon on, ``DARAI_TP``) and its depth
    source; darai_gaze (its gaze stream padded to the 2000 bucket); 50salads
    with MoE (``MOE``) and one encoder layer; nturgbd's rnn and tcn (input
    2,048, hidden 128, bf16 batches) without the depth stream."""
    import dataclasses

    from r3d_tpu_torch.config import get_config

    def with_model(cfg, **kw):
        return cfg.replace(model=dataclasses.replace(cfg.model, **kw))

    darai = get_config("darai")
    darai = darai.replace(train=dataclasses.replace(darai.train, **DARAI_TP))
    moe = with_model(get_config("50salads"), use_encoder=True, n_encoder_layers=1, **MOE)
    ntu = get_config("nturgbd")
    ntu = ntu.replace(data=dataclasses.replace(ntu.data, depth_features_dir=None))
    return dict(
        proposed=get_config("50salads_proposed"), darai=darai,
        depth=with_model(darai, model=DEPTH_MODEL), gaze=get_config("darai_gaze"), moe=moe,
        moe512=moe,
        rnn=ntu.replace(model=dataclasses.replace(ntu.model, model="rnn"),
                        train=dataclasses.replace(ntu.train, loop="unimodal")),
        tcn=ntu.replace(model=dataclasses.replace(ntu.model, model="tcn"),
                        train=dataclasses.replace(ntu.train, loop="tcn")))


def spf_config(key, dropout):
    import dataclasses

    cfg = spf_configs()[key]
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=dropout))


def spf_classes(key):
    return {"proposed": 6, "darai": DARAI_CLASSES, "depth": DARAI_CLASSES,
            "gaze": DARAI_CLASSES, "rnn": NTU_CLASSES, "tcn": NTU_CLASSES}.get(key, SALADS_CLASSES)


def spf_darai_source(cfg):
    """darai's synthetic videos (10 actions, 47 L3 labels padded with 47,
    600-1,000 frames; observed at 0.5 they fall in the 512 bucket): the same
    in every process."""
    from r3d_tpu_torch.data.synthetic import SyntheticSource

    return SyntheticSource(n_videos=6, n_actions=DARAI_CLASSES - 1, vid_len_range=(600, 1000),
                           input_dim=cfg.model.input_dim, n_query_classes=cfg.train.l3_pad_idx,
                           seed=SEED)


def spf_batches(cfgs):
    """Each arm's host batch of ``SPF_ROWS`` rows (``rnn``/``tcn``: 8):
    50salads_proposed's and MoE's in the 3100 bucket (synthetic 50salads
    videos of 2,600-3,800 frames observed at 0.8, with an L2 query stream
    for the former) and MoE's in the 512; darai's first 4 views in the 512
    (their view ids too, for the cached route); darai_gaze's in the 2000
    with a synthetic normalised gaze stream of ``SPF_GAZE_ROWS`` rows;
    nturgbd's in the 512."""
    import torch

    from r3d_tpu_torch.data.pipeline import BucketedLoader, pad_batch
    from r3d_tpu_torch.data.synthetic import SyntheticSource

    out = {}
    p = cfgs["proposed"]
    src = SyntheticSource(n_videos=6, n_actions=spf_classes("proposed") - 1,
                          vid_len_range=(2600, 3800), input_dim=p.model.input_dim,
                          n_query_classes=SPF_PROPOSED_QUERIES, seed=SEED)
    fn, n = src.make_example_fn((0.8,), 1, p.model.n_query)
    loader = BucketedLoader(num_examples=n, make_example_fn=fn, batch_size=SPF_ROWS,
                            pad_idx=src.pad_idx, buckets=p.data.seq_buckets,
                            n_query=p.model.n_query, with_query=True,
                            query_pad_idx=SPF_PROPOSED_QUERIES, shuffle=False,
                            feature_dtype=p.data.feature_dtype)
    out["proposed"] = one_batch(loader, 1024, rows=SPF_ROWS)
    d = cfgs["darai"]
    src = spf_darai_source(d)
    fn, _ = src.make_example_fn((0.5,), 1, d.model.n_query)
    ids = list(range(SPF_ROWS))
    out["darai"] = pad_batch([fn(j) for j in ids], src.pad_idx, d.data.seq_buckets,
                             d.model.n_query, with_query=True,
                             query_pad_idx=d.train.l3_pad_idx)
    out["darai_ids"] = torch.tensor(ids)
    out["depth"] = out["darai"]
    g = cfgs["gaze"]
    _, loader, _ = train_loaders(g, n_class=DARAI_CLASSES, n_videos=6,
                                 vid_len_range=(2600, 3300), obs=(0.6,), val_videos=1,
                                 val_obs=(0.6,), val_batch=1)
    gaze = dict(one_batch(loader, 1024, rows=SPF_ROWS))
    rng = np.random.default_rng(SEED + 24)
    S = gaze["features"].shape[1]
    lens = rng.integers(*SPF_GAZE_ROWS, size=SPF_ROWS)
    q = rng.uniform(0.0, 2.0, (SPF_ROWS, S, 2)).astype(np.float32)
    q[np.arange(S)[None, :] >= lens[:, None]] = 0.0
    gaze.update(query_label=torch.from_numpy(q), query_len=torch.from_numpy(lens.astype(np.int32)))
    out["gaze"] = gaze
    _, loader, _ = train_loaders(cfgs["moe"], n_class=SALADS_CLASSES, n_videos=6,
                                 vid_len_range=(2600, 3800), obs=(0.13, 0.8), val_videos=1,
                                 val_obs=(0.8,), val_batch=1)
    out["moe"] = one_batch(loader, 1024, rows=SPF_ROWS)
    out["moe512"] = one_batch(loader, 256, 512, rows=SPF_ROWS)
    for key in ("rnn", "tcn"):
        _, loader, _ = train_loaders(cfgs[key], n_class=NTU_CLASSES, n_videos=8, obs=(0.5,),
                                     val_videos=1, val_obs=(0.5,), val_batch=1)
        out[key] = one_batch(loader, 256, 512)
    for key, want in (("proposed", 3100), ("darai", 512), ("gaze", 2000), ("moe", 3100),
                      ("moe512", 512), ("rnn", 512), ("tcn", 512)):
        if out[key]["features"].shape[1] != want:
            raise AssertionError(f"sequence_parallel_families: the {key} batch fell in bucket "
                                 f"{out[key]['features'].shape[1]}, not {want}")
    return out


def spf_inits(cfgs):
    """The seeded init of each config's model (the same in every process)."""
    import torch

    from r3d_tpu_torch.models import build_model, init_weights

    return {k: init_weights(build_model(c.model, spf_classes(k)),
                            torch.Generator().manual_seed(SEED)).state_dict()
            for k, c in cfgs.items()}


def _spf_arm(tag, kernels, batches, inits, mesh=None):
    """One ``SPF_ARMS`` arm on ``mesh`` (None: one process on the card): its
    steps from the init after the trainer seeds dropout, each with the
    counts set to 0 before and read after, the routes and shapes seen, its
    loss, wall time and the peak bytes allocated in this process; the whole
    final state."""
    import os

    import torch

    from r3d_tpu_torch.data import device_cache as dc
    from r3d_tpu_torch.parallel.mesh import shard_state, whole_model_state
    from r3d_tpu_torch.train.loop import Trainer

    key, drop, native, epochs, route, _ = SPF_ARMS[tag]
    before = os.environ.get("R3D_CROSS_NATIVE")
    if native:
        os.environ["R3D_CROSS_NATIVE"] = "1"
    try:
        cfg = spf_config(key, drop)
        trainer = Trainer(cfg, spf_classes(key), mesh=mesh)
        state = trainer.init_state(1, inits[key])
        if mesh is not None:
            state = shard_state(state, mesh)
        trainer._seed_dropout(state, SEED, 0)
        batch = trainer._with_seg_ids(batches[key])
        if route == "cached":
            src = spf_darai_source(cfg)
            videos = [{"features": v["features"],
                       "label_idx": np.array([src.actions_dict[l] for l in v["labels"]]),
                       "query_idx": np.array([src.query_dict[q] for q in v["query"]])}
                      for v in src.videos]
            cache = dc.build_cache(videos, (0.5,), 1, cfg.model.n_query, src.pad_idx,
                                   src.n_class, cfg.data.seq_buckets,
                                   query_pad_idx=cfg.train.l3_pad_idx)
            cached_step = trainer.make_cached_train_fn(cache)
        steps = []
        for epoch in epochs:
            seen = set()
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _sp_spy(seen):
                if route == "cached":
                    B, S = batch["features"].shape[:2]
                    rows, seq = trainer._rows(B), trainer._seq(S)
                    idx = trainer._index_table([batches["darai_ids"].numpy()])
                    with trainer._split(rows, seq):
                        metrics = cached_step(state, cache.data, idx, S, epoch, seq)
                else:
                    metrics = trainer.train_step(state, batch, epoch)
                loss = trainer._to_host({"loss": metrics["loss"]})["loss"]
            torch.cuda.synchronize()
            steps.append(dict(loss=loss, ms=1e3 * (time.perf_counter() - t0),
                              peak=torch.cuda.max_memory_allocated(),
                              launches={k.name: k.launches for k in kernels}, seen=sorted(seen)))
        whole = {k: v.detach().cpu() for k, v in whole_model_state(state.model).items()}
        return dict(steps=steps, state=whole,
                    finite=all(bool(torch.isfinite(v).all()) for v in whole.values()
                               if v.is_floating_point()))
    finally:
        os.environ.pop("R3D_CROSS_NATIVE", None)
        if before is not None:
            os.environ["R3D_CROSS_NATIVE"] = before


def _spf_eval(kernels, batches, inits, mesh=None):
    """50salads_proposed's module-eval forward of its 3100-bucket batch with
    the pad mask (the decoder's self-attention the ring, its
    cross-attention the rank's query rows against the gathered keys): the
    action and duration outputs, the launches, the routes seen, the wall
    time and the peak bytes allocated in this process."""
    import torch

    from r3d_tpu_torch.parallel.mesh import take_rows, take_seq
    from r3d_tpu_torch.train.loop import Trainer

    trainer = Trainer(spf_config("proposed", 0.0), spf_classes("proposed"), mesh=mesh)
    state = trainer.init_state(1, inits["proposed"])
    model = state.model.eval()
    batch = batches["proposed"]
    rows = trainer._rows(batch["features"].shape[0])
    seq = trainer._seq(batch["features"].shape[1])
    seen = set()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad(), trainer._split(rows, seq), _sp_spy(seen):
        out = model(*trainer._model_inputs(
            trainer.to_device(take_seq(take_rows(batch, rows), seq)), with_mask=True))
        got = {k: out[k].float().cpu() for k in ("action", "duration")}
    torch.cuda.synchronize()
    return dict(out=got, seen=sorted(seen), ms=1e3 * (time.perf_counter() - t0),
                peak=torch.cuda.max_memory_allocated(),
                launches={k.name: k.launches for k in kernels})


def _spf_rank(rank, world, work):
    """One gloo rank on the card (``cuda:0``, shared), on dp 1 x sp 2: every
    ``SPF_ARMS`` arm and the eval forward; writes its results to
    ``work/rank{rank}.pt``."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=SP_TIMEOUT))
        from r3d_tpu_torch.parallel.mesh import make_mesh

        kernels = sp_kernels() + spf_kernels()
        batches = torch.load(os.path.join(work, "batches.pt"), weights_only=True)
        inits = torch.load(os.path.join(work, "inits.pt"), weights_only=True)
        mesh = make_mesh(dp=1, sp=world)
        out = {"arms": {tag: _spf_arm(tag, kernels, batches, inits, mesh) for tag in SPF_ARMS},
               "eval": _spf_eval(kernels, batches, inits, mesh)}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spf_kernels():
    """The kernels this phase's arms launch beyond ``sp_kernels``'."""
    from r3d_tpu_torch.ops import attention as att

    return [att.KERNEL_MANY, att.DROPOUT_KERNEL_MANY, att.BWD_KERNEL_MANY]


def _spf_routes(tag, seen, S):
    """What a rank's run of ``tag`` did that its path does not: the S-query
    decoders' attention with dropout not gathered over the S frames; their
    and the encoder's self-attention without dropout not the ring on the
    rank's S/2 queries. [] where none."""
    key, drop = SPF_ARMS[tag][:2]
    routes = {x for x in seen if x[0] in ("ring", "gathered")}
    want = set()
    if key in ("proposed", "depth", "moe") and drop:
        want.add(("gathered", S))
    if key in ("depth", "moe512"):   # the depth source's sticky epoch 2, MoE without dropout
        want.add(("ring", S // 2))
    return [] if routes == want else [f"took {sorted(routes)}, not {sorted(want)}"]


def sequence_parallel_families(kernels, card):
    """Phase 24: see the module docstring. Returns each kernel's launches
    on the two ranks' arms (both ranks summed) and each rank's peak bytes
    against one process's in each arm."""
    import os
    import shutil

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, SPF_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    try:
        cfgs = spf_configs()
        batches = spf_batches(cfgs)
        inits = spf_inits(cfgs)
        torch.save(batches, os.path.join(work, "batches.pt"))
        torch.save(inits, os.path.join(work, "inits.pt"))
        every = kernels + [k for k in spf_kernels() if k not in kernels]
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_spf_rank, args=(r, 2, work), daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        # while the ranks start: one process on the same card
        one = {tag: _spf_arm(tag, every, batches, inits) for tag in SPF_ARMS}
        one_eval = _spf_eval(every, batches, inits)
        for p in procs:
            p.join(max(1.0, SP_TIMEOUT - (time.perf_counter() - t0)))
        errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
                  if f.endswith(".err")]
        if any(p.is_alive() or p.exitcode != 0 for p in procs) or errors:
            raise AssertionError(f"sequence_parallel_families: a gloo rank failed: exit codes "
                                 f"{[p.exitcode for p in procs]} {errors}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        t_ranks = time.perf_counter() - t0
        total = {k.name: 0 for k in every}
        peaks = {}
        for tag, (key, drop, native, epochs, route, need) in SPF_ARMS.items():
            lr = cfgs[key].train.lr
            got = [r["arms"][tag] for r in ranks]
            want = one[tag]
            bf16 = cfgs[key].model.compute_dtype == "bfloat16"
            tol = TP_BF16_LOSS_TOL if bf16 else DP_LOSS_TOL
            loss_err = max(abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"]))
                           for a, b in zip(got[0]["steps"], want["steps"]))
            bad = _close_states(got[0]["state"], want["state"], lr, len(epochs), share=not bf16)
            split = [k for k in want["state"] if not torch.equal(got[0]["state"][k],
                                                                 got[1]["state"][k])]
            print(f"spf [{card}]: {tag}: {len(epochs)} steps on 2 gloo ranks (dp 1 x sp 2) vs "
                  f"one process: max|loss diff| / max(1, |loss|) {loss_err:.3e} (tol {tol}), "
                  f"losses {[s['loss'] for s in got[0]['steps']]} vs "
                  f"{[s['loss'] for s in want['steps']]}; {len(bad)} of {len(want['state'])} "
                  f"final tensors outside the fit bounds {bad[:3]}; the ranks' whole states "
                  f"differ in {len(split)} tensors")
            if loss_err > tol or bad or split or not (got[0]["finite"] and got[1]["finite"]):
                raise AssertionError(f"sequence_parallel_families: {tag} disagrees with one "
                                     f"process")
            if route == "cached":
                # the cached route against the host route's arm, on the ranks and alone
                host = next(t for t, a in SPF_ARMS.items() if a[0] == key and a[4] == "host")
                for label, a, b in (("ranks", got[0], ranks[0]["arms"][host]),
                                    ("one process", want, one[host])):
                    d = max(abs(x["loss"] - y["loss"]) for x, y in zip(a["steps"], b["steps"]))
                    off = _close_states(a["state"], b["state"], lr, len(epochs))
                    print(f"spf [{card}]: {key}: cached route vs host route ({label}): "
                          f"max|loss diff| {d:.3e}, {len(off)} tensors outside the fit bounds")
                    if d > DP_LOSS_TOL or off:
                        raise AssertionError(f"sequence_parallel_families: {key}'s cached "
                                             f"route differs from its host route ({label})")
            S = batches[key]["features"].shape[1]
            for r, g in enumerate(got):
                launched = {n: sum(s["launches"].get(n, 0) for s in g["steps"]) for n in total}
                seen = sorted({x for s in g["steps"] for x in s["seen"]})
                print(f"spf [{card}]: {tag}: gloo rank {r}: launches "
                      f"{ {n: c for n, c in launched.items() if c} }; routes and shapes {seen}; "
                      f"step ms {[round(s['ms'], 2) for s in g['steps']]} (one process "
                      f"{[round(s['ms'], 2) for s in want['steps']]}); peak allocated bytes "
                      f"{[s['peak'] for s in g['steps']]} (one process "
                      f"{[s['peak'] for s in want['steps']]})")
                for n, c in launched.items():
                    total[n] += c
                wrong = [f"never launched {n}" for n in need if launched.get(n, 0) == 0]
                wrong += _spf_routes(tag, seen, S)
                if wrong:
                    raise AssertionError(f"sequence_parallel_families: {tag}: rank {r}: {wrong}")
            peaks[tag] = ([max(s["peak"] for s in g["steps"]) for g in got],
                          max(s["peak"] for s in want["steps"]))
        ev = [r["eval"] for r in ranks]
        err = max(float((e["out"][k] - one_eval["out"][k]).abs().max())
                  for e in ev for k in one_eval["out"])
        S = batches["proposed"]["features"].shape[1]
        print(f"spf [{card}]: {SPF_ROWS} x {S} 50salads_proposed eval forward, 2 ranks vs one "
              f"process: max|output diff| {err:.3e} (tol {SP_EVAL_TOL}); routes "
              f"{ev[0]['seen']} (one process {one_eval['seen']}); launches "
              f"{ {n: c for n, c in ev[0]['launches'].items() if c} }; ms "
              f"{[round(e['ms'], 2) for e in ev]} (one process {one_eval['ms']:.2f}); peak "
              f"allocated bytes {[e['peak'] for e in ev]} (one process {one_eval['peak']})")
        for e in ev:
            for n, c in e["launches"].items():
                total[n] = total.get(n, 0) + c
        rows_k3 = ("K3", S // 2, S)   # the rank's query rows against the gathered keys
        if not err <= SP_EVAL_TOL or any(
                ("ring", S // 2) not in e["seen"] or rows_k3 not in e["seen"]
                or e["launches"].get("flash_attention_bf16_many", 0) == 0 for e in ev):
            raise AssertionError("sequence_parallel_families: the 50salads_proposed eval "
                                 "forward disagrees or missed the ring and K3")
        peaks["proposed eval"] = ([e["peak"] for e in ev], one_eval["peak"])
        print(f"spf [{card}]: 2 gloo ranks, {len(SPF_ARMS)} arms and the eval forward, "
              f"{t_ranks:.1f} s with their start; the sequence_parallel_families phase took "
              f"{time.perf_counter() - t_phase:.1f} s")
        return total, peaks
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------- phase 25: pipeline parallelism

PP_DIR = "build/pp_phase"   # under the checkout (git-ignored), removed after the phase
PP_TIMEOUT = 400            # s: a rank or a collective that takes longer fails the phase
# arm -> (config, dropout, schedule, M, the (bucket, epoch) of each step, one batch each, from
# the same init); 50salads under R3D_CROSS_NATIVE=1 (K6/K7 in the decoder)
PP_ARMS = {
    "50salads pp 2, 512 then 3100: GPipe, dropout 0.1": ("salads", 0.1, "gpipe", 2,
                                                        ((512, 0), (3100, 0))),
    "50salads pp 2, 512 then 3100: GPipe, dropout off": ("salads", 0.0, "gpipe", 2,
                                                        ((512, 0), (3100, 0))),
    "50salads pp 2, 3100: 1F1B, M = 2": ("salads", 0.1, "1f1b", 2, ((3100, 0),)),
    "50salads pp 2, 3100: 1F1B, M = 4": ("salads", 0.1, "1f1b", 4, ((3100, 0),)),
    "utkinects (2 decoder layers) pp 2, 512: 1F1B, M = 2, epoch 0 then the sticky epoch": (
        "utk", 0.1, "1f1b", 2, ((512, 0), (512, 1))),
}
PP_SERVE_LENGTHS = (400, 512, 300, 480, 257, 350, 444, 500)   # one chunk of 8 in the 512 bucket


def pp_configs():
    """50salads at full width (FUTR, hidden 512, 2 decoder layers, 20
    queries, bf16) and utkinects with 2 decoder layers (``--n_decoder_layers
    2``; the named config has one, which pp 2 declines)."""
    import dataclasses

    from r3d_tpu_torch.config import get_config

    utk = get_config("utkinects")
    return dict(salads=get_config("50salads"),
                utk=utk.replace(model=dataclasses.replace(utk.model, n_decoder_layers=2)))


def pp_config(key, dropout, schedule, M):
    import dataclasses

    cfg = pp_configs()[key]
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=dropout,
                                                 fuser_dropout=dropout),
                       mesh=dataclasses.replace(cfg.mesh, pp_schedule=schedule,
                                                pp_microbatches=M))


def pp_classes(key):
    return SALADS_CLASSES if key == "salads" else N_CLASS


def pp_batches(cfgs):
    """{config: {bucket: a batch of 8}}: 50salads' 512 and 3100 windows
    (``salads_loaders``), utkinects' 512 (``_dp_batches``)."""
    salads = salads_loaders(cfgs["salads"])[1]
    out = dict(salads={512: one_batch(salads, 256, 512), 3100: one_batch(salads, 1024)},
               utk={512: _dp_batches(cfgs["utk"])[0]})
    for key, by in out.items():
        for S, b in by.items():
            if b["features"].shape[:2] != (8, S):
                raise AssertionError(f"pipeline_parallel: {key}'s batch is "
                                     f"{tuple(b['features'].shape[:2])}, not (8, {S})")
    return out


def pp_inits(cfgs):
    import torch

    from r3d_tpu_torch.models import build_model, init_weights

    return {k: init_weights(build_model(c.model, pp_classes(k), c.data.depth_shape),
                            torch.Generator().manual_seed(SEED)).state_dict()
            for k, c in cfgs.items()}


@contextlib.contextmanager
def pp_twin(M, microbatch_calls=False):
    """Within (one process): each decoder draws its dropout as the pipelined
    decoder does on pp ranks, its layers run per microbatch under the
    generators of (the base seed, the global layer, the microbatch)
    (``parallel.pipeline.stage_generators``): each call's rows cut into M
    microbatches, the base drawn per call (GPipe's twin), or with
    ``microbatch_calls`` each call one microbatch, numbered in order, the
    base drawn at the first (the 1F1B step's twin, ``make_accum_step``)."""
    import torch

    from r3d_tpu_torch.models.transformer import TransformerDecoder
    from r3d_tpu_torch.parallel.pipeline import draw_base_seed, stage_generators

    saved = TransformerDecoder.forward
    calls = {"m": 0, "base": None}

    def forward(self, tgt, memory, pos, query_pos, mkpm=None, tkpm=None, seq=False):
        if microbatch_calls:
            if calls["m"] == 0:
                calls["base"] = draw_base_seed(self.layers)
            parts, base = [(calls["m"], slice(None))], calls["base"]
            calls["m"] += 1
        else:
            base = draw_base_seed(self.layers)
            n = tgt.shape[0] // M
            parts = [(m, slice(m * n, (m + 1) * n)) for m in range(M)]
        pick = lambda t, r: None if t is None else t[r]
        outs = []
        for m, r in parts:
            x = tgt[r]
            for li, layer in enumerate(self.layers):
                with stage_generators(layer, base, li, m):
                    x = layer(x, memory[r], pick(pos, r), query_pos[r], pick(mkpm, r),
                              pick(tkpm, r), seq)
            outs.append(x)
        return self.norm(torch.cat(outs))

    TransformerDecoder.forward = forward
    try:
        yield
    finally:
        TransformerDecoder.forward = saved


def pp_kernels():
    from r3d_tpu_torch.ops import attention as att
    from r3d_tpu_torch.ops import cross_attention as ca

    return tp_kernels() + [ca.FWD_KERNEL, ca.BWD_KERNEL, att.KERNEL_BF16_MANY,
                           att.DROPOUT_KERNEL_BF16_MANY, att.BWD_KERNEL_BF16_MANY]


@contextlib.contextmanager
def _native(on):
    import os

    before = os.environ.get("R3D_CROSS_NATIVE")
    if on:
        os.environ["R3D_CROSS_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("R3D_CROSS_NATIVE", None)
        if before is not None:
            os.environ["R3D_CROSS_NATIVE"] = before


def _pp_arm(tag, kernels, batches, inits, mesh=None):
    """One ``PP_ARMS`` arm on ``mesh`` (None: one process on the card, the
    GPipe steps through ``pp_twin``, the 1F1B steps as ``make_accum_step``
    over the same M microbatches through its microbatch twin): its steps
    from the init after the trainer seeds dropout, each with the counts set
    to 0 before and read after, its loss, wall time and the peak bytes
    allocated in this process; the whole final state."""
    import torch

    from r3d_tpu_torch.parallel.mesh import shard_state, whole_model_state
    from r3d_tpu_torch.train.loop import Trainer

    key, drop, schedule, M, steps_of = PP_ARMS[tag]
    with _native(key == "salads"):
        trainer = Trainer(pp_config(key, drop, schedule, M), pp_classes(key), mesh=mesh)
        state = trainer.init_state(1, inits[key])
        if mesh is not None:
            state = shard_state(state, mesh)
        trainer._seed_dropout(state, SEED, 0)
        step = trainer.make_train_step() if mesh is not None else None
        steps = []
        for S, epoch in steps_of:
            batch = batches[key][S]
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if mesh is not None:
                metrics = step(state, batch, epoch)
            elif schedule == "1f1b":
                stacked = {k: v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
                           for k, v in batch.items()}
                with pp_twin(M, microbatch_calls=True):
                    metrics = trainer.make_accum_step()(state, stacked, epoch)
            else:
                with pp_twin(M):
                    metrics = trainer.train_step(state, batch, epoch)
            loss = trainer._to_host({"loss": metrics["loss"]})["loss"]
            torch.cuda.synchronize()
            steps.append(dict(loss=loss, ms=1e3 * (time.perf_counter() - t0), S=S, epoch=epoch,
                              peak=torch.cuda.max_memory_allocated(),
                              launches={k.name: k.launches for k in kernels}))
        whole = {k: v.detach().cpu() for k, v in whole_model_state(state.model).items()}
    return dict(steps=steps, state=whole,
                finite=all(bool(torch.isfinite(v).all()) for v in whole.values()
                           if v.is_floating_point()))


def _pp_eval(kernels, batches, inits, mesh=None):
    """50salads' module-eval forward of its 512 and 3100 batches with the
    pad mask (GPipe on the pp ranks, under R3D_CROSS_NATIVE=1: the decoder's
    cross-attention K3 at 512, K6 at 3100; one process through ``pp_twin``,
    the same microbatches): the action and duration outputs, the launches,
    the wall time and the peak bytes."""
    import torch

    from r3d_tpu_torch.parallel.mesh import place_model
    from r3d_tpu_torch.train.loop import Trainer

    with _native(True):
        trainer = Trainer(pp_config("salads", 0.1, "gpipe", 2), SALADS_CLASSES, mesh=mesh)
        model = place_model(trainer.init_state(1, inits["salads"]).model, mesh).eval()
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = {}
        with torch.no_grad(), (pp_twin(2) if mesh is None else contextlib.nullcontext()):
            for S, batch in sorted(batches["salads"].items()):
                out = model(*trainer._model_inputs(trainer.to_device(batch), with_mask=True))
                got.update({f"{k} {S}": out[k].float().cpu() for k in ("action", "duration")})
    return dict(out=got, launches={k.name: k.launches for k in kernels},
                ms=1e3 * (time.perf_counter() - t0), peak=torch.cuda.max_memory_allocated())


def _pp_serve(inits, meshes=None):
    """A utkinects session on dp 2 and a 50salads session on pp 2 (one
    process: no mesh), max_batch 8: each one's logits of one chunk of
    ``PP_SERVE_LENGTHS`` in the 512 bucket."""
    from r3d_tpu_torch.serving import InferenceSession

    cfgs = pp_configs()
    rng = np.random.default_rng(SEED + 25)
    out = {}
    for key, kind in (("dp", "utk"), ("pp", "salads")):
        cfg = cfgs[kind]
        with _native(kind == "salads"):
            session = InferenceSession(cfg, inits[kind], pp_classes(kind), max_batch=8,
                                       mesh=None if meshes is None else meshes[key])
            videos = make_videos(rng, PP_SERVE_LENGTHS, cfg)
            res = session._run(*session._collate(videos, 512))
            out[key] = {k: res[k].float().cpu() for k in ("action", "duration")}
    return out


def _pp_rank(rank, world, work):
    """One gloo rank on the card (``cuda:0``, shared), on dp 1 x pp 2: every
    ``PP_ARMS`` arm, the eval forward and the sessions (utkinects on dp 2,
    50salads on pp 2); writes its results to ``work/rank{rank}.pt``."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=PP_TIMEOUT))
        from r3d_tpu_torch.parallel.mesh import make_mesh

        kernels = pp_kernels()
        batches = torch.load(os.path.join(work, "batches.pt"), weights_only=True)
        inits = torch.load(os.path.join(work, "inits.pt"), weights_only=True)
        mesh = make_mesh(dp=1, pp=world)
        out = {"arms": {tag: _pp_arm(tag, kernels, batches, inits, mesh) for tag in PP_ARMS},
               "eval": _pp_eval(kernels, batches, inits, mesh),
               "serve": _pp_serve(inits, {"dp": make_mesh(dp=world), "pp": mesh})}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _pp_expected(name, one, rank, schedule, pp=2):
    """The launches of kernel ``name`` on pp rank ``rank`` for a step whose
    one-process twin launched it ``one`` times: the fuser's (the pre,
    which every rank runs over all M microbatches) as many; the decoder's,
    each rank running its own half of the layers, half (GPipe, and 1F1B's
    backward), and the 1F1B forward on stages before the last twice that
    (its forward tick and the recomputation before the backward)."""
    if name.startswith("fused_"):
        return one
    if schedule == "1f1b" and "bwd" not in name and rank < pp - 1:
        return one
    return one // pp


def pipeline_parallel(kernels, card):
    """Phase 25: see the module docstring. Returns each kernel's launches
    on the two ranks' arms (both ranks summed) and each rank's peak bytes
    against one process's."""
    import os
    import shutil

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, PP_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    try:
        cfgs = pp_configs()
        batches = pp_batches(cfgs)
        inits = pp_inits(cfgs)
        torch.save(batches, os.path.join(work, "batches.pt"))
        torch.save(inits, os.path.join(work, "inits.pt"))
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_pp_rank, args=(r, 2, work), daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        # while the ranks start: one process on the same card
        pk = pp_kernels()
        one = {tag: _pp_arm(tag, pk, batches, inits) for tag in PP_ARMS}
        one_eval = _pp_eval(pk, batches, inits)
        one_serve = _pp_serve(inits)
        for p in procs:
            p.join(max(1.0, PP_TIMEOUT - (time.perf_counter() - t0)))
        errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
                  if f.endswith(".err")]
        if any(p.is_alive() or p.exitcode != 0 for p in procs) or errors:
            raise AssertionError(f"pipeline_parallel: a gloo rank failed: exit codes "
                                 f"{[p.exitcode for p in procs]} {errors}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        t_ranks = time.perf_counter() - t0
        total = {k.name: 0 for k in kernels}
        peaks = {}
        print(f"pp [{card}]: two gloo ranks share the one card, their transfers staged through "
              f"the host by gloo: step times and peak bytes are readings, not throughputs")
        for tag, (key, drop, schedule, M, steps_of) in PP_ARMS.items():
            lr = cfgs[key].train.lr
            got = [r["arms"][tag] for r in ranks]
            want = one[tag]
            bf16 = cfgs[key].model.compute_dtype == "bfloat16"
            tol = TP_BF16_LOSS_TOL if bf16 else DP_LOSS_TOL
            loss_err = max(abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"]))
                           for a, b in zip(got[0]["steps"], want["steps"]))
            bad = _close_states(got[0]["state"], want["state"], lr, len(steps_of),
                                share=not bf16)
            split = [k for k in want["state"] if not torch.equal(got[0]["state"][k],
                                                                 got[1]["state"][k])]
            print(f"pp [{card}]: {tag}: {len(steps_of)} steps on 2 gloo ranks (dp 1 x pp 2) vs "
                  f"one process ({'make_accum_step over M' if schedule == '1f1b' else 'GPipe'}'s "
                  f"twin): max|loss diff| / max(1, |loss|) {loss_err:.3e} (tol {tol}), losses "
                  f"{[s['loss'] for s in got[0]['steps']]} vs {[s['loss'] for s in want['steps']]}"
                  f"; {len(bad)} of {len(want['state'])} final tensors outside the fit bounds "
                  f"{bad[:3]}; the ranks' whole states differ in {len(split)} tensors")
            if loss_err > tol or bad or split or not (got[0]["finite"] and got[1]["finite"]):
                raise AssertionError(f"pipeline_parallel: {tag} disagrees with one process")
            for r, g in enumerate(got):
                wrong = []
                for i, (s, w) in enumerate(zip(g["steps"], want["steps"])):
                    for n, c in w["launches"].items():
                        if c and s["launches"][n] != _pp_expected(n, c, r, schedule):
                            wrong.append((i, n, s["launches"][n], c))
                        total[n] += s["launches"][n]
                    if not any(s["launches"].values()):
                        wrong.append((i, "no kernel launched"))
                print(f"pp [{card}]: {tag}: gloo rank {r}: launches a step "
                      f"{[{n: c for n, c in s['launches'].items() if c} for s in g['steps']]} "
                      f"(one process {[{n: c for n, c in s['launches'].items() if c} for s in want['steps']]}, "
                      f"M = {M}); step ms {[round(s['ms'], 2) for s in g['steps']]} (one process "
                      f"{[round(s['ms'], 2) for s in want['steps']]}); peak allocated bytes "
                      f"{[s['peak'] for s in g['steps']]} (one process "
                      f"{[s['peak'] for s in want['steps']]})")
                if wrong:
                    raise AssertionError(f"pipeline_parallel: {tag}: rank {r}: launches "
                                         f"(step, kernel, got, one process's) {wrong}")
            peaks[tag] = ([g["steps"][-1]["peak"] for g in got], want["steps"][-1]["peak"])
        ev = [r["eval"] for r in ranks]
        err = max(float((e["out"][k] - one_eval["out"][k]).abs().max())
                  for e in ev for k in one_eval["out"])
        print(f"pp [{card}]: 8 x 512 and 8 x 3100 50salads eval forwards (GPipe, M = 2), 2 ranks vs one "
              f"process: max|output diff| {err:.3e} (tol {SALADS_E2E_TOL}); launches "
              f"{[{n: c for n, c in e['launches'].items() if c} for e in ev]} (one process "
              f"{ {n: c for n, c in one_eval['launches'].items() if c} }); ms "
              f"{[round(e['ms'], 2) for e in ev]} (one process {one_eval['ms']:.2f}); peak "
              f"allocated bytes {[e['peak'] for e in ev]} (one process {one_eval['peak']})")
        halves = all(e["launches"][n] * 2 == c for e in ev
                     for n, c in one_eval["launches"].items() if c)
        if not err <= SALADS_E2E_TOL or not halves or not any(one_eval["launches"].values()):
            raise AssertionError("pipeline_parallel: the 50salads eval forward disagrees")
        for e in ev:
            for n, c in e["launches"].items():
                total[n] += c
        peaks["eval"] = ([e["peak"] for e in ev], one_eval["peak"])
        for key, tol in (("dp", E2E_TOL), ("pp", SALADS_E2E_TOL)):
            serr = max(float((r["serve"][key][k] - one_serve[key][k]).abs().max())
                       for r in ranks for k in one_serve[key])
            print(f"pp [{card}]: the {'utkinects session on dp 2' if key == 'dp' else '50salads session on pp 2'}, "
                  f"a chunk of 8 in the 512 bucket: max|logit and duration diff| against one "
                  f"process {serr:.3e} (tol {tol})")
            if not serr <= tol:
                raise AssertionError(f"pipeline_parallel: the session on {key} 2 disagrees")
        print(f"pp [{card}]: 2 gloo ranks, {len(PP_ARMS)} arms, the eval forward and the "
              f"sessions, {t_ranks:.1f} s with their start; the pipeline_parallel phase took "
              f"{time.perf_counter() - t_phase:.1f} s")
        return total, peaks
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


CARDS_ARMS = ("dp", "tp", "sp", "families", "pp")   # --cards' arms, in their order


def cards_main() -> int:
    """``chip_smoke.py --cards``: ``cli_under_torchrun`` on every card the
    host has (two or more) against one card, alone, on a dp mesh and (an
    even count of cards) on dp x tp 2 and on dp x sp 2, without and with
    one encoder layer, then 50salads_proposed and darai on dp x sp 2, and
    (a count of cards 4 divides) utkinects with 2 decoder layers on dp x
    pp 2, GPipe and 1F1B; ``--cards ARM ...`` runs only the named arms of
    ``CARDS_ARMS`` (all by default);
    prints the cards' names and power limits, the readings and, last, one
    JSON object of them."""
    import os
    import shutil

    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"chip_smoke --cards: {n} CUDA card(s); this needs two or more", file=sys.stderr)
        return 1
    try:
        import r3d_tpu_torch.cli.run  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke --cards: the port is not importable here ({e})", file=sys.stderr)
        return 1
    listed = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(listed))
    cards = "; ".join(f"{listed.count(c)} x {c}" for c in sorted(set(listed)))
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, DP_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    arms = set(sys.argv[2:]) or set(CARDS_ARMS)
    if arms - set(CARDS_ARMS):
        print(f"chip_smoke --cards: unknown arms {sorted(arms - set(CARDS_ARMS))} (of "
              f"{CARDS_ARMS})", file=sys.stderr)
        return 1
    try:
        argv = dp_cli_argv(work)
        got = cli_under_torchrun(n, argv, work, here, cards) if "dp" in arms else {}
        # dp x tp 2 (NCCL, FSDP over dp): tensor parallelism across cards
        got_tp = (cli_under_torchrun(n, argv, work, here, cards, tp=2)
                  if n % 2 == 0 and "tp" in arms else None)
        # dp x sp 2 (NCCL, FSDP over dp): the sequence cut across cards, then
        # with one encoder layer: the ring over NCCL's point-to-point calls
        got_sp = got_ring = None
        families = {}
        if n % 2 == 0 and "sp" in arms:
            got_sp = cli_under_torchrun(n, argv, work, here, cards, sp=2)
            got_ring = cli_under_torchrun(n, argv, work, here, cards, sp=2, encoder=1)
        if n % 2 == 0 and "families" in arms:
            # the query families on dp x sp 2: 50salads_proposed (S queries
            # against S keys) and darai (the self-attention source, the
            # unsupervised loop), each over a dataset of its layout
            train_l, val_l, _ = PROPOSED_DATA["50salads_proposed"]
            roots = {"50salads_proposed": write_proposed_dataset(
                         os.path.join(work, "proposed"), "50salads_proposed", train_l, val_l),
                     "darai": write_darai_dataset(os.path.join(work, "darai"), DARAI_TRAIN,
                                                  DARAI_VAL)}
            for name, root in roots.items():
                fam = ["--config", name, "--data_root", root, "--seed", "1", "--epochs", "2"]
                families[name] = cli_under_torchrun(n, fam, work, here, cards, sp=2,
                                                    ring_decoder=name == "50salads_proposed")
        # dp x pp 2 (NCCL point-to-point hops), utkinects with 2 decoder layers: GPipe on
        # the cached route (FSDP over dp), and 1F1B on the host route with one
        # microbatch, which every dp rank runs whole (rank 0's update: one card's)
        pipelines = {}
        if n % 4 == 0 and "pp" in arms:
            deep = argv + ["--n_decoder_layer", "2"]
            pipelines["gpipe"] = cli_under_torchrun(n, deep, work, here, cards, pp=2)
            pipelines["1f1b"] = cli_under_torchrun(
                n, deep + ["--no-device_cache"], work, here, cards, pp=2,
                pp_flags=("--pp_schedule", "1f1b", "--pp_microbatches", "1"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ranks": n, **got, "mesh_tp_2": got_tp, "mesh_sp_2": got_sp,
                      "mesh_sp_2_encoder": got_ring,
                      **{f"mesh_sp_2_{k}": v for k, v in families.items()},
                      **{f"mesh_pp_2_{k}": v for k, v in pipelines.items()}}))
    return 0


NATIVE_DIR = "build/native_phase"   # under the checkout (git-ignored), removed after the phase
NATIVE_VIDEOS = (8, 2)              # train and val videos of the utkinect layout at full width
NATIVE_LENGTHS = (600, 1000)        # frames a video
NATIVE_OBS = (0.3, 0.4, 0.5)        # the fit's ratios: windows of 180-500 rows, the 256 and
                                    # 512 buckets, 3 batches of 8 an epoch


def same_example(a, b):
    """Two examples equal field by field, bit for bit (dtypes and shapes too)."""
    for f in ("features", "past_label", "trans_future_target", "trans_future_dur",
              "depth_features", "query_label"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or x is not None and not (
                x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)):
            return False
    return (a.vid_name, a.obs_perc) == (b.vid_name, b.obs_perc)


def native_loader(kernels, card, state_dict):
    """The native host loader on the utkinects training path (A9): build
    ``native/fastloader.cpp`` with the host's C++ compiler; write a utkinect
    layout at full width (``NATIVE_VIDEOS`` videos of ``NATIVE_LENGTHS``
    frames, 2,048-d fp32 features, 160x120 fp32 depth); hold every example
    of the config's train table from ``VideoSource(cache='native')`` to the
    RAM path's, bit for bit, with as many native loads as examples and no
    fall-through, timing each load against a cold RAM-path load (``np.load``
    of the whole video and the slice; the files are in the page cache, so
    both reads are warm); then ``Trainer.fit`` for 2 epochs of 3 steps over
    the native source at ``NATIVE_OBS`` with every launch count set to 0 and
    ``MetricsLogger(tensorboard=True)``, whose events must read back equal
    to its JSONL, and K1 (both routes), K2, K3, K4 and K5 each launched;
    the same fit over the RAM source, in the same batch order, must end in
    the same state bit for bit; two fits under ``rng_impl="rbg"`` equal to
    each other, another than the threefry fit, K4 and K5 launched; and one
    step under ``utils.profiling.profile_trace`` whose trace names an
    annotated region and the port's kernels. Returns the native fit's
    launch counts."""
    import dataclasses
    import json as _json
    import os
    import shutil
    import statistics

    import torch

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.data import native
    from r3d_tpu_torch.data.datasets import VideoSource, build_loader, build_source
    from r3d_tpu_torch.train.loop import Trainer
    from r3d_tpu_torch.utils.metrics import MetricsLogger
    from r3d_tpu_torch.utils.profiling import TRACE_FILE, annotate, profile_trace
    from r3d_tpu_torch.utils.tbwriter import read_events

    t0 = time.perf_counter()
    so = native.build()
    print(f"native: {native.compiler()} {' '.join(native.CXX_FLAGS)} built {so} in "
          f"{time.perf_counter() - t0:.2f} s")
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, NATIVE_DIR)
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        root = write_utkinect_dataset(os.path.join(work, "data"), *NATIVE_VIDEOS, NATIVE_LENGTHS)
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        print(f"native: utkinect layout, {NATIVE_VIDEOS[0]} + {NATIVE_VIDEOS[1]} videos of "
              f"{NATIVE_LENGTHS[0]}-{NATIVE_LENGTHS[1]} frames, {size / 2**20:.0f} MiB written in "
              f"{time.perf_counter() - t0:.2f} s")
        base = get_config("utkinects")
        cfg = base.replace(data=dataclasses.replace(base.data, data_root=root),
                           train=dataclasses.replace(base.train, epochs=2))
        sr, nq = cfg.data.sample_rate, cfg.model.n_query

        def sources(split):
            ram = build_source(cfg.data, split)
            args = (ram.vid_list, ram.actions_dict, ram.n_class, ram.pad_idx, ram.query_dict)
            return ram, VideoSource(cfg.data, *args, cache="native"), args

        ram, nat, args = sources("train_split.txt")
        table = [(u, o) for u in ram.units() for o in cfg.data.train_obs_percs]
        native.STATS.reset()
        t_native, t_ram = [], []
        for (vid, seq), o in table:
            t1 = time.perf_counter()
            got = nat.make_example(vid, o, sr, nq, seq)
            t2 = time.perf_counter()
            want = VideoSource(cfg.data, *args).make_example(vid, o, sr, nq, seq)
            t3 = time.perf_counter()
            t_native.append(1e3 * (t2 - t1))
            t_ram.append(1e3 * (t3 - t2))
            if not same_example(got, want):
                raise AssertionError(f"native: the example of {vid} at {o} is not the RAM "
                                     "path's")
        stats = native.STATS.as_dict()
        if stats != {"loads": len(table), "fallbacks": 0, "depth_misses": 0}:
            raise AssertionError(f"native: {len(table)} examples, counted {stats}")
        print(f"native: {len(table)} examples of the train table ({len(ram.units())} videos x "
              f"{len(cfg.data.train_obs_percs)} ratios) equal to the RAM path's bit for bit, "
              f"{stats}; per-example load median {statistics.median(t_native):.2f} ms native "
              f"against {statistics.median(t_ram):.2f} ms RAM path (np.load + slice; warm page "
              f"cache) on {card}")

        fit_cfg = cfg.replace(data=dataclasses.replace(cfg.data, train_obs_percs=NATIVE_OBS))
        val_ram, val_nat, _ = sources("val_split.txt")
        by_name = {k.name: k for k in kernels}
        path = ("fused_safuser_tail", "fused_bn_blend_tail", "fused_tail_bwd", "flash_attention",
                "flash_attention_dropout", "attention_bwd")

        def fit(train_src, val_src, rng_impl=None, logger=None):
            c = fit_cfg.replace(train=dataclasses.replace(fit_cfg.train, rng_impl=rng_impl))
            loader = build_loader(train_src, c.data, c.train.batch_size, nq, mode="train",
                                  seed=SEED, pin_memory=True)
            val = build_loader(val_src, c.data, c.train.batch_size, nq, mode="val",
                               shuffle=False, pin_memory=True)
            trainer = Trainer(c, train_src.n_class)
            state = trainer.init_state(len(loader), state_dict)
            for k in kernels:
                k.launches = 0
            native.STATS.reset()
            lines = []
            t1 = time.perf_counter()
            trainer.fit(state, loader, val, seed=SEED, log=lines.append, metrics_logger=logger)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            losses = [float(x) for line in lines
                      for x in re.findall(r"Loss ?: ?(-?[0-9.]+|nan|inf)", line)]
            if (len(losses) != 4 or not all(math.isfinite(x) for x in losses)
                    or state.step != 2 * len(loader)):
                raise AssertionError(f"native fit: {state.step} steps, {lines}")
            counts = {n: by_name[n].launches for n in path}
            print(f"native: fit over the {'native' if train_src.cache == 'native' else 'RAM'} "
                  f"source, rng_impl {rng_impl}: 2 epochs of {len(loader)} steps in {dt:.2f} s, "
                  f"losses {losses}, loader {native.STATS.as_dict()}, launches {counts}")
            return state, {k.name: k.launches for k in kernels}, trainer, loader

        logger = MetricsLogger(os.path.join(work, "metrics"), run_name="native",
                               tensorboard=True)
        try:
            s_native, counts, trainer, loader = fit(nat, val_nat, logger=logger)
        finally:
            logger.close()
        unused = [n for n in path if counts[n] == 0]
        if unused:
            raise AssertionError(f"native: the fit never launched {unused}")
        with open(logger.path) as f:
            records = [_json.loads(line) for line in f]
        tb = os.path.join(work, "metrics", "tb", "native")
        events = [e for name in os.listdir(tb) for e in read_events(os.path.join(tb, name))]
        got = {}
        for e in events[1:]:
            got.setdefault(e["step"], {}).update(e["scalars"])
        want = {r["step"]: {k: float(np.float32(v)) for k, v in r.items()
                            if k not in ("time", "step") and isinstance(v, (int, float))}
                for r in records}
        if len(records) != 2 or got != want:
            raise AssertionError(f"native: TensorBoard events {got} against the JSONL {want}")
        print(f"native: TensorBoard events of {len(records)} records ({len(events) - 1} "
              "scalars) equal to the JSONL")
        s_ram, _, _, _ = fit(ram, val_ram)
        differ = unequal(s_native.model.state_dict(), s_ram.model.state_dict())
        if differ:
            raise AssertionError(f"native: the native-fed fit is not the RAM-fed fit: {differ}")
        print("native: the native-fed fit's final state equals the RAM-fed fit's bit for bit")
        s_rbg, c_rbg, _, _ = fit(nat, val_nat, rng_impl="rbg")
        s_rbg2, _, _, _ = fit(nat, val_nat, rng_impl="rbg")
        if (unequal(s_rbg.model.state_dict(), s_rbg2.model.state_dict())
                or not unequal(s_rbg.model.state_dict(), s_native.model.state_dict())):
            raise AssertionError("native: rng_impl='rbg' fits are not equal to each other, "
                                 "or equal the threefry fit")
        if not (c_rbg["flash_attention_dropout"] and c_rbg["attention_bwd"]):
            raise AssertionError(f"native: the rbg fit launched no K4 or K5: {c_rbg}")
        print("native: two rng_impl='rbg' fits equal bit for bit, the threefry fit another")

        batch = trainer.to_device(one_batch(loader, 0))
        seen = set()
        for attempt in range(3):   # a trace now and then comes back without device events
            with profile_trace(os.path.join(work, "trace")):
                with annotate("native_step"):
                    s_native.model.train()
                    s_native.optimizer.zero_grad(set_to_none=True)
                    trainer._grad_core(s_native.model, batch)
                    s_native.apply_gradients()
            with open(os.path.join(work, "trace", TRACE_FILE)) as f:
                trace = _json.load(f)["traceEvents"]
            names = {e.get("name", "") for e in trace}
            seen = {k for k in OWN_KERNELS if any(k in n for n in names)}
            if "native_step" in names and seen:
                break
        if "native_step" not in names or not seen:
            raise AssertionError(f"native: profile_trace's trace names no annotated region or "
                                 f"no kernel of the port: {sorted(names)[:40]}")
        print(f"native: profile_trace's trace names 'native_step' and the port's kernels "
              f"{sorted(seen)} (attempt {attempt + 1})")
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


_LAP = [0.0]
PHASE_SECONDS = {}   # phase -> its seconds in this run, as printed


def lap(name):
    """Print the seconds since the previous lap as phase ``name``'s, on a
    line of its own."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = now - _LAP[0]
    print(f"chip_smoke: phase {name} took {PHASE_SECONDS[name]:.1f} s", flush=True)
    _LAP[0] = now


def main() -> int:
    import os
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    try:
        from r3d_tpu_torch.config import get_config
        from r3d_tpu_torch.models import build_model, init_weights
        from r3d_tpu_torch.ops import attention as att
        from r3d_tpu_torch.ops import build as kbuild
        from r3d_tpu_torch.ops import cross_attention as ca
        from r3d_tpu_torch.ops import fuser_kernel as fk
        from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb
        from r3d_tpu_torch.serving import InferenceSession
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 1

    t_start = _LAP[0] = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    many = [att.KERNEL_BF16_MANY, att.DROPOUT_KERNEL_BF16_MANY, att.BWD_KERNEL_BF16_MANY]
    fp32_many = [att.KERNEL_MANY, att.DROPOUT_KERNEL_MANY, att.BWD_KERNEL_MANY]
    bf16_fuser, _ = bf16_fuser_counters()
    kernels = [fk.KERNEL, fk.TAIL_KERNEL, fk.TAIL_KERNEL_OUTER, fkb.KERNEL, fkb.KERNEL_OUTER,
               *bf16_fuser, att.KERNEL, att.DROPOUT_KERNEL, att.BWD_KERNEL, *fp32_many, att.KERNEL_BF16,
               att.DROPOUT_KERNEL_BF16, att.BWD_KERNEL_BF16, *many, ca.FWD_KERNEL, ca.BWD_KERNEL,
               ca.FWD_KERNEL_FP32, ca.BWD_KERNEL_FP32]
    serving_kernels = [fk.KERNEL, att.KERNEL]
    t0 = time.perf_counter()
    kbuild.build_all(kernels)
    sources = sorted({k.source for k in kernels})
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s into {kbuild.build_dir()}")
    for source in sources:
        log = (kbuild.build_dir() / (source.rsplit('.', 1)[0] + ".log"))
        entry = ""
        for line in log.read_text().splitlines() if log.exists() else []:
            if "Compiling entry function" in line:
                entry = ptxas_entry(line.split("'")[1]) + ": "
            elif "registers" in line or "spill" in line:
                print(f"  {source}: {entry}{line.strip()}")
    lap("build")

    gen = torch.Generator().manual_seed(SEED)
    (k1_err, k1_time), (k1t_err, k1t_time) = check_fuser_kernel(gen, device)
    k3_err, k3_time = check_attention_kernel(gen, device)
    k2_err, k2_time = check_fuser_bwd_kernel(gen, device)
    (k4_err, k4_time), (k5_err, k5_time) = check_attention_train_kernels(gen, device)
    bf16_err, bf16_time = check_attention_bf16_kernels(gen, device)
    self_err, self_time = check_attention_bf16_self(gen, device)
    ((k6_err, k6_time), (k7_err, k7_time), (k6f_err, k6f_time),
     (k7f_err, k7f_time)) = check_cross_attention_kernels(gen, device)
    self32_err, self32_time = check_attention_fp32_self(gen, device)
    fp32_threshold_ab(gen, device)
    k1o_time, k2o_time = time_outer_residual(gen, device)
    fuser_bf16 = check_fuser_bf16_kernels(gen, device)
    lap("kernel checks")

    # utkinects: futr_fusion_bn, fp32 after the bf16 embeds (PR 1, PR 2)
    cfg = get_config("utkinects")
    model = init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                         torch.Generator().manual_seed(SEED))
    state_dict = model.state_dict()
    session = InferenceSession(cfg, state_dict, N_CLASS, max_batch=8)
    rng = np.random.default_rng(SEED)
    groups = {256: (200, 256, 131, 240, 199, 250, 180, 222),
              512: (400, 512, 300, 480, 257, 350, 444, 500),
              1024: (900, 700)}
    latencies, serving_counts, _ = serve(session, kernels, cfg, rng, groups)
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
    deploy_htod(card, state_dict)   # the serving deployment phase's H2D bytes (phase 20)
    lap("utkinects serving")

    loaders = train_loaders(cfg)
    want = {"epoch 0 train": ("fused_safuser_tail", "fused_tail_bwd",
                              "flash_attention_dropout", "attention_bwd"),
            "epoch 1 train": ("fused_bn_blend_tail", "flash_attention", "attention_bwd")}
    counts = train(cfg, state_dict, kernels, loaders, want)
    print(f"launches on the training path: {counts}")
    train_breakdown(cfg, state_dict, loaders[1])
    train_step_on_card_and_cpu(cfg, state_dict,
                               min(loaders[1], key=lambda b: b["features"].shape[1]))
    lap("utkinects training")

    # utkinects through the CLI: train -> checkpoint -> the MoC sweep, card and CPU
    cli_train, cli_sweep = utkinects_cli(kernels, card, fk.KERNEL, att.KERNEL)
    print(f"launches on the utkinects CLI training path: "
          f"{ {k: c for k, c in cli_train.items() if c} }")
    print(f"launches on the utkinects CLI sweep: { {k: c for k, c in cli_sweep.items() if c} }")
    lap("utkinects CLI")

    # utkinects at UTKinect scale from the device cache
    cache_counts = utkinects_device_cache(kernels, card, state_dict)
    lap("utkinects device cache")

    # utkinects, R3D_CROSS_NATIVE=1: fp32 K6 and K7 in the 1024 and 2000 buckets
    n_serving, n_counts = utkinects_cross_native(kernels, state_dict, ca.FWD_KERNEL_FP32,
                                                 ca.BWD_KERNEL_FP32)
    print(f"launches on the utkinects R3D_CROSS_NATIVE=1 serving path: "
          f"{ {k: c for k, c in n_serving.items() if c} }")
    print(f"launches on the utkinects R3D_CROSS_NATIVE=1 training path: "
          f"{ {k: c for k, c in n_counts.items() if c} }")
    lap("utkinects R3D_CROSS_NATIVE=1")

    # 50salads: futr, bf16, R3D_CROSS_NATIVE=1
    s_serving, s_counts = salads(kernels, att.KERNEL_BF16, att.DROPOUT_KERNEL_BF16,
                                    att.BWD_KERNEL_BF16, ca.FWD_KERNEL, ca.BWD_KERNEL)
    launched = {k.name: c[k.name] for c in (s_serving, s_counts) for k in many if c[k.name]}
    if launched:   # the decoder's 20 queries take the few-query bodies
        raise AssertionError(f"50salads launched the many-query bodies: {launched}")
    print(f"launches on the 50salads serving path: { {k: c for k, c in s_serving.items() if c} }")
    print(f"launches on the 50salads training path: { {k: c for k, c in s_counts.items() if c} }")
    lap("50salads")

    # the gt-query FUTR: 50salads_proposed and breakfast_proposed through the CLI
    proposed = {}
    for name in PROPOSED_DATA:
        proposed[name] = proposed_cli(kernels, card, name, *many)
        print(f"launches on the {name} CLI training path: "
              f"{ {k: c for k, c in proposed[name][0].items() if c} }; sweep: "
              f"{ {k: c for k, c in proposed[name][1].items() if c} }")
        few = {k.name: c[k.name] for c in proposed[name][:2]
               for k in (att.KERNEL_BF16, att.DROPOUT_KERNEL_BF16, att.BWD_KERNEL_BF16)
               if c[k.name]}
        if few:   # S queries against S keys take the many-query bodies
            raise AssertionError(f"{name} launched the few-query bodies: {few}")
    lap("proposed configs")

    # the DARai family: darai and darai_gaze through the CLI, fp32 K3-K5
    darai = {}
    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), DARAI_DIR, "data")
    shutil.rmtree(data_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        root = write_darai_dataset(data_dir, DARAI_TRAIN, DARAI_VAL, gaze_rows=DARAI_GAZE_ROWS)
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                   for f in fs)
        print(f"darai: dataset of {len(DARAI_TRAIN)} + {len(DARAI_VAL)} videos "
              f"({sum(map(len, DARAI_TRAIN))} + {sum(map(len, DARAI_VAL))} sequences of "
              f"{min(min(v) for v in DARAI_TRAIN + DARAI_VAL)}-"
              f"{max(max(v) for v in DARAI_TRAIN + DARAI_VAL)} frames, gaze of "
              f"{DARAI_GAZE_ROWS[0]}-{DARAI_GAZE_ROWS[1]} rows), {size / 2**20:.0f} MiB written "
              f"in {time.perf_counter() - t0:.2f} s")
        for name in ("darai", "darai_gaze"):
            darai[name] = darai_cli(kernels, card, name, root, att.KERNEL, att.DROPOUT_KERNEL,
                                    att.BWD_KERNEL)
            print(f"launches on the {name} CLI training path: "
                  f"{ {k: c for k, c in darai[name][0].items() if c} }; sweep: "
                  f"{ {k: c for k, c in darai[name][1].items() if c} }")
        # the depth source (A11.4) on the same dataset: S queries, fp32 K3-K5
        # on their many-query counters, self- and cross-attention in a chunk
        darai[DEPTH_MODEL] = darai_cli(kernels, card, "darai", root, *fp32_many,
                                       model=DEPTH_MODEL)
        print(f"launches on the darai --model {DEPTH_MODEL} CLI training path: "
              f"{ {k: c for k, c in darai[DEPTH_MODEL][0].items() if c} }; sweep: "
              f"{ {k: c for k, c in darai[DEPTH_MODEL][1].items() if c} }")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    lap("darai family")

    # the fuser ablations through the CLI, fuser_depth=2, and the encoder
    ablation = ablations(kernels, card)
    for model, (a_train, a_sweep) in ablation.items():
        print(f"launches on the {model} CLI training path: "
              f"{ {k: c for k, c in a_train.items() if c} }; "
              f"sweep: { {k: c for k, c in a_sweep.items() if c} }")
    lap("ablations")
    # the fusion models in bf16 (A18): bf16 K1 on both routes, bf16 K2
    bf16_counts, bf16_sweep, bf16_steps = utkinects_bf16(kernels, card)
    print(f"launches on the bf16 utkinects path (CLI training, sweep, the ablations' steps): "
          f"{ {k: c for k, c in bf16_counts.items() if c} }")
    unused = [k.name for k in bf16_fuser if bf16_counts[k.name] == 0]
    if unused:
        raise AssertionError(f"the bf16 utkinects path never launched {unused}")
    lap("bf16 utkinects")
    depth2_counts = fuser_depth_2(kernels, loaders)
    lap("fuser_depth=2")
    enc = encoder(kernels, loaders)
    print(f"launches on the encoder serving path: "
          f"{ {k: c for k, c in enc['serving'].items() if c} }; fit: "
          f"{ {k: c for k, c in enc['fit'].items() if c} }")
    lap("encoder")

    # the rest of A11.4: the NTU baselines, MoE, the gt embed, L3 generation
    ntu = ntu_baselines(kernels, card)
    lap("NTU baselines")
    moe_serving, moe_train = salads_moe(kernels, card, att.KERNEL_BF16, att.DROPOUT_KERNEL_BF16,
                                        att.BWD_KERNEL_BF16, ca.FWD_KERNEL, ca.BWD_KERNEL)
    print(f"launches on the 50salads MoE serving path: "
          f"{ {k: c for k, c in moe_serving.items() if c} }; training path: "
          f"{ {k: c for k, c in moe_train.items() if c} }")
    lap("50salads MoE")
    gt_counts = gt_futr(kernels, card)
    l3_counts = l3_generation(kernels, card)
    lap("gt futr and L3 generation")
    # the rest of serving (A13): int8 weights, uint8 depth, export and ExportedSession
    deploy_live, deploy_exported = serving_deploy(kernels, card, state_dict)
    print(f"launches on the deployment phase's live sessions: "
          f"{ {k: c for k, c in deploy_live.items() if c} }; exported sessions: "
          f"{ {k: c for k, c in deploy_exported.items() if c} }")
    lap("serving deployment")
    # data parallelism (A14): a one-rank NCCL group, torchrun, two gloo ranks
    dp_counts = data_parallel(kernels, card)
    print(f"launches on the one-rank group's fits: "
          f"{ {k: c for k, c in dp_counts.items() if c} }")
    lap("data_parallel")
    # tensor and expert parallelism (A14): two gloo ranks on tp, ep and dp meshes
    tp_counts, tp_shapes = tensor_parallel(kernels, card)
    print(f"launches on the tensor_parallel phase's ranks: "
          f"{ {k: c for k, c in tp_counts.items() if c} }")
    tp_path = (fk.TAIL_KERNEL, fkb.KERNEL, att.KERNEL, att.DROPOUT_KERNEL, att.BWD_KERNEL,
               att.KERNEL_BF16, att.BWD_KERNEL_BF16, ca.FWD_KERNEL_FP32, ca.BWD_KERNEL_FP32)
    unused = [k.name for k in tp_path if tp_counts[k.name] == 0]
    if unused:
        raise AssertionError(f"the tensor_parallel phase never launched {unused}")
    lap("tensor_parallel")
    # sequence parallelism (A14): two gloo ranks on dp 1 x sp 2
    sp_counts, sp_peaks = sequence_parallel(kernels, card)
    print(f"launches on the sequence_parallel phase's ranks: "
          f"{ {k: c for k, c in sp_counts.items() if c} }; each rank's peak allocated bytes "
          f"against one process's: {sp_peaks}")
    sp_path = (fk.TAIL_KERNEL, fk.KERNEL, fkb.KERNEL, att.KERNEL, att.DROPOUT_KERNEL,
               att.BWD_KERNEL, att.DROPOUT_KERNEL_BF16_MANY, att.BWD_KERNEL_BF16_MANY,
               ca.FWD_KERNEL, ca.BWD_KERNEL)
    unused = [k.name for k in sp_path if sp_counts[k.name] == 0]
    if unused:
        raise AssertionError(f"the sequence_parallel phase never launched {unused}")
    lap("sequence_parallel")
    # sequence parallelism for every other family (A14): two gloo ranks on dp 1 x sp 2
    spf_counts, spf_peaks = sequence_parallel_families(kernels, card)
    print(f"launches on the sequence_parallel_families phase's ranks: "
          f"{ {k: c for k, c in spf_counts.items() if c} }; each rank's peak allocated bytes "
          f"against one process's: {spf_peaks}")
    spf_path = (att.KERNEL, att.DROPOUT_KERNEL, att.BWD_KERNEL, att.KERNEL_BF16,
                att.BWD_KERNEL_BF16, *many, *fp32_many, ca.FWD_KERNEL, ca.BWD_KERNEL,
                ca.FWD_KERNEL_FP32, ca.BWD_KERNEL_FP32)
    unused = [k.name for k in spf_path if spf_counts[k.name] == 0]
    if unused:
        raise AssertionError(f"the sequence_parallel_families phase never launched {unused}")
    lap("sequence_parallel_families")
    # pipeline parallelism (A14): two gloo ranks on dp 1 x pp 2, GPipe and 1F1B
    pp_counts, pp_peaks = pipeline_parallel(kernels, card)
    print(f"launches on the pipeline_parallel phase's ranks: "
          f"{ {k: c for k, c in pp_counts.items() if c} }; each rank's peak allocated bytes "
          f"against one process's: {pp_peaks}")
    pp_path = (fk.TAIL_KERNEL, fk.KERNEL, fkb.KERNEL, att.KERNEL, att.DROPOUT_KERNEL,
               att.BWD_KERNEL, att.KERNEL_BF16, att.DROPOUT_KERNEL_BF16, att.BWD_KERNEL_BF16,
               ca.FWD_KERNEL, ca.BWD_KERNEL)
    unused = [k.name for k in pp_path if pp_counts[k.name] == 0]
    if unused:
        raise AssertionError(f"the pipeline_parallel phase never launched {unused}")
    lap("pipeline_parallel")
    # the native host loader (A9) on the utkinects training path, rng_impl, the side channels
    native_counts = native_loader(kernels, card, state_dict)
    lap("native_loader")
    tp_shape_err = {k.name: tp_shapes[key][1] for k, key in (
        (att.KERNEL, "K3 fp32"), (att.DROPOUT_KERNEL, "K4 fp32"), (att.BWD_KERNEL, "K5 fp32"),
        (att.KERNEL_BF16, "K3 bf16"), (att.DROPOUT_KERNEL_BF16, "K4 bf16"),
        (att.BWD_KERNEL_BF16, "K5 bf16"), (ca.FWD_KERNEL, "K6 bf16"), (ca.BWD_KERNEL, "K7 bf16"),
        (ca.FWD_KERNEL_FP32, "K6 fp32"), (ca.BWD_KERNEL_FP32, "K7 fp32"))}
    a114 = {   # this slice's paths, a column each in the kernels line
        "ntu_launches": {k.name: sum(c[k.name] for c in ntu.values()) for k in kernels},
        "depth_launches": darai[DEPTH_MODEL][0], "depth_sweep_launches": darai[DEPTH_MODEL][1],
        "moe_launches": moe_train, "moe_serving_launches": moe_serving,
        "gt_launches": gt_counts, "l3_launches": l3_counts,
        "bf16_launches": bf16_counts,   # the fusion models in bf16
        # serving deployment (A13): the live and the exported sessions
        "deploy_launches": deploy_live, "deploy_exported_launches": deploy_exported,
        "dp_launches": dp_counts,   # the one-rank NCCL group's three fits (A14)
        "tp_launches": tp_counts,   # the two ranks' tp, ep and dp arms (A14), both summed
        "sp_launches": sp_counts,   # the two ranks' sp arms (A14), both summed
        "spf_launches": spf_counts,   # the two ranks' arms of every other family on sp
        "pp_launches": pp_counts,   # the two ranks' GPipe and 1F1B arms on pp, both summed
        "native_launches": native_counts}   # the fit fed by the native loader

    def a114_columns(name):
        return {**{col: counts[name] for col, counts in a114.items()},
                "tp_shape_rel_err": tp_shape_err.get(name)}

    rows = []
    utk = (counts, serving_counts)
    utkn = (n_counts, n_serving)
    sal = (s_counts, s_serving)
    s_prop, b_prop = proposed["50salads_proposed"], proposed["breakfast_proposed"]
    self_rows = []
    for (B, H, S, D), path in zip(SELF_TIMED, (s_prop, b_prop)):
        for k, key, replaces in (
                (att.KERNEL_BF16_MANY, "K3", "r3d_tpu/ops/attention.py:38"),
                (att.DROPOUT_KERNEL_BF16_MANY, "K4", "r3d_tpu/ops/attention.py:192"),
                (att.BWD_KERNEL_BF16_MANY, "K5", "r3d_tpu/ops/attention.py:215")):
            self_time[key][S]["eval_chunk_launches"] = path[2].get(k.name, 0)
            self_rows.append((k, self_err[key], self_time[key][S], replaces, path,
                              f" Lq=Lk={S} D={D}"))
    for k, err, t, replaces, path, suffix in [r + ("",) for r in (
        (fk.KERNEL, (k1_err, k1_err), k1_time, "r3d_tpu/ops/fuser_kernel.py:180", utk),
        (fk.TAIL_KERNEL, (k1t_err, k1t_err), k1t_time, "r3d_tpu/ops/fuser_kernel.py:180", utk),
        (fkb.KERNEL, k2_err, k2_time, "r3d_tpu/ops/fuser_kernel_bwd.py:70", utk),
        (att.KERNEL, (k3_err, k3_err), k3_time, "r3d_tpu/ops/attention.py:38", utk),
        (att.DROPOUT_KERNEL, (k4_err, k4_err), k4_time, "r3d_tpu/ops/attention.py:192", utk),
        (att.BWD_KERNEL, k5_err, k5_time, "r3d_tpu/ops/attention.py:215", utk),
        (att.KERNEL_BF16, bf16_err["K3"], bf16_time["K3"], "r3d_tpu/ops/attention.py:38", sal),
        (att.DROPOUT_KERNEL_BF16, bf16_err["K4"], bf16_time["K4"],
         "r3d_tpu/ops/attention.py:192", sal),
        (att.BWD_KERNEL_BF16, bf16_err["K5"], bf16_time["K5"], "r3d_tpu/ops/attention.py:215",
         sal),
        (ca.FWD_KERNEL, k6_err, k6_time, "r3d_tpu/ops/cross_attention.py:50", sal),
        (ca.BWD_KERNEL, k7_err, k7_time, "r3d_tpu/ops/cross_attention.py:115", sal),
        # fp32 K6/K7: the utkinects 1024/2000 buckets under R3D_CROSS_NATIVE=1
        (ca.FWD_KERNEL_FP32, k6f_err, k6f_time, "r3d_tpu/ops/cross_attention.py:50", utkn),
        (ca.BWD_KERNEL_FP32, k7f_err, k7f_time, "r3d_tpu/ops/cross_attention.py:115", utkn),
    )] + self_rows:
        rows.append({
            "name": k.name + (" fp32" if "fp32" in t["shape"] and "fp32" not in k.name else "")
            + suffix, "route": "cuda",
            "source": f"r3d_tpu_torch/csrc/{k.source}",
            "replaces": replaces, "launches": path[0][k.name],
            "serving_launches": path[1][k.name],
            "cli_launches": cli_train[k.name], "cli_sweep_launches": cli_sweep[k.name],
            "cache_epoch_launches": cache_counts[k.name],
            "proposed_launches": s_prop[0][k.name], "proposed_sweep_launches": s_prop[1][k.name],
            "breakfast_launches": b_prop[0][k.name],
            "breakfast_sweep_launches": b_prop[1][k.name],
            "darai_launches": darai["darai"][0][k.name],
            "darai_sweep_launches": darai["darai"][1][k.name],
            "darai_gaze_launches": darai["darai_gaze"][0][k.name],
            "darai_gaze_sweep_launches": darai["darai_gaze"][1][k.name],
            "ablation_launches": sum(a[0][k.name] for a in ablation.values()),
            "ablation_sweep_launches": sum(a[1][k.name] for a in ablation.values()),
            "depth2_launches": depth2_counts[k.name],
            "encoder_launches": enc["fit"][k.name],
            "encoder_serving_launches": enc["serving"][k.name],
            **a114_columns(k.name),
            "max_abs_err": err[0], "max_err": err[1],
            "shape": t["shape"], "ms": t["ms"], "kernel_ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_device_ms": t["library_device_ms"],
            **{key: t[key] for key in ("route_ms", "plain_route_ms", "eval_chunk_launches",
                                       "no_out32_device_ms", "dq_launch_device_ms", "peak_bytes")
               if key in t},
        })
    # this slice's rows: K1 and K2 with the outer residual on the grad
    # variant's path (its training and sweep), fp32 K3-K5 with S queries on
    # the encoder's (the fit over its 512 and 2000 buckets, and the serving
    # run's bucket of that S)
    grad_train, grad_sweep = ablation["futr_fusion_grad"]
    new_rows = [
        (fk.TAIL_KERNEL_OUTER, (k1t_err, k1t_err), k1o_time, "r3d_tpu/ops/fuser_kernel.py:180",
         grad_train[fk.TAIL_KERNEL_OUTER.name], grad_sweep[fk.TAIL_KERNEL_OUTER.name], ""),
        (fkb.KERNEL_OUTER, k2_err, k2o_time, "r3d_tpu/ops/fuser_kernel_bwd.py:70",
         grad_train[fkb.KERNEL_OUTER.name], grad_sweep[fkb.KERNEL_OUTER.name], "")]
    for S in SELF32_TIMED:
        for k, key, replaces in ((att.KERNEL_MANY, "K3", "r3d_tpu/ops/attention.py:38"),
                                 (att.DROPOUT_KERNEL_MANY, "K4", "r3d_tpu/ops/attention.py:192"),
                                 (att.BWD_KERNEL_MANY, "K5", "r3d_tpu/ops/attention.py:215")):
            new_rows.append((k, self32_err[key], self32_time[key][S], replaces,
                             enc["fit"][k.name], enc["per_bucket"][S][k.name], f" Lq=Lk={S}"))
    for k, err, t, replaces, launches, serving, suffix in new_rows:
        rows.append({
            "name": k.name + (" fp32" if "fp32" in t["shape"] else "") + suffix,
            "route": "cuda", "source": f"r3d_tpu_torch/csrc/{k.source}", "replaces": replaces,
            "launches": launches, "serving_launches": serving,
            **a114_columns(k.name),
            "max_abs_err": err[0], "max_err": err[1], "shape": t["shape"], "ms": t["ms"],
            "kernel_ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            **{key: t[key] for key in ("bound_fp32_ms", "cluster_ms", "cluster_device_ms",
                                       "train_ms", "train_device_ms", "dq_launch_device_ms",
                                       "err_vs_fp64", "cluster_err_vs_fp64", "plain_err_vs_fp64")
               if key in t}})
    # the bf16 K1/K2 rows (A18): launches on the bf16 utkinects path, its
    # sweep's, and the ablations' bf16 steps'
    for k in bf16_fuser:
        err, t = fuser_bf16[k.name]
        rows.append({
            "name": k.name, "route": "cuda", "source": f"r3d_tpu_torch/csrc/{k.source}",
            "replaces": ("r3d_tpu/ops/fuser_kernel_bwd.py:70" if "bwd" in k.name
                         else "r3d_tpu/ops/fuser_kernel.py:180"),
            "launches": bf16_counts[k.name], "bf16_sweep_launches": bf16_sweep[k.name],
            "bf16_step_launches": bf16_steps[k.name], **a114_columns(k.name),
            "max_abs_err": err[0], "max_bf16_steps": err[1],
            ("max_err" if "bwd" in k.name else "share_off"): err[2],
            "shape": t["shape"], "ms": t["ms"], "kernel_ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"]})
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s "
          f"({json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    if sys.argv[1:2] == [CLI_WORKER]:
        cli_worker(sys.argv[2:])
    else:
        sys.exit(cards_main() if sys.argv[1:2] == [CARDS] else main())
