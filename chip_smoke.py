"""On-card smoke run of the PyTorch/CUDA port (owl_audio_exps_tpu_torch).

Usage (from the repository root, on a machine with one NVIDIA GPU):

    python3 chip_smoke.py

(``python3 chip_smoke.py --packed-fit`` runs only the probe that shows
why phase 14 trains configs/dit_v4.yml with group remat:
``packed_fit_phase``; ``--mmdit-fit`` the one that shows why phase 15
trains configs/mmdit_v2.yml with block remat: ``mmdit_fit_phase``;
``--decode`` the decode kernel's rows alone: ``decode_phase``.)

Phases, each of which exits non-zero on any failure:

1. environment: card name and power limit, torch version, nvcc build of
   every kernel under owl_audio_exps_tpu_torch/csrc/ (build time and the
   -Xptxas -v lines printed), and cuobjdump -sass of every library: each
   kernel of K1/K4 and of the band (K2/K3, and K5 behind its plan check)
   must hold wgmma (HGMMA) and TMA (UTMALDG) instructions and no mma.sync
   (HMMA);
2. each kernel against its plain PyTorch version on the card, at the
   geometries the serve and training paths give it, with its time, its
   TFLOP/s and share of its bound, the plain version's time, its bound and
   the time of one library call that
   computes the same function (a yardstick the port never calls): the
   frame-mask forward (K1), its dq and dkv backward kernels, and the
   band forward and backward (K2/K3), output and gradients held at every
   head against (autograd of) the plain version, 2 heads at a time; K1
   with documents (its kDoc bodies) at five layouts, each at Dh 64 and
   128: 24 documents of 8-40 frames at L 16,384 (L 4,096 at Dh 128),
   boundaries inside tiles at tpf 65, ids that decrease and repeat
   (causal with a window, and bidirectional), boundaries on tile edges;
   at every K1 row with documents (here and in phases 14 and 16) the
   summary kernel's output is held int for int against its plain version
   (ops/doc_tiles.py doc_tiles), and document-free K1 is timed at the
   same shape, its share of bound printed beside the row's; then the
   decode kernel (ops/decode_attention.py, no TPU counterpart) at the
   cached AV serve's four call shapes, its global call at 8 sessions and
   the prime's two against its plain version, its ms a call inside a
   graph beside its bound, the plain version's, and at the four the
   former dense path's and one SDPA call's (``decode_phase``);
3. ``CausvidPipeline`` (window recompute, 60 frames x 65 tokens) at the
   full width of configs/av_v4_8x8.yml made causal (24 layers x 1536,
   24 heads x 64), 2 sampling steps, seeded random bf16 weights: timed
   ticks, one traced tick (device time by kernel class), and one forward
   through the kernel held against the dense attention route;
4. ``AVWindowSampler`` on configs/av_v4_8x8.yml as written, with the
   step and frame counts cut for time (printed);
5. ``RFTTrainer`` on configs/dit_v4_tpu_e2e.yml at full width (16 layers
   x 1536, L = 16,384, Muon with bf16 momentum, group remat), through the
   port's trainer, with the cuts printed: exact kernel launches per step,
   s/step, tokens/s, MFU, peak memory, device time by class of one traced
   step, and an exact resume from the step-6 checkpoint;
6. one training step at full width and 4 layers (L = 4,096) through the
   kernels and through dense attention, loss and gradients compared;
7. context parallelism (configs/dit_v4_98k_sp.yml: 98,304 tokens split
   over 4 seq ranks, 24,576 a rank), as far as one card holds it: the
   ring partial K4 (forward causal and full, backward with an lse
   cotangent) against its plain version at the per-rank geometry, output,
   logsumexp and gradients at every head (2 at a time), with
   its time, the plain version's, its bound and SDPA's; then the ring
   and the halo of all 4 slices of the 98,304-token sequence run in one
   process through parallel/context.py's per-step functions (K/V passed
   on by indexing instead of NCCL), with exact K4 launch counts, held
   against K1 and the band kernel over the whole sequence, forward and
   gradients;
8. the band2 kernel K5 (forward and backward) against its plain version
   at the AV training geometry (L = 24,960 = 384 frames x 65 tokens,
   window 16) at the routed plan (520, 2) under the fixed shift and the
   usual softmax, at the ragged plan (208, 5) and at dit_v4's aligned plan
   (256, 4) (L = 16,384), output and gradients checked at all 24 heads
   (the plain version run 2 heads at a time), with its time, the plain
   version's, its bound and SDPA's;
9. ``AVRFTTrainer`` on configs/av_v5_8x8_weak.yml at full width (24 layers
   x 1536, tpf 65, Muon) at 384 frames, through the port's trainer, with
   the cuts printed: exact kernel launches per step (K5 on the 18 local
   layers, K1 on the 6 global ones), s/step, tokens/s, MFU, peak memory,
   device time by class of one traced step; then ``MixedAVRFTTrainer``
   on configs/av_v5_mixed.yml with the same cuts;
10. the audio serve of bench_torch.py (``AudioCachingSampler`` over the
   ring KV cache, ``AudioRFTCore`` 16 layers x d 1024, a 120-token ring,
   240 new tokens, seeded bf16 weights), which reaches no kernel of the
   port (its attention is plain PyTorch, as the JAX package's is plain
   XLA): three cached forwards (a 119-token prefill, a fused 2-token
   forward that commits one token, a decoding forward) against one
   uncached forward of the same tokens, on the split and the single
   ring; the CUDA-graph token loop against the eager step on the same
   draws; int8 weights and the int8 ring against bf16; RTF of bf16, int8
   and 32 int8 streams, ms and kernels per token with and without the
   graph, and the device-busy share of one traced 16-token window;
11. the KV-cached video and AV serve, which reaches none of K1-K5 either
   (cached attention takes the decode kernel, counted apart in
   ops/decode_attention.py ``launches``): ``AVCachingSamplerV2`` on
   configs/dit_v4.yml at full width (16 layers x 1536) on the eval's clip
   (60 frames, 30 of them context), the config's 16 steps and the 2-step
   [1.0, 0.5] schedule with CFG 1.3, graph against eager on the same
   draws, frames/s, and its cached forwards against one uncached forward;
   ``CausalAVWindowSampler`` on configs/av_v5_8x8_weak.yml (24 layers,
   W 16, 4 steps, CFG 1.3) for a few frames, step 0 against the uncached
   forward; ``AVCachedStreamingPipeline`` at configs/causvid.yml's width
   (24 layers x 1536, tpf 65, a 120-frame ring, 2 steps, fused write) for
   1 and 8 sessions: the graphed steady tick against the eager tick, ms
   and kernels a tick, the device-busy share of one traced tick, and one
   session run across a RoPE rebase; every port kernel's launches there
   must be 0;
12. the distillation trainers at the width of configs/dit_v4_dmd.yml,
   dit_v4_sf.yml and dit_v4_prune.yml (16 x d 1536, tpf 64, a 60-frame
   window: L = 3,840, which the band span 1,024 does not divide, so every
   layer of teacher, student and critic takes K1), from a seeded dit_v4
   teacher saved with save_clean_export and read back by versatile_load,
   with the cuts printed (synthetic data, accumulation 1; for the ODE
   trainer AdamW for Muon, batch 1 and no student_ckpt, each naming the
   reference's reason): 2 outer steps of ``CausVidTrainer`` (10 critic
   and 2 student steps), 1 of ``SelfForceTrainer`` and 1 of
   ``DistillODETrainer`` (the 8-layer student pruned from the teacher;
   8 trajectory states stacked on the batch axis, so K1 runs at B 8),
   with exact K1 launches per critic, student and ODE step, seconds and
   tokens/s per step, peak memory, finite metrics, the teacher
   bit-equal to its export and the student, critic and EMA changed; one
   traced DMD student step; one DMD loss at 4 layers through the kernels
   against dense attention (phase 6's limits); a Self-Forcing rollout
   with its backward that launches no port kernel; and the CausVid
   student's export served by the config's ``av_caching`` sampler (2
   steps at [1.0, 0.5]) for a few frames, launching no port kernel;
13. the VAEs and the decoded serve, which reach no kernel of the port
   either (the convolutions are cuDNN's, as the JAX package leaves them to
   XLA): the DC-AE decoder at its dc-ae-f64c128 widths with
   configs/causvid.yml's 64 latent channels (208,114,691 seeded bf16
   parameters) at batch 1 and 8, ms a frame, TFLOP/s counted from the
   shapes, share of the bound, peak memory, bf16 against float32 on the
   same weights; the bridge's audio decoder on one latent and a
   120-latent window, its encoder on 16 x 88,200 samples, bf16 against
   float32, and both forms of every transposed convolution in float32;
   ``AVCachedStreamingPipeline`` as in phase 11 decoding every tick
   through DC-AE and the audio decoder at 1 and 8 sessions beside an
   undecoded pipeline on the same draws (each decoded tick equal to the
   decoders applied to the undecoded tick's latents); the headless game
   loop (inference/game_cv.py) with --vae dcae; ``AudioVAETrainer`` on
   configs/audio_vae.yml as written for 6 steps on seeded tone files
   (s/step, audio-seconds a second, peak memory, params and EMA changed);
   and one AV clip sampled by configs/av_v5_8x8_weak.yml's eval sampler,
   decoded through the AV trainer's decoders (vae_id dcae) and written as
   a WAV;
14. the latent data loaders and MeanFlow: (a) an npy table of 80
   documents of 200-2,000 frames (seeded float16 128 x 8 x 8 latents,
   mouse, buttons) written with the port's NpyTable, and
   configs/dit_v4.yml as written (``sequence_packing``, a 1,536-frame
   window: L = 98,304, batch 1, Muon, 16 x d 1536) trained 3 steps from
   it through ``RFTTrainer`` and the prefetcher, with the cuts printed
   (the table, accumulation 1, the eval past the run, group remat):
   exact K1 launches per step (a doc_id sends every layer to K1, no
   band), s/step, tokens/s, MFU, peak memory, one traced step by class,
   the loader's time per batch and the share of the step spent waiting
   on the prefetch queue; (b) K1 with the documents of a 256-frame packed
   window (L 16,384) forward and backward against its plain version at
   every head, global and local, with its bound and SDPA's time; at the
   full window (L 98,304) forward and backward at every head against the
   plain version taken 4,096 queries at a time, and the packed output
   against K1 run on each document's span alone; the native gather
   against its plain version byte for byte, both timed on a warm page
   cache at the windows of two cod configs and the packed one;
   (c) ``game_mft_audio`` under ``AVRFTTrainer`` at the width of
   configs/av_v5_8x8_weak.yml (24 x d 1536, tpf 65) at 15 frames (975
   tokens, dense attention; cuts printed), 3 steps with 0 port-kernel
   launches, the loss and its parts, the parameters moved; then one
   forward of the objective at 16 frames (1,040 tokens), whose jvp reaches
   K1 and raises (the kernels refuse a torch.func transform), as the
   reference's jvp raises at the splash kernel's custom_vjp.

15. the dual-stream MMDiT, the UViT and the memory knobs: (a) a cod AV
   table of seeded documents of 1,000-1,400 frames (float16 video 128 x 8
   x 8, audio 64, mouse, buttons), and configs/mmdit_v2.yml (16 x d 1536,
   a 1,000-frame window: L 65,000, Muon, batch 1) trained 3 steps from it
   through ``AVRFTTrainer``, the port's cod loader and the prefetcher,
   with the cuts printed (the table, the batch columns in the AV
   trainer's order, accumulation 1, block remat: without it one step runs
   out of memory, ``python3 chip_smoke.py --mmdit-fit``): exact K1
   launches per step (every layer: the local span 1,040 does not divide
   65,000), s/step, tokens/s, MFU, peak memory, the loader's share, one
   traced step; (b) K1 at that geometry (tpf 65, windows 16 and 256)
   forward and backward at every head against the plain version taken
   4,095 queries at a time, with its bound and SDPA on the same chunks;
   (c) configs/mmdit_v1.yml's av_causal sampler with the config's kwargs
   on a seeded 24 x d 1536 core (cached forwards, no port kernel), the
   window's uncached forward through K1 against dense attention, and
   ``AVRFTTrainer`` on synthetic_av at the written batch 32 (remat, then
   the batch, cut where it does not fit, printed); (d) mmdit_v2's cached
   serve through ``AVCachedStreamingPipeline`` (its av_caching sampler
   refuses an AV core, as the JAX package's fails on one), graphed
   against eager, no port kernel; (e) a 4-layer UViT step at
   av_v4_8x8.yml's widths through K1 against dense attention, and
   dit_v4_tpu_e2e.yml's 4-layer step with ``remat_sequenced``,
   ``fused_head_chunks`` and ``mlp_chunks`` each against the step
   without it (phase 6's limits).

16. the fsdp and tensor axes of configs/dit_v4_5B.yml (36 x d 2560, 40
   heads, 4,304,919,680 seeded parameters) as far as one card holds them
   (the 4-card training and serve are mesh_smoke.py's): (a) the parameter
   tree split by the port's rules (parallel/sharding.py) for every rank
   of {fsdp 4}, {tensor 4} and {fsdp 2, tensor 2}, every rank's shard
   shapes printed, and put together again bit for bit; (b) a global and
   a local block split 4 ways over tensor by the port's own shard
   function, each rank's slice (10 heads, a quarter of the MLP) run in
   turn, the row-parallel partials summed where the all-reduce would,
   forward and backward at L 16,384 with the documents of a packed
   window of a seeded table, against the whole block (rel L2 of the
   output 5e-2, of every gradient 3e-2), with exactly one K1 forward, dq
   and dkv a rank and layer; (c) K1 with those documents at H 40 and H
   10 (the per-rank heads under fsdp and at tensor 4), tpf 64, global
   and window 16, against its plain version at every head, with its
   bound and SDPA's time.

17. the pipe axis, AV context parallelism and distillation over several
   processes as far as one card holds them (the multi-card runs are
   mesh_smoke.py's ``--case pipe`` and ``--case distill`` and
   sp_smoke.py's): (a) configs/dit_v4_tpu_e2e.yml's DiT (16 x d 1536, 4
   groups) at L 16,384 without documents, batch 2, split by
   parallel/pipeline.py's ``stage_blocks`` into 2 and 4 stages, 2
   micro-batches run in GPipe order with the activations handed over in
   memory, each block checkpointed as in a stage: the output (rel L2 5e-2)
   and every gradient (3e-2) against the whole stack, K1 and the band
   counted exactly per stage and micro-batch and in the backward (the
   stage split and the kernels a stage runs; not parallel/pipeline.py's
   schedule, its transfers or its broadcast, which run across processes
   only: the gloo tests and mesh_smoke.py hold those); (b) one
   global and one local AV layer (tpf 65, H 24) at configs/
   av_v5_8x8_weak.yml's 1,536 frames (L 99,840) split 4 ways, each slice
   in turn through parallel/context.py's ring and halo step functions
   (K4 28 / 16 / 16, the halo band K5 4 / 4), against the unsplit layer
   (K1; K5 at plan (520, 2)) in the same limits; (c) K4 at tpf 65, L_loc
   24,960, causal and unmasked, and the halo band (K5 over 26,000 tokens)
   against their plain versions at every head, with times, bounds and
   SDPA's; (d) configs/dit_v4_dmd.yml's student, critic and teacher split
   for {fsdp 2, tensor 2} and put together again bit for bit.

18. the last modules of the port: (a) a cod AV table at configs/
   av_v4_8x8.yml's shapes (128 x 8 x 8 video, 64 audio channels) and
   inference/build_cache.py writing 4 warm-start buffers of 60 frames
   from it (the config's S3 loader cut to the table, printed); the
   window pipeline (phase 3's core, W 60) warm-started from each by
   ``load_cache``, its buffers bit-equal to the npz, 3 ticks each with
   exactly 48 K1 launches a tick; (b) inference/test_sampling.py as a
   subprocess on configs/av_v4_8x8.yml (``av_window``: K1 on every
   forward, counted exactly) and on configs/dit_v4_tpu_e2e.yml
   (``av_caching``: no port kernel), frames/s of each; (c) phase 5's
   trainer with ``train.profile_dir`` and ``profile_start 1`` for 6
   steps: the Chrome trace of steps 1 to 4 parsed, its K1 and band
   kernels exactly 4 steps' launches, the traced steps' time against
   phase 5's; (d) the same trainer with ``train.watch`` norms and full:
   every group's norms finite, the histograms counting every element,
   the step time against phase 5's. No checkpoint is written.

The last lines are the kernels' JSON record, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
# kernel vs plain version (f32 on the same bf16 inputs): the kernel
# rounds P to bf16 before PV and writes bf16 output (2^-9 relative)
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 2e-2, 2e-3
# full-width core forward, kernel vs dense attention, relative L2 error
FORWARD_REL_L2 = 5e-2
SERVE_TICKS = 6   # timed ticks after one warm tick
# gradients: kernel (bf16 in and out, bf16 P and dS) against autograd of
# the plain version in float32 on the same bf16 inputs, relative L2 per
# tensor
GRAD_REL_L2 = 2e-2
# the plain version's f32 scores take ~1 GB per head at L = 16,384: every
# kernel is checked at every head against it, run this many heads at a
# time, and the plain version is timed over head chunks of this size
LONG_L, CHECK_HEADS = 8192, 2
TRAIN_STEPS = 6   # the config's save_interval: step 6 is saved and resumed
# one full-width 4-layer training step, kernels vs dense attention: loss
# relative difference, gradient relative L2 over all parameters and the
# worst single parameter (24 bf16 layers' worth of rounding in 4)
ROUTE_LOSS_REL, ROUTE_GRAD_REL_L2, ROUTE_PARAM_REL_L2 = 1e-2, 3e-2, 1e-1
# context parallelism: configs/dit_v4_98k_sp.yml's sequence over 4 seq
# ranks; the ring and halo against the full-sequence kernels are held to
# GRAD_REL_L2 per tensor (both sides bf16 kernels)
SP_TOKENS, SP_SHARDS, SP_TPF, SP_WINDOW = 98_304, 4, 64, 16
# AV training: the JAX package's own AV bench length (384 frames, where its
# router takes band2), 4 steps of AVRFTTrainer and 2 of MixedAVRFTTrainer
AV_FRAMES, AV_STEPS, MIXED_STEPS = 384, 4, 2
# launches per AV step under group remat (attention_forwards_per_step):
# K5 on the 18 local layers, K1 on the 6 global ones, no band kernel
AV_LAUNCHES = {"band2_attention_fwd": 48, "band2_attention_bwd": 18,
               "frame_attention_fwd": 18, "frame_attention_bwd_dq": 6,
               "frame_attention_bwd_dkv": 6}
# audio serve: cached forwards against the uncached forward, relative L2
# of the new tokens' velocities (the serve limit, FORWARD_REL_L2); the
# CUDA graph's tokens against the eager step's, max |diff| where cuBLAS
# picks another algorithm under capture (identical is expected)
AUDIO_GRAPH_MAX_ABS = 1e-2
# int8 limits of the JAX package's tests: an int8-weight forward keeps a
# cosine above 0.995 with the float forward (tests/test_wquant.py); a
# decoding forward on the int8 ring stays within 0.05 x max(max |ref|, 1)
# of the bf16 ring's, and the int8-ring sampler within 0.25 max |diff| of
# the bf16-ring sampler on the same draws (tests/test_kv_quant.py)
INT8_FORWARD_COS, INT8_RING_DECODE, INT8_RING_SAMPLER = 0.995, 0.05, 0.25
AUDIO_PROFILE_TOKENS = 16
# the eager step against the graph, and the eager RTF, over the first
# tokens of the serve's 240 (the host-bound eager loop takes ~0.14 s a
# token)
AUDIO_EAGER_TOKENS = 60
# phase 11: the cached video and AV serve. Graph replays against the eager
# loop max |diff| (identical expected; cuBLAS may pick other algorithms
# under capture); the causal window sampler's frames (cut for time); the
# AV pipeline's ring, steps, sessions, context and tick counts
CACHED_GRAPH_MAX_ABS = 1e-2
# the dit_v4 sampler's eager loop, held against the graph over the first
# frames of the clip's 30 (the eager 16-step loop takes ~0.75 s a frame)
CACHED_EAGER_FRAMES = 10
CAUSAL_FRAMES = 3
PIPE_WINDOW, PIPE_STEPS, PIPE_SESSIONS = 120, 2, (1, 8)
PIPE_PRIME, PIPE_COMPARE_TICKS, PIPE_TICKS, PIPE_EAGER_TICKS = 8, 8, 30, 8


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2
KERNEL_CASES = [
    # name, L, tpf, causal, window, documents (doc_layout), batch[, Dh]
    ("L3900_causal_w16", 3900, 65, True, 16, None, 1),
    ("L3900_causal_global", 3900, 65, True, None, None, 1),
    ("L1040_bidir_w16", 1040, 65, False, 16, None, 1),
    ("L3900_causal_w16_2docs", 3900, 65, True, 16, "two", 1),
    ("L4096_tpf64_causal_w16", 4096, 64, True, 16, None, 1),
    ("L16384_tpf64_causal_global", 16384, 64, True, None, None, 1),
    ("L24960_tpf65_causal_global", 24960, 65, True, None, None, 1),
    # the distillation window (phase 12): every layer at L 3,840, and the
    # ODE student's 8 trajectory states on the batch axis
    ("L3840_tpf64_causal_w16", 3840, 64, True, 16, None, 1),
    ("L3840_tpf64_causal_global", 3840, 64, True, None, None, 1),
    ("L3840_tpf64_causal_w16_B8", 3840, 64, True, 16, None, 8),
    ("L3840_tpf64_causal_global_B8", 3840, 64, True, None, None, 8),
] + [  # K1's document walk (the kDoc bodies) at Dh 64 and 128
    (name + sfx, L, tpf, causal, window, docs, 1, Dh)
    for name, L, tpf, causal, window, docs in (
        ("L16384_tpf64_causal_global_24docs", 16384, 64, True, None,
         "many"),
        ("L4160_tpf65_causal_global_midtile", 4160, 65, True, None,
         "midtile"),
        ("L4096_tpf64_causal_w16_decreasing", 4096, 64, True, 16, "odd"),
        ("L4096_tpf64_bidir_global_decreasing", 4096, 64, False, None,
         "odd"),
        ("L4096_tpf64_causal_global_tile_edges", 4096, 64, True, None,
         "edges"))
    for sfx, Dh in (("", 64), ("_Dh128", 128))
    if not (Dh == 128 and L > 8192)] + [
    ("L4096_tpf64_causal_global_many_Dh128", 4096, 64, True, None, "many",
     1, 128)]


def by_heads(fn, *ts, chunk: int = CHECK_HEADS):
    """fn over head chunks of [B, H, L, Dh] tensors: the plain version's
    f32 scores at long L do not fit all 24 heads at once."""
    return [fn(*(t[:, h:h + chunk] for t in ts))
            for h in range(0, ts[0].shape[1], chunk)]


def abs_err(a, b):
    """(max |a - b|, sum |a - b|), a against the f32 reference b."""
    d = (a.float() - b).abs()
    return d.max().item(), d.sum().item()


def two_doc_ids(dev, L, tpf):
    nf = -(-L // tpf)
    return (torch.arange(nf, device=dev) >= nf // 3).int()[None]


def doc_layout(dev, kind, L, tpf):
    """Per-frame ids [1, n_frames] int32 of a phase-2 layout: "two"
    documents (a third and two thirds); "many" short ones, seeded: 24 of
    8-40 frames at 256 frames, else of 8-12 frames; "midtile", documents
    of 7, 11, 13 and 17 frames in turn (at tpf 65 every boundary falls
    inside a 128-row tile); "odd", runs of 5 frames with ids 2, 1, 0, 2,
    1, 0, ... (ids that decrease, each id in many runs); "edges",
    documents of 6, 10, 16 and 32 frames (at tpf 64 every boundary on a
    tile edge)."""
    nf = -(-L // tpf)
    if kind == "two":
        return two_doc_ids(dev, L, tpf)
    g = torch.Generator().manual_seed(24)
    if kind == "many" and nf == 256:   # 24 documents of 8-40 frames
        sizes = [8] * 24
        while sum(sizes) < nf:
            i = int(torch.randint(24, (1,), generator=g))
            sizes[i] += sizes[i] < 40
    elif kind == "many":   # fewer frames: documents of 8-12 frames
        sizes = []
        while sum(sizes) < nf:
            sizes.append(int(torch.randint(8, 13, (1,), generator=g)))
    elif kind in ("midtile", "edges"):
        cycle = (7, 11, 13, 17) if kind == "midtile" else (6, 10, 16, 32)
        sizes = [cycle[i % 4] for i in range(nf)]
    elif kind == "odd":
        sizes = [5] * nf
    else:
        fail(f"unknown document layout {kind}")
    ids = torch.cat([torch.full((n,), (2 - i % 3) if kind == "odd" else i)
                     for i, n in enumerate(sizes)])[:nf]
    return ids.int()[None].to(dev)


# the document summary kernel (ops/doc_tiles.py) at each K1 case with
# documents: {case: row of the kernels' record}
DOC_SUMMARY_ROWS = {}


def doc_summary_case(name, q, doc, tpf, window, causal):
    """The summary kernel's output for K1 with ``doc`` at this mask, held
    int for int against the plain doc_tiles, timed with its plain version
    and its bound (bytes: the ids read, the summary written). Returns the
    DocTiles the case's kernels are timed on."""
    from owl_audio_exps_tpu_torch.ops import doc_tiles, splash
    L = q.shape[2]
    docs = splash.doc_tiles_for(doc, q, tpf, window, causal)
    want = doc_tiles.doc_tiles(doc.cpu(), L, tpf, window, causal)
    equal = torch.equal(docs.summary.cpu(), want)
    ms = cuda_ms(lambda: doc_tiles.doc_tiles_cuda(docs.doc, L, tpf, window,
                                                  causal), 20)
    plain_ms = cuda_ms(lambda: doc_tiles.doc_tiles(docs.doc, L, tpf, window,
                                                   causal), 5)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
               max_abs_err=0.0 if equal else float(
                   (docs.summary.cpu() - want).abs().max()),
               **bound_row(0.0, 4.0 * (docs.doc.numel()
                                       + docs.summary.numel())))
    DOC_SUMMARY_ROWS[name] = row
    print(f"[kernel] doc_tiles {name}: summary of {n_docs(doc)} documents "
          f"{'equal to' if equal else 'DIFFERS from'} the plain doc_tiles "
          f"int for int; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{row['bound_ms']:.3e} ms (bytes)", flush=True)
    if not equal:
        fail(f"{name}: the document summary kernel disagrees with its "
             f"plain version")
    return docs


def pairs_of(L, tpf, window, causal, doc, B=1):
    from owl_audio_exps_tpu_torch.ops import splash
    return sum(splash.visible_pairs(
        L, tpf, window, causal, None if doc is None else doc[b].tolist())
        for b in range(B))


def bound_row(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9)


def library_ms(fn, iters: int):
    """Time one PyTorch library call (the yardstick); None if the library
    cannot run it here (printed)."""
    try:
        return cuda_ms(fn, iters, 1)
    except (RuntimeError, torch.OutOfMemoryError) as e:
        print(f"[kernel]   library call unavailable: {str(e)[:120]}",
              flush=True)
        torch.cuda.empty_cache()
        return None


def sdpa_mask(dev, L, tpf, window, causal, doc):
    from owl_audio_exps_tpu_torch.ops.masks import dense_mask
    mask = dense_mask(L, tpf, window, None if doc is None else doc.long(),
                      0, causal, device=dev)
    return mask[None, None] if mask.ndim == 2 else mask[:, None]


def n_docs(doc) -> int:
    return 1 if doc is None else len(set(doc[0].tolist()))


def fwd_case(dev, gen, name, L, tpf, causal, window, doc, B, H=24, Dh=64,
             plain=None, library=True):
    """K1's forward at one geometry (``doc`` per-frame [B, n_frames] or
    None) against its plain version (``plain``, by default the port's
    splash_attention_plain) at every head, with its time, bound, plain
    and SDPA times (``library``: one SDPA call with the dense mask, False
    for none, or a callable on (q, k, v) such as query_chunked_sdpa's):
    the row of the kernels' record."""
    import torch.nn.functional as F
    from owl_audio_exps_tpu_torch.ops import splash

    plain_fn = plain or splash.splash_attention_plain
    q, k, v = (torch.randn(B, H, L, Dh, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    args = (tpf, window, causal, doc)
    long = B * L >= LONG_L
    out = splash.splash_attention(q, k, v, *args)
    # the kernel timed alone: on the summary made (and checked) once
    targs = args if doc is None else (tpf, window, causal, doc_summary_case(
        name, q, doc, tpf, window, causal))
    if not torch.isfinite(out).all():
        fail(f"{name}: kernel output not finite")
    # every head against the plain version in f32, CHECK_HEADS at a time
    stats = by_heads(lambda o, *t: abs_err(
        o, plain_fn(*(x.float() for x in t), *args)), out, q, k, v)
    max_abs = max(m for m, _ in stats)
    mean_abs = sum(a for _, a in stats) / out.numel()

    iters = 5 if long else 20
    ms = cuda_ms(lambda: splash.splash_attention(q, k, v, *targs), iters)
    # the training path's forward also writes the logsumexp
    ms_lse = cuda_ms(lambda: splash.frame_attention_cuda(
        q, k, v, *targs, return_lse=True), iters)
    plain = (lambda: by_heads(lambda *t: plain_fn(*t, *args), q, k, v)) \
        if long else (lambda: plain_fn(q, k, v, *args))
    if long:
        # warm up on one head chunk, then time every chunk once
        plain_fn(*(t[:, :CHECK_HEADS] for t in (q, k, v)), *args)
        plain_ms = cuda_ms(plain, 1, 0)
    else:
        plain_ms = cuda_ms(plain, 3, 1)
    mask = sdpa_mask(dev, L, tpf, window, causal, doc) \
        if library is True else None
    if callable(library):
        lib_ms = library_ms(lambda: library(q, k, v), iters)
    else:
        lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=Dh ** -0.5), iters) \
            if library else None

    pairs = pairs_of(L, tpf, window, causal, doc, B)
    row = dict(max_abs_err=max_abs, mean_abs_err=mean_abs, ms=ms,
               ms_with_lse=ms_lse, plain_ms=plain_ms, library_ms=lib_ms,
               checked_heads=H,
               **bound_row(4.0 * Dh * pairs * H, 4.0 * B * H * L * Dh * 2))
    row["tflops"] = row["gflop"] / ms
    row["share_of_bound"] = row["bound_ms"] / ms
    if doc is not None:
        row.update(nodoc_row("frame_attention_fwd", name, cuda_ms(
            lambda: splash.splash_attention(q, k, v, tpf, window, causal),
            iters), 4.0 * Dh * pairs_of(L, tpf, window, causal, None, B) * H,
            4.0 * B * H * L * Dh * 2, row))
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"[kernel] frame_attention_fwd {name}: B={B} H={H} L={L} "
          f"Dh={Dh} tpf={tpf} causal={causal} window={window} "
          f"docs={n_docs(doc)} | checked at H={H}: "
          f"max|d|={max_abs:.3e} mean|d|={mean_abs:.3e} | kernel "
          f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
          f"{100 * row['share_of_bound']:.1f}% of bound), with lse "
          f"{ms_lse:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib}, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
          f"{row['gflop']:.2f} GFLOP)", flush=True)
    if max_abs > KERNEL_MAX_ABS or mean_abs > KERNEL_MEAN_ABS:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max {max_abs:.3e} > {KERNEL_MAX_ABS} or mean "
             f"{mean_abs:.3e} > {KERNEL_MEAN_ABS})")
    del q, k, v, out, mask
    torch.cuda.empty_cache()
    return row


def nodoc_row(kernel, name, nodoc_ms, nodoc_flops, nbytes, row):
    """Document-free K1 at a document row's shape, timed in the same run:
    its ms, its share of its own bound (the pairs without documents, the
    same bytes) and the document row's share against it (printed)."""
    nodoc_bound = bound_row(nodoc_flops, nbytes)["bound_ms"]
    share = nodoc_bound / nodoc_ms
    print(f"[kernel] {kernel} {name}: with documents {row['ms']:.4f} ms, "
          f"{100 * row['share_of_bound']:.1f}% of bound; document-free "
          f"{nodoc_ms:.4f} ms, {100 * share:.1f}% of its bound "
          f"{nodoc_bound:.4f} ms: {row['share_of_bound'] / share:.2f}x its "
          f"share", flush=True)
    return dict(nodoc_ms=nodoc_ms, nodoc_bound_ms=nodoc_bound,
                nodoc_share_of_bound=share,
                share_vs_nodoc=row["share_of_bound"] / share)


def kernel_phase(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, L, tpf, causal, window, docs, B, *Dh in KERNEL_CASES:
        doc = doc_layout(dev, docs, L, tpf) if docs else None
        rows[name] = fwd_case(dev, gen, name, L, tpf, causal, window, doc, B,
                              Dh=Dh[0] if Dh else 64)
    return rows


# ------------------------------------------------------- phase 2, gradients
GRAD_CASES = [
    # name, kernel, L, tpf, causal, window, documents (doc_layout), logit
    # bound, batch[, Dh]
    ("L16384_tpf64_causal_global", "frame", 16384, 64, True, None, None,
     None, 1),
    ("L24960_tpf65_causal_global", "frame", 24960, 65, True, None, None,
     None, 1),
    ("L3900_tpf65_causal_w16_2docs", "frame", 3900, 65, True, 16, "two",
     None, 1),
    ("L1040_tpf65_bidir_w16", "frame", 1040, 65, False, 16, None, None, 1),
    ("L16384_tpf64_w16_bound8", "band", 16384, 64, True, 16, None, 8.0, 1),
    ("L16384_tpf64_w16_rowmax", "band", 16384, 64, True, 16, None, None, 1),
    ("L4160_tpf65_w16_bound8", "band", 4160, 65, True, 16, None, 8.0, 1),
    # the distillation window (phase 12), B 1 and the ODE student's B 8
    ("L3840_tpf64_causal_w16", "frame", 3840, 64, True, 16, None, None, 1),
    ("L3840_tpf64_causal_global", "frame", 3840, 64, True, None, None,
     None, 1),
    ("L3840_tpf64_causal_w16_B8", "frame", 3840, 64, True, 16, None, None,
     8),
    ("L3840_tpf64_causal_global_B8", "frame", 3840, 64, True, None, None,
     None, 8),
] + [  # K1's document walk: KERNEL_CASES's document layouts
    (name, "frame", L, tpf, causal, window, docs, None, B, *Dh)
    for name, L, tpf, causal, window, docs, B, *Dh in KERNEL_CASES[11:]]


def rms_normed(t):
    return (t * torch.rsqrt(t.float().pow(2).mean(-1, keepdim=True))
            ).to(torch.bfloat16)


def fwd_bwd_ms(fwd, q, k, v, dout, iters, warmup: int = 1):
    """(forward ms, forward + backward ms) of autograd over ``fwd``
    (``dout`` a tuple of cotangents where ``fwd`` returns a tuple), each
    after ``warmup`` untimed calls."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def both():
        torch.autograd.grad(fwd(*leaves), leaves, dout)

    with torch.no_grad():
        f_ms = cuda_ms(lambda: fwd(*leaves), iters, warmup)
    return f_ms, cuda_ms(both, iters, warmup)


def grad_case(dev, gen, name, kind, L, tpf, causal, window, doc, bound, B,
              H=24, Dh=64, plain=None, library=True):
    """The backward kernels of K1 (``kind`` "frame"; ``doc`` per-frame
    [B, n_frames] or None) or of the band (K2/K3) at one geometry: output
    and gradients against autograd of the plain version (K1's ``plain``
    as in fwd_case) at every head, times, bounds, plain and SDPA times
    (``library`` as in fwd_case); {(kernel, case): row}."""
    import torch.nn.functional as F
    from owl_audio_exps_tpu_torch.ops import band, splash

    rows = {}
    q, k, v, dout = (torch.randn(B, H, L, Dh, generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    if kind == "band":   # unit-RMS q, k as QK rms-norm gives them
        q, k = rms_normed(q), rms_normed(k)
    iters = 5 if B * L >= LONG_L else 20
    if kind == "frame":
        margs = (tpf, window, causal, doc)
        kern = lambda *t: splash.splash_attention(*t, *margs)
        plain_fn = plain or splash.splash_attention_plain
        plain = lambda *t: plain_fn(*t, *margs)
    else:
        margs = (tpf, window, bound)
        kern = lambda *t: band.band_attention(*t, tpf, window,
                                              logit_bound=bound)
        plain = lambda *t: band.band_attention_plain(*t, *margs)
    got = grads_of(kern, q, k, v, dout)
    errs, plain_fwd, plain_bwd = chunked_grad_errors(got, plain, q, k, v,
                                                     dout)
    del got
    torch.cuda.empty_cache()

    pairs = pairs_of(L, tpf, window, causal, doc, B)
    elems, stats = B * H * L * Dh, B * H * L
    nodoc = {}   # document-free K1 at this shape: {part: (ms, flops)}
    if kind == "frame":
        def bwd_ms(margs):
            out, lse = splash.frame_attention_cuda(q, k, v, *margs,
                                                   return_lse=True)
            dq_ms = cuda_ms(lambda: splash.frame_attention_bwd_dq_cuda(
                q, k, v, out, lse, dout, *margs), iters)
            _, delta = splash.frame_attention_bwd_dq_cuda(q, k, v, out, lse,
                                                          dout, *margs)
            return dq_ms, cuda_ms(lambda: splash.frame_attention_bwd_dkv_cuda(
                q, k, v, out, lse, delta, dout, *margs), iters)

        # the kernels timed alone: on the summary made (and checked) once
        dq_ms, dkv_ms = bwd_ms(margs if doc is None else (
            tpf, window, causal, doc_summary_case(name, q, doc, tpf, window,
                                                  causal)))
        timed = {"dq": (dq_ms, bound_row(6.0 * Dh * pairs * H,
                                         12.0 * elems + 8.0 * stats)),
                 "dkv": (dkv_ms, bound_row(8.0 * Dh * pairs * H,
                                           12.0 * elems + 8.0 * stats))}
        if doc is not None:
            free = pairs_of(L, tpf, window, causal, None, B)
            nodoc = dict(zip(("dq", "dkv"), zip(
                bwd_ms((tpf, window, causal, None)),
                (6.0 * Dh * free * H, 8.0 * Dh * free * H))))
    else:
        fwd_ms = cuda_ms(lambda: band.band_attention_cuda(q, k, v, *margs),
                         iters)
        out, lse = band.band_attention_cuda(q, k, v, *margs)
        bwd_ms = cuda_ms(lambda: band.band_attention_bwd_cuda(
            q, k, v, out, lse, dout, *margs), iters)
        timed = {"fwd": (fwd_ms, bound_row(4.0 * Dh * pairs * H,
                                           8.0 * elems + 4.0 * stats)),
                 "bwd": (bwd_ms, bound_row(10.0 * Dh * pairs * H,
                                           16.0 * elems + 4.0 * stats))}
    if kind != "frame":
        del out, lse
    mask = sdpa_mask(dev, L, tpf, window, causal, doc) \
        if library is True else None
    sdpa = library if callable(library) else (
        lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, scale=Dh ** -0.5))
    lib_fwd = lib_bwd = None
    try:
        if library:
            lf, lt = fwd_bwd_ms(sdpa, q, k, v, dout, iters)
            lib_fwd, lib_bwd = lf, lt - lf
    except (RuntimeError, torch.OutOfMemoryError) as e:
        print(f"[kernel]   library call unavailable: {str(e)[:120]}",
              flush=True)
    del mask
    torch.cuda.empty_cache()

    pair_bound = bound_row(10.0 * Dh * pairs * H,
                           16.0 * elems + 4.0 * stats)
    for part, (ms, bnd) in timed.items():
        is_fwd = part == "fwd"
        kname = (f"band_attention_{part}" if kind == "band"
                 else f"frame_attention_bwd_{part}")
        keys = (("out",) if is_fwd else
                (("dq",) if part == "dq" else ("dk", "dv"))
                if kind == "frame" else ("dq", "dk", "dv"))
        rows[(kname, name)] = dict(
            ms=ms, plain_ms=plain_fwd if is_fwd else plain_bwd,
            library_ms=lib_fwd if is_fwd else lib_bwd,
            max_abs_err=max(errs[n][1] for n in keys),
            mean_abs_err=max(errs[n][2] for n in keys),
            rel_l2=max(errs[n][0] for n in keys), checked_heads=H,
            tflops=bnd["gflop"] / ms, share_of_bound=bnd["bound_ms"] / ms,
            **bnd)
        if part in nodoc:
            rows[(kname, name)].update(nodoc_row(
                kname, name, *nodoc[part], 12.0 * elems + 8.0 * stats,
                rows[(kname, name)]))
    lib = ("n/a" if lib_bwd is None else
           f"fwd {lib_fwd:.4f} ms bwd {lib_bwd:.4f} ms")
    print(f"[kernel] {kind} {name}: B={B} H={H} L={L} Dh={Dh} tpf={tpf} "
          f"causal={causal} window={window} docs={n_docs(doc)} "
          f"bound={bound} | checked at H={H}: " + " ".join(
              f"{n} rel={e[0]:.2e} max|d|={e[1]:.2e} mean|d|={e[2]:.2e}"
              for n, e in errs.items()), flush=True)
    print(f"[kernel]   " + " ".join(
        f"{part} {ms:.4f} ms ({bnd['gflop'] / ms:.1f} TFLOP/s, "
        f"{100 * bnd['bound_ms'] / ms:.1f}% of bound "
        f"{bnd['bound_ms']:.4f} ms {bnd['bound_by']})"
        for part, (ms, bnd) in timed.items())
        + f" | plain fwd {plain_fwd:.3f} ms bwd {plain_bwd:.3f} ms | "
        f"sdpa {lib} | backward bound (10 Dh flops/pair) "
        f"{pair_bound['bound_ms']:.4f} ms ({pair_bound['bound_by']})",
        flush=True)
    worst = max(e[0] for e in errs.values())
    if worst > GRAD_REL_L2:
        fail(f"{kind} {name}: kernel disagrees with its plain version "
             f"(relative L2 {worst:.3e} > {GRAD_REL_L2})")
    if errs["out"][1] > KERNEL_MAX_ABS or errs["out"][2] > KERNEL_MEAN_ABS:
        fail(f"{kind} {name}: forward disagrees with its plain version")
    del q, k, v, dout
    torch.cuda.empty_cache()
    return rows


def grad_kernel_phase(dev):
    gen = torch.Generator(device=dev).manual_seed(10)
    rows = {}
    for name, kind, L, tpf, causal, window, docs, bound, B, *Dh in \
            GRAD_CASES:
        doc = doc_layout(dev, docs, L, tpf) if docs else None
        rows.update(grad_case(dev, gen, name, kind, L, tpf, causal, window,
                              doc, bound, B, Dh=Dh[0] if Dh else 64))
    return rows


# ---------------------------------------------------------------- phase 8
BAND2_CASES = [
    # name, L, tpf, window, plan (S, m), logit bound
    ("L24960_tpf65_520x2_bound8", 24960, 65, 16, (520, 2), 8.0),
    ("L24960_tpf65_520x2_rowmax", 24960, 65, 16, (520, 2), None),
    ("L24960_tpf65_208x5_bound8", 24960, 65, 16, (208, 5), 8.0),
    ("L16384_tpf64_256x4_bound8", 16384, 64, 16, (256, 4), 8.0),
]


def chunked_grad_errors(got, plain, q, k, v, dout,
                        names=("out", "dq", "dk", "dv")):
    """The kernel's outputs and gradients ``got`` (``grads_of``, named
    ``names``) at every head against f32 autograd of the plain version on
    the same bf16 inputs, CHECK_HEADS heads at a time (the plain version's
    f32 scores of all heads at long L do not fit at once): {name: (rel L2,
    max|d|, mean|d|)} over all heads. ``dout`` is a tuple of cotangents
    where the function returns a tuple (K4's out and lse). Also times the
    plain version on each chunk (bf16 inputs, f32 scores): returns
    (errors, plain fwd ms, plain bwd ms) summed over the chunks."""
    for name, a in zip(names, got):
        if not torch.isfinite(a).all():
            fail(f"kernel {name} not finite")
    several = isinstance(dout, tuple)
    # per name: squared error, squared reference, max |d|, sum |d|
    acc = {n: [0.0, 0.0, 0.0, 0.0] for n in names}
    plain_fwd = plain_all = 0.0
    for h in range(0, q.shape[1], CHECK_HEADS):
        cut = lambda t: t[:, h:h + CHECK_HEADS]
        part = [cut(t) for t in (q, k, v)]
        g = tuple(map(cut, dout)) if several else cut(dout)
        g32 = tuple(t.float() for t in g) if several else g.float()
        want = grads_of(plain, *(t.float() for t in part), g32)
        for n, a, b in zip(names, got, want):
            d = cut(a).float() - b
            acc[n][0] += d.pow(2).sum().item()
            acc[n][1] += b.pow(2).sum().item()
            acc[n][2] = max(acc[n][2], d.abs().max().item())
            acc[n][3] += d.abs().sum().item()
        del want, d
        # the first chunk warms up the plain version's shapes for all
        f_ms, t_ms = fwd_bwd_ms(plain, *part, g, 1, warmup=int(h == 0))
        plain_fwd, plain_all = plain_fwd + f_ms, plain_all + t_ms
        torch.cuda.empty_cache()
    errs = {n: ((e[0] / e[1]) ** 0.5, e[2], e[3] / a.numel())
            for (n, e), a in zip(acc.items(), got)}
    return errs, plain_fwd, plain_all - plain_fwd


def band2_phase(dev, cases=BAND2_CASES):
    """K5 against its plain version at every head: the kernel's output and
    gradients through autograd at H = 24, against f32 autograd of the plain
    version chunk by chunk; with its time, the plain version's over the
    same chunks, its bound and SDPA's with the same band mask."""
    import torch.nn.functional as F
    from owl_audio_exps_tpu_torch.ops import band2

    B, H, Dh = 1, 24, 64
    gen = torch.Generator(device=dev).manual_seed(30)
    rows = {}
    for name, L, tpf, window, plan, bound in cases:
        q, k, v, dout = (torch.randn(B, H, L, Dh, generator=gen, device=dev)
                         .to(torch.bfloat16) for _ in range(4))
        q, k = rms_normed(q), rms_normed(k)
        margs = (tpf, window, *plan, bound)
        kern = lambda *t: band2.band2_attention(*t, tpf, window, *plan,
                                                logit_bound=bound)
        plain = lambda *t: band2.band2_attention_plain(*t, tpf, window,
                                                       bound)
        got = grads_of(kern, q, k, v, dout)
        errs, plain_fwd, plain_bwd = chunked_grad_errors(got, plain, q, k, v,
                                                         dout)
        del got
        torch.cuda.empty_cache()

        iters = 5
        fwd_ms = cuda_ms(lambda: band2.band2_attention_cuda(q, k, v, *margs),
                         iters)
        out, lse = band2.band2_attention_cuda(q, k, v, *margs)
        bwd_ms = cuda_ms(lambda: band2.band2_attention_bwd_cuda(
            q, k, v, out, lse, dout, *margs), iters)
        del out, lse
        mask = sdpa_mask(dev, L, tpf, window, True, None)
        sdpa = lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, scale=Dh ** -0.5)
        try:
            lf, lt = fwd_bwd_ms(sdpa, q, k, v, dout, iters)
            lib_fwd, lib_bwd = lf, lt - lf
        except (RuntimeError, torch.OutOfMemoryError) as e:
            print(f"[band2]   library call unavailable: {str(e)[:120]}",
                  flush=True)
            lib_fwd = lib_bwd = None
        del mask
        torch.cuda.empty_cache()

        pairs = pairs_of(L, tpf, window, True, None, B)
        elems, stats = B * H * L * Dh, B * H * L
        timed = {"fwd": (fwd_ms, bound_row(4.0 * Dh * pairs * H,
                                           8.0 * elems + 4.0 * stats),
                         ("out",)),
                 "bwd": (bwd_ms, bound_row(10.0 * Dh * pairs * H,
                                           16.0 * elems + 4.0 * stats),
                         ("dq", "dk", "dv"))}
        for part, (ms, bnd, keys) in timed.items():
            rows[(f"band2_attention_{part}", name)] = dict(
                ms=ms, plain_ms=plain_fwd if part == "fwd" else plain_bwd,
                library_ms=lib_fwd if part == "fwd" else lib_bwd,
                max_abs_err=max(errs[n][1] for n in keys),
                mean_abs_err=max(errs[n][2] for n in keys),
                rel_l2=max(errs[n][0] for n in keys),
                checked_heads=H, tflops=bnd["gflop"] / ms,
                share_of_bound=bnd["bound_ms"] / ms, **bnd)
        lib = ("n/a" if lib_bwd is None else
               f"fwd {lib_fwd:.4f} ms bwd {lib_bwd:.4f} ms")
        print(f"[band2] {name}: B={B} H={H} L={L} Dh={Dh} tpf={tpf} "
              f"window={window} plan (S, m)={plan} next ref "
              f"{band2._next_cols(plan[0], tpf)} bound={bound} | checked at "
              f"H={H}: " + " ".join(
                  f"{n} rel={e[0]:.2e} max|d|={e[1]:.2e} mean|d|={e[2]:.2e}"
                  for n, e in errs.items()), flush=True)
        print("[band2]   " + " ".join(
            f"{part} {ms:.4f} ms ({bnd['gflop'] / ms:.1f} TFLOP/s, "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of bound "
            f"{bnd['bound_ms']:.4f} ms {bnd['bound_by']})"
            for part, (ms, bnd, _) in timed.items())
            + f" | plain fwd {plain_fwd:.3f} ms bwd {plain_bwd:.3f} ms | "
            f"sdpa {lib} | {pairs * H / 1e6:.1f} M visible pairs",
            flush=True)
        worst = max(e[0] for e in errs.values())
        if worst > GRAD_REL_L2:
            fail(f"band2 {name}: kernel disagrees with its plain version "
                 f"(relative L2 {worst:.3e} > {GRAD_REL_L2})")
        if errs["out"][1] > KERNEL_MAX_ABS or errs["out"][2] > KERNEL_MEAN_ABS:
            fail(f"band2 {name}: forward disagrees with its plain version")
        del q, k, v, dout
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3
def serve_config():
    from owl_audio_exps_tpu_torch.configs import transformer_config
    return transformer_config(
        model_id="game_rft_audio", sample_size=8, channels=128,
        audio_channels=64, n_layers=24, n_heads=24, d_model=1536,
        tokens_per_frame=65, n_buttons=11, cfg_prob=0.0, n_frames=256,
        causal=True, uncond=False, backbone="dit", has_audio=True,
        rope_impl="ortho", local_window=16, global_window=None)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def profile_tick(pipe, ctrl, tick_ms: float):
    """Trace one tick: device time by kernel class, and its busy share of
    the untraced median tick ``tick_ms`` (one stream, so kernel times do
    not overlap; tracing slows the host, so the traced tick's own wall
    time is longer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        _, _, wall_s = pipe(*ctrl)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in per_name.values())
    if busy_us == 0:
        fail("the profiler recorded no device time")
    classes = {"frame attention kernel": 0.0, "matmul (cuBLAS)": 0.0,
               "other (elementwise, norms, copies)": 0.0}
    for name, (us, _) in per_name.items():
        if "frame_attn" in name:
            classes["frame attention kernel"] += us
        elif any(s in name.lower() for s in ("gemm", "nvjet", "cutlass",
                                              "sm90_xmma")):
            classes["matmul (cuBLAS)"] += us
        else:
            classes["other (elementwise, norms, copies)"] += us
    print(f"[profile] one tick: device busy {busy_us / 1e3:.2f} ms = "
          f"{100 * busy_us / 1e3 / tick_ms:.1f}% of the untraced median "
          f"tick ({tick_ms:.2f} ms); traced wall {1e3 * wall_s:.2f} ms; "
          f"{sum(n for _, n in per_name.values())} kernels", flush=True)
    for cls, us in classes.items():
        print(f"[profile]   {cls}: {us / 1e3:.2f} ms "
              f"({100 * us / busy_us:.1f}% of busy)", flush=True)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        print(f"[profile]   {us / 1e3:9.3f} ms {n:5d}x {name[:100]}",
              flush=True)
    return {k: us / 1e3 for k, us in classes.items()}


def pipeline_phase(dev, n_ticks: int):
    from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore
    from owl_audio_exps_tpu_torch.ops import splash

    cfg = serve_config()
    t0 = time.perf_counter()
    core = GameRFTAudioCore(cfg, dtype=torch.bfloat16, device=dev,
                            seed=0).to(torch.bfloat16).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in core.parameters())
    print(f"[serve] core: {cfg.n_layers} layers x d {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.d_model // cfg.n_heads}, "
          f"{n_params / 1e6:.1f} M params bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    W, steps = 60, 2
    pipe = CausvidPipeline(core, cfg, window_length=W, sampling_steps=steps,
                           seed=0, device=dev)
    ctrl_gen = torch.Generator().manual_seed(1)

    def controls(i):
        mouse = [0.1 * ((i % 7) - 3), 0.05 * ((i % 5) - 2)]
        btn = (torch.rand(cfg.n_buttons, generator=ctrl_gen) > 0.5).float()
        return mouse, btn.numpy()

    frame, audio, warm_s = pipe(*controls(0))
    print(f"[serve] warm tick {1e3 * warm_s:.1f} ms", flush=True)

    splash.launches = 0
    times = []
    for i in range(n_ticks):
        frame, audio, dt = pipe(*controls(i + 1))
        times.append(dt)
        if not (torch.isfinite(frame).all() and torch.isfinite(audio).all()):
            fail(f"tick {i}: non-finite output")
    main_launches = splash.launches
    expect = n_ticks * steps * cfg.n_layers
    if tuple(frame.shape) != (1, cfg.channels, 8, 8) or \
            tuple(audio.shape) != (1, cfg.audio_channels):
        fail(f"tick output shapes {tuple(frame.shape)} {tuple(audio.shape)}")
    if main_launches != expect:
        fail(f"frame attention kernel launched {main_launches} times in "
             f"{n_ticks} ticks, expected {expect}")
    ms = [1e3 * t for t in times]
    tick_ms = statistics.median(ms)
    print(f"[serve] CausvidPipeline W={W} L={W * 65} steps={steps}: "
          f"{n_ticks} ticks, ms/tick median {tick_ms:.2f} min {min(ms):.2f} "
          f"max {max(ms):.2f}; kernel launches {main_launches} "
          f"({main_launches // n_ticks}/tick)", flush=True)

    breakdown = profile_tick(pipe, controls(99), tick_ms)
    splash.launches = main_launches   # the traced tick is not counted

    # one full-width forward: kernel route against the dense route
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    x = torch.randn(1, W, cfg.channels, 8, 8, generator=gen,
                    device=dev).to(bf)
    a = torch.randn(1, W, cfg.audio_channels, generator=gen,
                    device=dev).to(bf)
    ts = torch.full((1, W), 0.2, dtype=bf, device=dev)
    ts[:, -1] = 1.0
    m = torch.randn(1, W, 2, generator=gen, device=dev).to(bf)
    b = (torch.rand(1, W, cfg.n_buttons, generator=gen, device=dev)
         > 0.5).to(bf)
    before = splash.launches
    with torch.inference_mode():
        vk, ak = core(x, a, ts, m, b)
        cfg.attn_impl = "dense"
        vd, ad = core(x, a, ts, m, b)
        cfg.attn_impl = "auto"
    splash.launches = before
    ev, ea = rel_l2(vk, vd), rel_l2(ak, ad)
    print(f"[serve] full-width forward kernel vs dense attention: rel L2 "
          f"video {ev:.3e} audio {ea:.3e} (tolerance {FORWARD_REL_L2})",
          flush=True)
    if not (ev <= FORWARD_REL_L2 and ea <= FORWARD_REL_L2):
        fail("full-width forward through the kernel disagrees with dense")
    del core, pipe, x, a, vk, ak, vd, ad
    torch.cuda.empty_cache()
    return main_launches, tick_ms, breakdown


# ---------------------------------------------------------------- phase 4
def sampler_phase(dev):
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models import get_core_cls
    from owl_audio_exps_tpu_torch.ops import splash
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls

    conf = Config.from_yaml(os.path.join(ROOT, "configs", "av_v4_8x8.yml"))
    cfg = conf.model
    kw = conf.train.sampler_kwargs.to_dict()
    cut = dict(n_steps=2, num_frames=2)
    print(f"[sampler] {conf.train.sampler_id} on configs/av_v4_8x8.yml, "
          f"reduced for time: n_steps {kw['n_steps']} -> {cut['n_steps']}, "
          f"num_frames {kw['num_frames']} -> {cut['num_frames']}", flush=True)
    kw.update(cut)
    core = get_core_cls(cfg.model_id)(cfg, dtype=torch.bfloat16, device=dev,
                                      seed=1).to(torch.bfloat16).eval()
    sampler = get_sampler_cls(conf.train.sampler_id)(**kw)
    W = sampler.window_length
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(1, W, cfg.channels, cfg.sample_size, cfg.sample_size,
                    generator=gen, device=dev).to(bf)
    a = torch.randn(1, W, cfg.audio_channels, generator=gen,
                    device=dev).to(bf)
    m = torch.randn(1, W, 2, generator=gen, device=dev).to(bf)
    b = (torch.rand(1, W, cfg.n_buttons, generator=gen, device=dev)
         > 0.5).to(bf)

    splash.launches = 0
    t0 = time.perf_counter()
    _, _, x_out, a_out, _, _ = sampler(core, x, a, m, b, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = splash.launches
    expect = cut["num_frames"] * cut["n_steps"] * 2 * cfg.n_layers
    n_out = W + cut["num_frames"]
    if tuple(x_out.shape) != (1, n_out, cfg.channels, 8, 8) or \
            tuple(a_out.shape) != (1, n_out, cfg.audio_channels):
        fail(f"sampler output shapes {tuple(x_out.shape)} "
             f"{tuple(a_out.shape)}")
    if not (torch.isfinite(x_out).all() and torch.isfinite(a_out).all()):
        fail("sampler output not finite")
    if launches != expect:
        fail(f"frame attention kernel launched {launches} times, expected "
             f"{expect}")
    print(f"[sampler] AVWindowSampler W={W} L={W * cfg.tokens_per_frame} "
          f"causal={cfg.causal} cfg_scale={sampler.cfg_scale}: "
          f"{cut['num_frames']} frames in {secs:.2f} s; kernel launches "
          f"{launches}", flush=True)
    return launches


# ---------------------------------------------------------------- phase 5
def kernel_counts():
    from owl_audio_exps_tpu_torch.ops import band, band2, splash
    return {"frame_attention_fwd": splash.launches,
            "frame_attention_bwd_dq": splash.dq_launches,
            "frame_attention_bwd_dkv": splash.dkv_launches,
            "band_attention_fwd": band.fwd_launches,
            "band_attention_bwd": band.bwd_launches,
            "ring_partial_fwd": splash.lse_launches,
            "ring_partial_bwd_dq": splash.lse_dq_launches,
            "ring_partial_bwd_dkv": splash.lse_dkv_launches,
            "band2_attention_fwd": band2.fwd_launches,
            "band2_attention_bwd": band2.bwd_launches}


def reset_counts():
    from owl_audio_exps_tpu_torch.ops import band, band2, doc_tiles, splash
    doc_tiles.launches = 0   # K1's document summary, counted apart
    splash.launches = splash.dq_launches = splash.dkv_launches = 0
    splash.lse_launches = splash.lse_dq_launches = 0
    splash.lse_dkv_launches = 0
    band.fwd_launches = band.bwd_launches = 0
    band2.fwd_launches = band2.bwd_launches = 0


def expected_counts(cfg, L: int):
    """Launches of each kernel in one training step of L tokens, from the
    remat structure (nn/attn.py attention_forwards_per_step) and the
    routing (nn/attn.py attention_route): global layers take the
    frame-mask kernels, local layers the band or band2 kernel."""
    from owl_audio_exps_tpu_torch.nn.attn import (attention_forwards_per_step,
                                                  attention_route,
                                                  local_layer_flags)
    fwd = attention_forwards_per_step(cfg)
    flags = local_layer_flags(cfg)
    n_local = sum(flags)
    local = f"{attention_route(cfg, True, L)[0]}_attention"
    counts = dict.fromkeys(kernel_counts(), 0)
    counts.update({
        "frame_attention_fwd": sum(f for f, l in zip(fwd, flags) if not l),
        "frame_attention_bwd_dq": len(flags) - n_local,
        "frame_attention_bwd_dkv": len(flags) - n_local,
        f"{local}_fwd": sum(f for f, l in zip(fwd, flags) if l),
        f"{local}_bwd": n_local})
    return counts


def metric_value(v):
    """A step metric on the host: a float, or a list for a vector (the
    ``train.watch`` histograms)."""
    if torch.is_tensor(v) and v.numel() > 1:
        return v.tolist()
    return float(v)


def counted_trainer(base):
    """A subclass of the trainer class ``base`` that sets every kernel
    count to 0 before each step and appends the counts, the step's wall
    time, its loss and its metrics to ``steps`` after it."""

    class CountedTrainer(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.steps = []

        def train_step(self, state, micro, gen, **kw):
            from owl_audio_exps_tpu_torch.ops import doc_tiles
            reset_counts()
            t0 = time.perf_counter()
            metrics = super().train_step(state, micro, gen, **kw)
            loss = float(metrics["diffusion_loss"])   # waits for the step
            self.steps.append(dict(s=time.perf_counter() - t0, loss=loss,
                                   counts=kernel_counts(),
                                   doc_tiles=doc_tiles.launches,
                                   metrics={k: metric_value(v) for k, v in
                                            metrics.items()}))
            return metrics

    return CountedTrainer


def state_tensors(state):
    out = {f"params.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state.ema.items()})
    for part, sd in state.optimizer.state_dict().items():
        for idx, st in sd["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    out[f"opt.{part}.{idx}.{k}"] = v
    return out


def profile_step(trainer, state, micro, gen, step_s, tag="train"):
    """Device time by kernel class of one traced training step (the
    trainer's own step, outside the counting wrapper: not counted)."""
    from owl_audio_exps_tpu_torch.trainers.base import BaseTrainer
    return profile_call(
        lambda: BaseTrainer.train_step(trainer, state, micro, gen), step_s,
        tag)


def profile_call(fn, step_s, tag):
    """Device time by kernel class of one traced call of ``fn``, printed
    against ``step_s``, the untraced median of such calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    classes = {"K1 fwd (frame_attention_fwd)": 0.0,
               "K1 bwd (dq + dkv)": 0.0,
               "K1 document summary (doc_tiles)": 0.0,
               "band fwd (K2/K3 or K5)": 0.0, "band bwd (K2/K3 or K5)": 0.0,
               "matmul (cuBLAS)": 0.0,
               "other (elementwise, norms, optimizer, copies)": 0.0}
    per_name = {}
    for e in prof.events():
        # user annotations (e.g. "Optimizer.step#Muon.step") are device
        # ranges over kernels already counted
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.elapsed_us()
        n = e.name
        us0, c0 = per_name.get(n, (0.0, 0))
        per_name[n] = (us0 + us, c0 + 1)
        if "frame_attn_fwd" in n:
            classes["K1 fwd (frame_attention_fwd)"] += us
        elif "frame_attn_bwd" in n:
            classes["K1 bwd (dq + dkv)"] += us
        elif "doc_tiles_kernel" in n:
            classes["K1 document summary (doc_tiles)"] += us
        elif "band_attn_fwd" in n:
            classes["band fwd (K2/K3 or K5)"] += us
        elif "band_attn_bwd" in n:
            classes["band bwd (K2/K3 or K5)"] += us
        elif any(t in n.lower() for t in ("gemm", "nvjet", "cutlass",
                                          "sm90_xmma")):
            classes["matmul (cuBLAS)"] += us
        else:
            classes["other (elementwise, norms, optimizer, copies)"] += us
    busy = sum(classes.values())
    if busy == 0:
        fail("the profiler recorded no device time")
    print(f"[{tag}] one traced step: device busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / 1e3 / (1e3 * step_s):.1f}% of the untraced median "
          f"step; {sum(c for _, c in per_name.values())} kernels", flush=True)
    for cls, us in classes.items():
        print(f"[{tag}]   {cls}: {us / 1e3:.2f} ms "
              f"({100 * us / busy:.1f}% of busy)", flush=True)
    for name, (us, c) in sorted(per_name.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"[{tag}]   {us / 1e3:9.2f} ms {c:5d}x {name[:100]}",
              flush=True)
    return {k: us / 1e3 for k, us in classes.items()}


def train_phase(dev):
    import shutil
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import RFTTrainer
    from owl_audio_exps_tpu_torch.utils.mfu import (H100_PEAK_TFLOPS,
                                                    training_flops_per_token)

    path = os.path.join(ROOT, "configs", "dit_v4_tpu_e2e.yml")
    conf = Config.from_yaml(path)
    cfg, tc = conf.model, conf.train
    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    cuts = dict(max_steps=TRAIN_STEPS,
                checkpoint_dir=os.path.join(work, "ckpt"),
                output_path=os.path.join(work, "export"), log_interval=1)
    for key, value in cuts.items():
        print(f"[train] cut from configs/dit_v4_tpu_e2e.yml: {key} "
              f"{tc.get(key)!r} -> {value!r}", flush=True)
        tc[key] = value
    print("[train]   (log_interval 1 drains metrics every step; the config "
          "has no eval loader, so its av_caching eval never samples)",
          flush=True)
    L = tc.data_kwargs.window_length * cfg.tokens_per_frame
    expect = expected_counts(cfg, L)

    CountedTrainer = counted_trainer(RFTTrainer)
    torch.cuda.reset_peak_memory_stats()
    trainer = CountedTrainer(conf, device=dev)
    t0 = time.perf_counter()
    state = trainer.train(max_steps=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[train] RFTTrainer {cfg.n_layers} layers x d {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.d_model // cfg.n_heads}, "
          f"{n_params / 1e6:.1f} M params fp32, L = {L} (tpf "
          f"{cfg.tokens_per_frame}, local window {cfg.local_window}), batch "
          f"{tc.batch_size}, opt {tc.opt} momentum "
          f"{tc.opt_kwargs.momentum_dtype}, remat "
          f"{cfg.remat_granularity}: {TRAIN_STEPS} steps in {wall:.1f} s",
          flush=True)
    for i, st in enumerate(trainer.steps):
        print(f"[train]   step {i + 1}: {st['s']:.3f} s loss "
              f"{st['loss']:.5f} launches {st['counts']}", flush=True)
        if not math.isfinite(st["loss"]):
            fail(f"step {i + 1}: loss not finite")
        if st["counts"] != expect:
            fail(f"step {i + 1}: kernel launches {st['counts']}, expected "
                 f"{expect}")
    timed = [st["s"] for st in trainer.steps[1:]]
    step_s = statistics.median(timed)
    tokens = L * tc.batch_size * trainer.accum_steps()
    mfu = training_flops_per_token(cfg, L) * tokens / step_s / \
        (H100_PEAK_TFLOPS * 1e12)
    print(f"[train] s/step median {step_s:.4f} (steps 2-{TRAIN_STEPS}, min "
          f"{min(timed):.4f} max {max(timed):.4f}), {tokens / step_s:.0f} "
          f"tokens/s, MFU {100 * mfu:.2f}% of {H100_PEAK_TFLOPS:.0f} "
          f"TFLOP/s, peak memory {peak_gb:.2f} GiB "
          f"(max_memory_allocated); launches per step {expect}", flush=True)

    # resume from the step-6 checkpoint: everything restored exactly
    ckpt = trainer.ckpt_path(TRAIN_STEPS)
    conf.train.resume_ckpt = ckpt
    other = CountedTrainer(conf, device=dev)
    restored = other.load(ckpt, other.init_state(seed=1))
    want, got = state_tensors(state), state_tensors(restored)
    if restored.step != state.step or set(want) != set(got):
        fail("resume: step or state keys differ")
    for key in want:
        if got[key].dtype != want[key].dtype or \
                not torch.equal(got[key], want[key]):
            fail(f"resume: {key} differs after restoring {ckpt}")
    print(f"[train] resume from {os.path.relpath(ckpt, ROOT)}: step "
          f"{restored.step}, {len(want)} tensors (params, EMA, optimizer "
          f"state) restored exactly", flush=True)
    del other, restored, want, got
    torch.cuda.empty_cache()

    loader = iter(get_loader(tc.data_id, tc.batch_size,
                             **dict(tc.data_kwargs.items())))
    micro = [trainer.to_device(next(loader))]
    gen = torch.Generator(device=dev).manual_seed(99)
    breakdown = profile_step(trainer, state, micro, gen, step_s)
    totals = {k: sum(st["counts"][k] for st in trainer.steps)
              for k in expect}
    losses = [st["loss"] for st in trainer.steps]
    del trainer, state
    torch.cuda.empty_cache()
    return dict(totals=totals, per_step=expect, step_s=step_s,
                tokens_per_s=tokens / step_s, mfu=mfu, peak_gib=peak_gb,
                losses=losses, device_ms=breakdown)


# ---------------------------------------------------------------- phase 6
def route_phase(dev):
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFT

    conf = Config.from_yaml(os.path.join(ROOT, "configs",
                                         "dit_v4_tpu_e2e.yml"))
    cfg = conf.model
    cfg.n_layers = 4
    n_frames = 64
    dk = dict(conf.train.data_kwargs.items(), window_length=n_frames)
    vid, mouse, btn = [torch.from_numpy(a).to(dev) for a in next(iter(
        get_loader(conf.train.data_id, 1, **dk)))]

    def one_step(attn_impl):
        c = cfg.copy()
        c.attn_impl = attn_impl
        model = GameRFT(c, dtype=torch.bfloat16, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(5)
        loss = model(vid.to(torch.bfloat16), mouse, btn, generator=gen)
        loss.backward()
        return loss.item(), {n: p.grad.float() for n, p in
                             model.named_parameters()}

    reset_counts()
    lk, gk = one_step("auto")
    counts = {k: n for k, n in kernel_counts().items()
              if not k.startswith(("ring_partial", "band2"))}
    if not all(counts.values()):
        fail(f"route check: the kernel route launched {counts}")
    ld, gd = one_step("dense")
    loss_rel = abs(lk - ld) / abs(ld)
    num = sum((gk[n] - gd[n]).pow(2).sum() for n in gd)
    den = sum(gd[n].pow(2).sum() for n in gd)
    total = (num / den).sqrt().item()
    per = {n: rel_l2(gk[n], gd[n]) for n in gd if gd[n].norm() > 0}
    worst = max(per, key=per.get)
    print(f"[route] 4 layers x d {cfg.d_model}, L = "
          f"{n_frames * cfg.tokens_per_frame}, one step, kernels {counts} vs "
          f"dense attention: loss {lk:.6f} vs {ld:.6f} (rel {loss_rel:.2e}, "
          f"tolerance {ROUTE_LOSS_REL}); gradient rel L2 over all params "
          f"{total:.3e} (tolerance {ROUTE_GRAD_REL_L2}), median param "
          f"{statistics.median(per.values()):.3e}, worst {per[worst]:.3e} "
          f"({worst}; tolerance {ROUTE_PARAM_REL_L2})", flush=True)
    if loss_rel > ROUTE_LOSS_REL or total > ROUTE_GRAD_REL_L2 or \
            per[worst] > ROUTE_PARAM_REL_L2:
        fail("the training step through the kernels disagrees with dense")
    reset_counts()
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_l2=total, worst_param=per[worst])


# ---------------------------------------------------------------- phase 7
K4_CASES = [("L24576_causal", True), ("L24576_full", False)]


def k4_phase(dev, L=SP_TOKENS // SP_SHARDS, tpf=SP_TPF, cases=K4_CASES,
              tag="k4"):
    """K4 at the per-rank geometry of configs/dit_v4_98k_sp.yml on 4 seq
    ranks (or at L tokens a rank, tpf ``tpf``): q rms-normed and
    pre-scaled as the ring hands it, k rms-normed; random cotangents on
    out (f32) and lse."""
    import torch.nn.functional as F
    from owl_audio_exps_tpu_torch.ops import splash

    B, H, Dh = 1, 24, 64
    gen = torch.Generator(device=dev).manual_seed(20)
    rows = {}
    for name, causal in cases:
        q, k, v = (torch.randn(B, H, L, Dh, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        q = (rms_normed(q) * Dh ** -0.5).to(torch.bfloat16)
        k = rms_normed(k)
        g_out = torch.randn(B, H, L, Dh, generator=gen, device=dev)
        g_lse = torch.randn(B, H, L, generator=gen, device=dev)
        # the kernel through its autograd Function at every head, against
        # f32 autograd of the plain version, CHECK_HEADS heads at a time
        got = grads_of(lambda *t: splash.splash_attention_lse(*t, tpf, causal),
                       q, k, v, (g_out, g_lse))
        errs, plain_fwd, plain_bwd = chunked_grad_errors(
            got, lambda *t: splash.splash_attention_lse_plain(*t, tpf, causal),
            q, k, v, (g_out, g_lse), names=("out", "lse", "dq", "dk", "dv"))
        del got
        torch.cuda.empty_cache()

        iters = 5
        g_bf = g_out.to(torch.bfloat16)   # the cast is not the kernel's
        fwd_ms = cuda_ms(lambda: splash.splash_attention_lse_cuda(
            q, k, v, tpf, causal), iters)
        out, lse = splash.splash_attention_lse_cuda(q, k, v, tpf, causal)
        # delta' (f32, plain PyTorch as in the JAX package) is not a kernel
        delta_ms = cuda_ms(lambda: splash.ring_delta(out, g_out, g_lse),
                           iters)
        delta = splash.ring_delta(out, g_out, g_lse)
        dq_ms = cuda_ms(lambda: splash.splash_attention_lse_bwd_dq_cuda(
            q, k, v, lse, delta, g_bf, tpf, causal), iters)
        dkv_ms = cuda_ms(lambda: splash.splash_attention_lse_bwd_dkv_cuda(
            q, k, v, lse, delta, g_bf, tpf, causal), iters)
        del out, lse, delta
        torch.cuda.empty_cache()
        mask = sdpa_mask(dev, L, tpf, None, True, None) if causal else None
        sdpa = lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, scale=1.0)
        try:
            lf, lt = fwd_bwd_ms(sdpa, q, k, v, g_bf, iters)
            lib_fwd, lib_bwd = lf, lt - lf
        except (RuntimeError, torch.OutOfMemoryError) as e:
            print(f"[{tag}]   library call unavailable: {str(e)[:120]}",
                  flush=True)
            lib_fwd = lib_bwd = None
        del mask, g_bf
        torch.cuda.empty_cache()

        pairs = pairs_of(L, tpf, None, causal, None, B)
        elems, stats = B * H * L * Dh, B * H * L
        timed = {
            "fwd": (fwd_ms, bound_row(4.0 * Dh * pairs * H,
                                      6.0 * elems + 4.0 * elems
                                      + 4.0 * stats), ("out", "lse")),
            "bwd_dq": (dq_ms, bound_row(6.0 * Dh * pairs * H,
                                        10.0 * elems + 8.0 * stats),
                       ("dq",)),
            "bwd_dkv": (dkv_ms, bound_row(8.0 * Dh * pairs * H,
                                          12.0 * elems + 8.0 * stats),
                        ("dk", "dv"))}
        for part, (ms, bnd, keys) in timed.items():
            is_fwd = part == "fwd"
            rows[(f"ring_partial_{part}", name)] = dict(
                ms=ms, plain_ms=plain_fwd if is_fwd else plain_bwd,
                library_ms=lib_fwd if is_fwd else lib_bwd,
                max_abs_err=max(errs[n][1] for n in keys),
                mean_abs_err=max(errs[n][2] for n in keys),
                rel_l2=max(errs[n][0] for n in keys), checked_heads=H,
                tflops=bnd["gflop"] / ms, share_of_bound=bnd["bound_ms"] / ms,
                **bnd)
            if part != "fwd":
                rows[(f"ring_partial_{part}", name)]["delta_ms"] = delta_ms
        lib = ("n/a" if lib_bwd is None else
               f"fwd {lib_fwd:.4f} ms bwd {lib_bwd:.4f} ms")
        print(f"[{tag}] ring partial {name}: B={B} H={H} L={L} Dh={Dh} "
              f"tpf={tpf} causal={causal} | checked at H={H}: " + " ".join(
                  f"{n} rel={e[0]:.2e} max|d|={e[1]:.2e} mean|d|={e[2]:.2e}"
                  for n, e in errs.items()), flush=True)
        print(f"[{tag}]   " + " ".join(
            f"{part} {ms:.4f} ms ({bnd['gflop'] / ms:.1f} TFLOP/s, "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of bound "
            f"{bnd['bound_ms']:.4f} ms {bnd['bound_by']})"
            for part, (ms, bnd, _) in timed.items())
            + f" | delta' {delta_ms:.4f} ms"
            + f" | plain fwd {plain_fwd:.3f} ms bwd {plain_bwd:.3f} ms | "
            f"sdpa {lib}", flush=True)
        worst = max(e[0] for n, e in errs.items() if n != "lse")
        if worst > GRAD_REL_L2:
            fail(f"K4 {name}: kernel disagrees with its plain version "
                 f"(relative L2 {worst:.3e} > {GRAD_REL_L2})")
        if errs["out"][1] > KERNEL_MAX_ABS or errs["out"][2] > \
                KERNEL_MEAN_ABS or errs["lse"][1] > KERNEL_MAX_ABS:
            fail(f"K4 {name}: forward disagrees with its plain version")
        del q, k, v, g_out, g_lse
        torch.cuda.empty_cache()
    return rows


def ring_one_process(q, k, v, tpf: int, n: int):
    """Ring attention of all n slices of [B, H, L, Dh] q, k, v in one
    process, through parallel/context.py's per-step functions: slice i's
    step r takes the K/V of slice (i - r) mod n, which the ring would
    have rotated to it. Returns the [B, H, L, Dh] output."""
    from owl_audio_exps_tpu_torch.parallel.context import (ring_partial,
                                                           ring_step)
    per = q.shape[2] // n
    qs = (q * q.shape[-1] ** -0.5).to(q.dtype)
    cut = lambda t, i: t[:, :, i * per:(i + 1) * per]
    outs = []
    for i in range(n):
        out, lse = ring_partial(cut(qs, i), cut(k, i), cut(v, i), tpf, True)
        for r in range(1, n):
            src = (i - r) % n
            out, lse = ring_step(cut(qs, i), cut(k, src), cut(v, src), out,
                                 lse, tpf, src < i)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, 2)


def halo_one_process(q, k, v, tpf: int, window: int, n: int, bound):
    """The local layer of all n slices in one process: slice i > 0 takes
    the last C = window * tpf tokens of slice i - 1 as its halo."""
    from owl_audio_exps_tpu_torch.parallel.context import (
        local_attention_with_halo)
    per, C = q.shape[2] // n, window * tpf
    outs = []
    for i in range(n):
        sl = slice(i * per, (i + 1) * per)
        hs = slice(i * per - C, i * per) if i else slice(0, C)
        outs.append(local_attention_with_halo(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], k[:, :, hs], v[:, :, hs],
            tpf, window, i > 0, bound))
    return torch.cat(outs, 2)


def context_phase(dev):
    """Ring and halo of the 98,304-token sequence over 4 slices in one
    process (the main path's per-step functions, counted) against K1 and
    the band kernel over the whole sequence (not counted)."""
    from owl_audio_exps_tpu_torch.ops import band, splash

    B, H, Dh, L, n = 1, 24, 64, SP_TOKENS, SP_SHARDS
    tpf, window, bound = SP_TPF, SP_WINDOW, float(Dh) ** 0.5
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, g = (torch.randn(B, H, L, Dh, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    q, k = rms_normed(q), rms_normed(k)   # as QK rms-norm gives them
    paths = {
        "ring": (lambda *t: ring_one_process(*t, tpf, n),
                 lambda *t: splash.splash_attention(*t, tpf, None, True)),
        "halo": (lambda *t: halo_one_process(*t, tpf, window, n, bound),
                 lambda *t: band.band_attention(*t, tpf, window,
                                                logit_bound=bound)),
    }
    got, secs = {}, {}
    reset_counts()
    for name, (fn, _) in paths.items():
        t0 = time.perf_counter()
        got[name] = grads_of(fn, q, k, v, g)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    counts = kernel_counts()
    reset_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(ring_partial_fwd=n * n + n * (n - 1),
                  ring_partial_bwd_dq=n * n, ring_partial_bwd_dkv=n * n,
                  band_attention_fwd=n, band_attention_bwd=n)
    print(f"[context] {n} slices x {L // n} tokens of L = {L} (tpf {tpf}, "
          f"local window {window}) in one process: ring {secs['ring']:.2f} "
          f"s, halo {secs['halo']:.2f} s (forward + backward); launches "
          f"{ {k: c for k, c in counts.items() if c} }", flush=True)
    print(f"[context]   K4 forward launches = {n} slices x {n} steps in the "
          f"forward + {n} x {n - 1} recomputed by the per-step checkpoint "
          f"(steps 1..{n - 1}) = {n * n + n * (n - 1)}", flush=True)
    if counts != expect:
        fail(f"context: launches {counts}, expected {expect}")

    worst = {}
    for name, (_, full) in paths.items():
        want = grads_of(full, q, k, v, g)
        errs = {t: rel_l2(a, b) for t, a, b in
                zip(("out", "dq", "dk", "dv"), got[name], want)}
        worst[name] = max(errs.values())
        print(f"[context] {name} vs the full-sequence "
              f"{'K1' if name == 'ring' else 'band kernel'}: relative L2 "
              + " ".join(f"{t} {e:.3e}" for t, e in errs.items())
              + f" (tolerance {GRAD_REL_L2})", flush=True)
        del want
        torch.cuda.empty_cache()
    reset_counts()
    if max(worst.values()) > GRAD_REL_L2:
        fail(f"context: ring/halo disagree with the full sequence {worst}")
    del got, q, k, v, g
    torch.cuda.empty_cache()
    return dict(counts={k: c for k, c in counts.items() if c},
                rel_l2=worst, seconds=secs)


# ---------------------------------------------------------------- phase 9
def av_config(name: str, work: str):
    """configs/<name> with the AV training phase's cuts applied in the
    config object, each printed: 384 frames, batch 1, group remat, and
    train.py's port cuts (the data source, the eval sampler)."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.train import port_cuts

    conf = Config.from_yaml(os.path.join(ROOT, "configs", name))
    mc, tc = conf.model, conf.train
    cuts = [(mc, "n_frames", AV_FRAMES), (tc.data_kwargs, "window_length",
                                          AV_FRAMES),
            (tc, "batch_size", 1), (tc, "target_batch_size", 1),
            (mc, "gradient_checkpointing", True),
            (mc, "remat_granularity", "group"),
            (tc, "checkpoint_dir", os.path.join(work, "ckpt")),
            (tc, "log_interval", 1)]
    for node, key, value in cuts:
        print(f"[av] cut from configs/{name}: {key} {node.get(key)!r} -> "
              f"{value!r}", flush=True)
        node[key] = value
    for line in port_cuts(conf, 1):
        print(f"[av] cut from configs/{name}: {line}", flush=True)
    return conf


def av_train_phase(dev):
    """AVRFTTrainer at 384 frames (then MixedAVRFTTrainer) through the
    port's trainer: exact launches per step, step time, MFU, peak memory
    and one traced step."""
    import gc
    import shutil
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.nn.attn import attention_route
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import (
        AVRFTTrainer, MixedAVRFTTrainer)
    from owl_audio_exps_tpu_torch.utils.mfu import (H100_PEAK_TFLOPS,
                                                    training_flops_per_token)

    work = os.path.join(ROOT, "build", "chip_smoke_av")
    shutil.rmtree(work, ignore_errors=True)
    out = {}
    for name, base, n_steps in (("av_v5_8x8_weak.yml", AVRFTTrainer,
                                 AV_STEPS),
                                ("av_v5_mixed.yml", MixedAVRFTTrainer,
                                 MIXED_STEPS)):
        conf = av_config(name, work)
        cfg, tc = conf.model, conf.train
        L = AV_FRAMES * cfg.tokens_per_frame
        route = attention_route(cfg, True, L)
        expect = expected_counts(cfg, L)
        print(f"[av] {base.__name__}: local layers take {route[0]} with "
              f"plan {route[1]}; expected launches per step "
              f"{ {k: n for k, n in expect.items() if n} }", flush=True)
        if route[0] != "band2":
            fail(f"{name}: the local layers route to {route}, not band2")
        if {k: n for k, n in expect.items() if n} != AV_LAUNCHES:
            fail(f"{name}: expected launches {expect}, not {AV_LAUNCHES}")

        torch.cuda.reset_peak_memory_stats()
        trainer = counted_trainer(base)(conf, device=dev)
        t0 = time.perf_counter()
        state = trainer.train(max_steps=n_steps)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"[av] {base.__name__} {cfg.n_layers} layers x d "
              f"{cfg.d_model}, {cfg.n_heads} heads x "
              f"{cfg.d_model // cfg.n_heads}, {n_params / 1e6:.1f} M params "
              f"fp32, L = {L} ({AV_FRAMES} frames x tpf "
              f"{cfg.tokens_per_frame}, local window {cfg.local_window}), "
              f"opt {tc.opt}, remat {cfg.remat_granularity}, data "
              f"{tc.data_id}: {n_steps} steps in {wall:.1f} s", flush=True)
        for i, st in enumerate(trainer.steps):
            print(f"[av]   step {i + 1}: {st['s']:.3f} s loss "
                  f"{st['loss']:.5f} launches "
                  f"{ {k: n for k, n in st['counts'].items() if n} }",
                  flush=True)
            if not math.isfinite(st["loss"]):
                fail(f"{name} step {i + 1}: loss not finite")
            if st["counts"] != expect:
                fail(f"{name} step {i + 1}: kernel launches {st['counts']}, "
                     f"expected {expect}")
        timed = [st["s"] for st in trainer.steps[1:]]
        step_s = statistics.median(timed)
        tokens = L * tc.batch_size * trainer.accum_steps()
        mfu = training_flops_per_token(cfg, L) * tokens / step_s / \
            (H100_PEAK_TFLOPS * 1e12)
        print(f"[av] {base.__name__} s/step median {step_s:.4f} (steps "
              f"2-{n_steps}, min {min(timed):.4f} max {max(timed):.4f}), "
              f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of "
              f"{H100_PEAK_TFLOPS:.0f} TFLOP/s, peak memory {peak_gb:.2f} "
              f"GiB (max_memory_allocated)", flush=True)
        row = dict(step_s=step_s, tokens_per_s=tokens / step_s, mfu=mfu,
                   peak_gib=peak_gb, losses=[st["loss"] for st in
                                             trainer.steps],
                   per_step=expect,
                   totals={k: sum(st["counts"][k] for st in trainer.steps)
                           for k in expect})
        if base is AVRFTTrainer:
            loader = iter(get_loader(tc.data_id, tc.batch_size,
                                     **dict(tc.data_kwargs.items())))
            micro = [trainer.to_device(next(loader))]
            gen = torch.Generator(device=dev).manual_seed(98)
            row["device_ms"] = profile_step(trainer, state, micro, gen,
                                            step_s, tag="av")
            del micro
        out[base.__name__] = row
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    reset_counts()
    return out


# --------------------------------------------------------------- phase 10
def kernel_classes(per_name):
    """Device us by kernel class of {name: (us, n)}."""
    classes = {}
    for name, (us, _) in per_name.items():
        low = name.lower()
        if any(s in low for s in ("gemm", "gemv", "nvjet", "cutlass",
                                  "sm90_xmma")):
            cls = "matmul (cuBLAS)"
        elif "softmax" in low:
            cls = "softmax"
        elif "reduce" in low:
            cls = "reductions (norms, amax)"
        elif any(s in low for s in ("index", "gather", "scatter", "cat",
                                    "copy")):
            cls = "copies, index, cat"
        elif "elementwise" in low:
            cls = "elementwise"
        else:
            cls = "other"
        classes[cls] = classes.get(cls, 0.0) + us
    return classes


def trace_tokens(loop, core, n: int, graphed: bool):
    """Trace ``n`` tokens of ``loop``: (device us by kernel name, host
    launch calls by API name, wall ms of the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run(core, n, graphed)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_name, api = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cudaGraphLaunch",
                        "cudaMemcpyAsync", "cudaMemsetAsync"):
            api[e.name] = api.get(e.name, 0) + 1
    return per_name, api, wall_ms


def audio_serve_phase(dev):
    """bench_torch.py's audio serve on the card; see the module docstring
    (phase 10). Reaches no kernel of the port."""
    import numpy as np
    import bench_torch as bench
    from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
    from owl_audio_exps_tpu_torch.nn.wquant import (quantize_params_int8,
                                                    quantized_names)
    from owl_audio_exps_tpu_torch.sampling.audio_caching import draw_noise
    from owl_audio_exps_tpu_torch.sampling.common import SamplerNoise

    reset_counts()
    bf = torch.bfloat16
    cfg = bench.make_cfg()
    t0 = time.perf_counter()
    core = bench.make_core(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in core.parameters())
    print(f"[audio] AudioRFTCore {cfg.n_layers} layers x d {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.d_model // cfg.n_heads}, "
          f"{cfg.channels} channels, local window {cfg.local_window}, "
          f"{n_params / 1e6:.1f} M params bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {}

    # cached forwards against one uncached forward of the same 121 tokens
    gen = torch.Generator(device=dev).manual_seed(11)
    n = bench.INIT_LEN + 1
    xs = torch.randn(1, n, cfg.channels, generator=gen, device=dev).to(bf)
    ts = torch.rand(1, n, generator=gen, device=dev).to(bf)
    with torch.no_grad():
        full = core(xs, ts)
        for split in ("auto", False):
            cfg.split_local_cache = split
            cache = KVCache.from_config(cfg, 1, capacity_frames=bench.INIT_LEN,
                                        dtype=bf, device=dev)
            p1 = core(xs[:, :n - 2], ts[:, :n - 2], kv_cache=cache,
                      write=True)
            p2 = core(xs[:, n - 2:], ts[:, n - 2:], kv_cache=cache,
                      write=True, write_len=1)
            p3 = core(xs[:, n - 1:], ts[:, n - 1:], kv_cache=cache,
                      decoding=True)
            errs = dict(prefill=rel_l2(p1, full[:, :n - 2]),
                        fused=rel_l2(p2, full[:, n - 2:]),
                        decoding=rel_l2(p3, full[:, n - 1:]))
            ring = "split" if cache.split else "single"
            print(f"[audio] cached vs uncached forward, {ring} ring "
                  f"(length {int(cache.length)}, rope_offset "
                  f"{int(cache.rope_offset)}): rel L2 "
                  f"{ {k: f'{v:.3e}' for k, v in errs.items()} } "
                  f"(tolerance {FORWARD_REL_L2})", flush=True)
            if not all(e <= FORWARD_REL_L2 for e in errs.values()):
                fail(f"cached forwards on the {ring} ring disagree with the "
                     "uncached forward")
            if cache.split == (split is False):
                fail(f"split_local_cache {split!r} gave split={cache.split}")
            out[f"cached_vs_full_{ring}"] = errs
        cfg.split_local_cache = "auto"

    # the CUDA-graph loop against the eager step, on the same draws
    sampler = bench.make_sampler()
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(1, bench.INIT_LEN, cfg.channels)).to(
        dev, bf)
    noise = draw_noise(gen.manual_seed(12), 1, bench.INIT_LEN, cfg.channels,
                       bench.NUM_TOKENS, dev)
    graph_out = sampler(core, x, noise=noise)
    torch.cuda.synchronize()
    # the eager step takes ~0.14 s a token on the host: one eager run of
    # the first AUDIO_EAGER_TOKENS tokens on the same draws (a token
    # depends on the earlier draws only), timed as bench_torch.py times a
    # run, held against the graph run's first tokens
    eager = bench.make_sampler()
    eager.num_tokens = k_eager = AUDIO_EAGER_TOKENS
    t0 = time.perf_counter()
    eager_out = eager.sample_eager(core, x, noise=SamplerNoise(
        noise.ctx, noise.init[:k_eager], noise.renoise[:k_eager]))
    eager_out.cpu()
    eager_rtf = k_eager / bench.LATENTS_PER_SECOND / (
        time.perf_counter() - t0)
    shape = (1, bench.INIT_LEN + bench.NUM_TOKENS, cfg.channels)
    if tuple(graph_out.shape) != shape or \
            not torch.isfinite(graph_out).all():
        fail(f"serve output {tuple(graph_out.shape)} (want {shape}) or not "
             "finite")
    graph_head = graph_out[:, :bench.INIT_LEN + k_eager]
    d = (graph_head.float() - eager_out.float()).abs().max().item()
    same = torch.equal(graph_head, eager_out)
    print(f"[audio] CUDA-graph loop vs eager step over the first "
          f"{k_eager} of {bench.NUM_TOKENS} tokens: identical {same}, max "
          f"|diff| {d:.3e}"
          + ("" if same else " (cuBLAS picks other algorithms under "
             f"capture; tolerance {AUDIO_GRAPH_MAX_ABS})"), flush=True)
    if d > AUDIO_GRAPH_MAX_ABS:
        fail("the graph-replayed tokens disagree with the eager step")
    out.update(graph_identical=same, graph_max_abs=d)

    # int8 weights: one uncached forward, and the serve on the same draws
    qcore = quantize_params_int8(core)
    names = quantized_names(qcore)
    with torch.no_grad():
        fq = core(xs, ts).float().flatten()
        fqq = qcore(xs, ts).float().flatten()
    cos = (torch.dot(fq, fqq) / (fq.norm() * fqq.norm())).item()
    q_out = sampler(qcore, x, noise=noise)
    dq = (q_out.float() - graph_out.float()).abs().max().item()
    print(f"[audio] int8 weights ({len(names)} Linear layers of >= 65,536 "
          f"weights): forward cosine {cos:.6f} (limit > {INT8_FORWARD_COS}); "
          f"serve max |diff| vs bf16 {dq:.3e}, finite "
          f"{bool(torch.isfinite(q_out).all())}", flush=True)
    if not cos > INT8_FORWARD_COS or not torch.isfinite(q_out).all():
        fail("the int8-weight forward or serve diverged")

    # the int8 ring against the bf16 ring (same seeded weights)
    core_kq = bench.make_core(bench.make_cfg(kv_quant="int8"), dev)
    with torch.no_grad():
        dec = {}
        for name, c in (("bf16", core), ("int8", core_kq)):
            cache = KVCache.from_config(c.config, 1,
                                        capacity_frames=bench.INIT_LEN,
                                        dtype=bf, device=dev)
            c(xs[:, :n - 1], ts[:, :n - 1], kv_cache=cache, write=True)
            dec[name] = c(xs[:, n - 1:], ts[:, n - 1:], kv_cache=cache,
                          decoding=True).float()
    ring_err = (dec["int8"] - dec["bf16"]).abs().max().item()
    ring_lim = INT8_RING_DECODE * max(dec["bf16"].abs().max().item(), 1.0)
    kq_out = sampler(core_kq, x, noise=noise)
    kq_err = (kq_out.float() - graph_out.float()).abs().max().item()
    print(f"[audio] int8 ring vs bf16 ring: decoding forward max |diff| "
          f"{ring_err:.3e} (limit {ring_lim:.3e}); serve max |diff| "
          f"{kq_err:.3e} over {bench.NUM_TOKENS} tokens (limit "
          f"{INT8_RING_SAMPLER})", flush=True)
    if ring_err > ring_lim or kq_err > INT8_RING_SAMPLER:
        fail("the int8 ring diverged from the bf16 ring")
    out.update(int8_forward_cos=cos, int8_serve_max_abs=dq,
               int8_ring_decode_max_abs=ring_err,
               int8_ring_serve_max_abs=kq_err)

    # RTF: bf16 with the graph and eager, int8, 32 int8 streams
    def serve(c):
        return lambda x, g: sampler(c, x, generator=g)

    rtf = {"bf16": bench.measure(serve(core), x), "bf16_eager": eager_rtf,
           "int8": bench.measure(serve(qcore), x)}
    core32 = quantize_params_int8(core_kq)
    del core_kq
    x32 = torch.from_numpy(rs.randn(32, bench.INIT_LEN, 64)).to(dev, bf)
    rtf["int8_32stream_agg"] = bench.measure(serve(core32), x32)
    print(f"[audio] RTF (audio s per s, {bench.NUM_TOKENS} tokens, median of "
          f"3 after a warm-up; eager: one run of {AUDIO_EAGER_TOKENS} "
          f"tokens): bf16 {rtf['bf16']:.4f} (eager "
          f"{rtf['bf16_eager']:.4f}, graph / eager "
          f"{rtf['bf16'] / rtf['bf16_eager']:.3f}x), int8 "
          f"{rtf['int8']:.4f}, 32 int8 streams (int8 ring) aggregate "
          f"{rtf['int8_32stream_agg']:.2f}", flush=True)
    out["rtf"] = rtf

    # ms and kernels per token, graph and eager; one traced window
    loop = sampler.prepare(core, x, noise)
    loop.run(core, 4, True)
    k = AUDIO_PROFILE_TOKENS
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loop.run(core, 4 * k, True)
    end.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(end) / (4 * k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(core, k, False)
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / k
    per_name, api, wall = trace_tokens(loop, core, k, True)
    e_per_name, e_api, e_wall = trace_tokens(loop, core, k, False)
    busy = sum(us for us, _ in per_name.values()) / 1e3
    kernels = sum(c for _, c in per_name.values())
    e_kernels = sum(c for _, c in e_per_name.values())
    e_busy = sum(us for us, _ in e_per_name.values()) / 1e3
    launches = sum(c for name, c in e_api.items() if "Launch" in name)
    if busy == 0 or e_busy == 0:
        fail("the profiler recorded no device time in the audio window")
    print(f"[audio] per token: graph {graph_ms:.3f} ms (CUDA events over "
          f"{4 * k} replays), eager {eager_ms:.3f} ms (host clock over {k} "
          f"steps); kernels per token {kernels / k:.1f} graph, "
          f"{e_kernels / k:.1f} eager; host launch calls per token "
          f"{api.get('cudaGraphLaunch', 0) / k:.2f} graph launches, "
          f"{launches / k:.1f} eager kernel launches", flush=True)
    # tracing slows the replays, so the busy share is also taken against
    # the untraced graph time of the same tokens (as profile_tick does)
    print(f"[audio] traced {k}-token window with the graph: device busy "
          f"{busy:.2f} ms = {100 * busy / (k * graph_ms):.1f}% of the "
          f"untraced {k * graph_ms:.2f} ms ({100 * busy / wall:.1f}% of the "
          f"traced wall {wall:.2f} ms); eager: busy {e_busy:.2f} of "
          f"{e_wall:.2f} ms traced wall ({100 * e_busy / e_wall:.1f}%), "
          f"{100 * e_busy / (k * eager_ms):.1f}% of the untraced "
          f"{k * eager_ms:.2f} ms", flush=True)
    classes = kernel_classes(per_name)
    for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"[audio]   {cls}: {us / 1e3:.3f} ms "
              f"({100 * us / 1e3 / busy:.1f}% of busy)", flush=True)
    for name, (us, c) in sorted(per_name.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"[audio]   {us / 1e3:8.3f} ms {c:5d}x {name[:100]}",
              flush=True)
    counts = kernel_counts()
    if any(counts.values()):
        fail(f"the audio serve launched kernels of the port: {counts}")
    out.update(ms_per_token=dict(graph=graph_ms, eager=eager_ms),
               kernels_per_token=dict(graph=kernels / k,
                                      eager=e_kernels / k),
               eager_launch_calls_per_token=launches / k,
               busy=dict(graph_ms=busy, graph_wall_ms=wall, eager_ms=e_busy,
                         eager_wall_ms=e_wall),
               device_ms_by_class={c: us / 1e3 for c, us in classes.items()},
               port_kernel_launches=0)
    del core, qcore, core32, sampler, loop
    torch.cuda.empty_cache()
    print(f"[audio] still allocated after the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    return out


# --------------------------------------------------------------- phase 11
def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase11_config(name: str):
    """configs/<name>, loaded for phase 11."""
    from owl_audio_exps_tpu_torch.configs import Config
    return Config.from_yaml(os.path.join(ROOT, "configs", name))


def make_core(cfg, dev, seed: int):
    from owl_audio_exps_tpu_torch.models import get_core_cls
    return get_core_cls(cfg.model_id)(cfg, dtype=torch.bfloat16, device=dev,
                                      seed=seed).to(torch.bfloat16).eval()


def check_no_port_kernels(what: str):
    """Fail if any of K1-K5 (``kernel_counts``: the TPU kernels' ports)
    launched; the decode kernel of the cached forwards is not one of them
    and is counted apart (ops/decode_attention.py ``launches``)."""
    counts = kernel_counts()
    if any(counts.values()):
        fail(f"{what} launched kernels of the port: {counts}")


def cached_sampler_phase(dev):
    """``AVCachingSamplerV2`` on configs/dit_v4.yml: the eval's clip (a
    60-frame window, its first half as context), the config's sampler and
    the 2-step schedule; graph vs eager; cached vs uncached forwards."""
    from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
    from owl_audio_exps_tpu_torch.sampling.common import (SamplerNoise,
                                                          draw_noise)

    conf = phase11_config("dit_v4.yml")
    cfg, tc = conf.model, conf.train
    kw = tc.sampler_kwargs.to_dict()
    clip = tc.sample_data_kwargs.window_length
    ctx = clip // 2
    core = make_core(cfg, dev, seed=5)
    print(f"[cached] AVCachingSamplerV2 ({tc.sampler_id}) on "
          f"configs/dit_v4.yml: {cfg.n_layers} layers x d {cfg.d_model}, "
          f"{cfg.n_heads} heads, tpf {cfg.tokens_per_frame}, local window "
          f"{cfg.local_window}; the eval's {clip}-frame clip, {ctx} frames "
          f"of context: num_frames {kw['num_frames']} -> {clip - ctx} (the "
          f"clip's remaining frames)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    bf = torch.bfloat16
    item = (cfg.channels, cfg.sample_size, cfg.sample_size)
    x = torch.randn((1, ctx) + item, generator=gen, device=dev).to(bf)
    mouse = torch.randn(1, clip, 2, generator=gen, device=dev)
    btn = (torch.rand(1, clip, cfg.n_buttons, generator=gen,
                      device=dev) > 0.5).float()
    n = clip - ctx
    noise = draw_noise(gen, 1, ctx, item, n, dev)
    out = {}
    runs = {"config": dict(kw),
            "two_step_cfg": dict(kw, n_steps=2, custom_schedule=[1.0, 0.5],
                                 cfg_scale=1.3)}
    for tag, skw in runs.items():
        sampler = get_sampler_cls(tc.sampler_id)(**skw)
        reset_counts()
        graphed = sampler(core, x, mouse, btn, noise=noise)
        sync(dev)
        t0 = time.perf_counter()
        again = sampler(core, x, mouse, btn, noise=noise)
        again.cpu()
        graph_s = time.perf_counter() - t0
        # the eager loop over the first CACHED_EAGER_FRAMES frames on the
        # same draws and the same ring capacity (a frame depends on the
        # earlier draws only), held against the graph's
        k = CACHED_EAGER_FRAMES
        short = get_sampler_cls(tc.sampler_id)(**dict(
            skw, max_window=sampler.window(x, n)[1]))
        t0 = time.perf_counter()
        eager = short.sample_eager(
            core, x, mouse[:, :ctx + k], btn[:, :ctx + k],
            noise=SamplerNoise(noise.ctx, noise.init[:k], noise.renoise[:k]))
        eager.cpu()
        eager_s = time.perf_counter() - t0
        check_no_port_kernels(f"AVCachingSamplerV2 ({tag})")
        loop = next(iter(sampler._loops.values()))[1]
        shape = (1, ctx + n) + item
        if loop.graph is None or not graphed.is_cuda:
            fail(f"sampler ({tag}): no CUDA graph was captured")
        if tuple(graphed.shape) != shape or \
                not torch.isfinite(graphed).all():
            fail(f"sampler ({tag}): output {tuple(graphed.shape)} (want "
                 f"{shape}) or not finite")
        head = ctx + k
        d = max(max_abs(graphed[:, :head], eager),
                max_abs(again[:, :head], eager), max_abs(graphed, again))
        same = torch.equal(graphed[:, :head], eager) and \
            torch.equal(again, graphed)
        print(f"[cached]   {tag} (n_steps {skw['n_steps']}, schedule "
              f"{skw.get('custom_schedule') or 'sd3'}, cfg_scale "
              f"{skw['cfg_scale']}): {n} frames, graph {n / graph_s:.2f} "
              f"frames/s ({1e3 * graph_s / n:.2f} ms a frame), eager "
              f"{k / eager_s:.2f} frames/s (the first {k}); graph vs eager "
              f"identical {same}, "
              f"max |diff| {d:.3e} (tolerance {CACHED_GRAPH_MAX_ABS}); no "
              f"port kernel launched", flush=True)
        if d > CACHED_GRAPH_MAX_ABS:
            fail(f"sampler ({tag}): graph replays disagree with the eager "
                 "loop")
        out[tag] = dict(n_steps=skw["n_steps"], cfg_scale=skw["cfg_scale"],
                        frames=n, graph_fps=n / graph_s,
                        eager_fps=k / eager_s, graph_identical=same,
                        graph_max_abs=d)
        del sampler, loop
        gc.collect()

    # cached forwards (prefill, fused 2-frame, decoding) against one
    # uncached forward of the same frames (the kernel route on the card)
    xs = torch.randn((1, ctx + 1) + item, generator=gen, device=dev).to(bf)
    ts = torch.rand(1, ctx + 1, generator=gen, device=dev).to(bf)
    m, b = mouse[:, :ctx + 1], btn[:, :ctx + 1]
    with torch.no_grad():
        reset_counts()
        full = core(xs, ts, m, b)
        launched = {k: v for k, v in kernel_counts().items() if v}
        cache = KVCache.from_config(cfg, 1, capacity_frames=clip, dtype=bf,
                                    device=dev)
        reset_counts()
        p1 = core(xs[:, :ctx - 1], ts[:, :ctx - 1], m[:, :ctx - 1],
                  b[:, :ctx - 1], kv_cache=cache, write=True)
        p2 = core(xs[:, ctx - 1:], ts[:, ctx - 1:], m[:, ctx - 1:],
                  b[:, ctx - 1:], kv_cache=cache, write=True, write_len=1)
        p3 = core(xs[:, ctx:], ts[:, ctx:], m[:, ctx:], b[:, ctx:],
                  kv_cache=cache, decoding=True)
        check_no_port_kernels("the cached forwards")
    errs = dict(prefill=rel_l2(p1, full[:, :ctx - 1]),
                fused=rel_l2(p2, full[:, ctx - 1:]),
                decoding=rel_l2(p3, full[:, ctx:]))
    print(f"[cached]   cached forwards vs one uncached forward of {ctx + 1} "
          f"frames (L {(ctx + 1) * cfg.tokens_per_frame}, the kernel route: "
          f"{launched}, not counted): rel L2 "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance "
          f"{FORWARD_REL_L2})", flush=True)
    if not all(e <= FORWARD_REL_L2 for e in errs.values()):
        fail("cached forwards disagree with the uncached forward")
    out["cached_vs_full"] = errs
    del core, cache, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


def causal_window_phase(dev):
    """``CausalAVWindowSampler`` on configs/av_v5_8x8_weak.yml as written
    (W 16, 4 steps, CFG 1.3), a few frames; step 0 against the uncached
    forward of the same window."""
    from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls

    conf = phase11_config("av_v5_8x8_weak.yml")
    cfg, tc = conf.model, conf.train
    kw = tc.sampler_kwargs.to_dict()
    print(f"[causal] {tc.sampler_id} on configs/av_v5_8x8_weak.yml "
          f"({cfg.n_layers} layers x d {cfg.d_model}, tpf "
          f"{cfg.tokens_per_frame}, W {kw['window_length']}, n_steps "
          f"{kw['n_steps']}, cfg_scale {kw['cfg_scale']}): num_frames "
          f"{kw['num_frames']} -> {CAUSAL_FRAMES} for time", flush=True)
    kw["num_frames"] = CAUSAL_FRAMES
    core = make_core(cfg, dev, seed=6)
    sampler = get_sampler_cls(tc.sampler_id)(**kw)
    W = sampler.window_length
    gen = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16
    p = cfg.sample_size
    x = torch.randn(1, W, cfg.channels, p, p, generator=gen,
                    device=dev).to(bf)
    a = torch.randn(1, W, cfg.audio_channels, generator=gen,
                    device=dev).to(bf)
    m = torch.randn(1, W, 2, generator=gen, device=dev).to(bf)
    b = (torch.rand(1, W, cfg.n_buttons, generator=gen, device=dev)
         > 0.5).to(bf)
    reset_counts()
    t0 = time.perf_counter()
    _, _, x_out, a_out, _, _ = sampler(core, x, a, m, b, generator=gen)
    x_out.cpu()
    secs = time.perf_counter() - t0
    check_no_port_kernels("CausalAVWindowSampler")
    n_out = W + CAUSAL_FRAMES
    if tuple(x_out.shape) != (1, n_out, cfg.channels, p, p) or \
            tuple(a_out.shape) != (1, n_out, cfg.audio_channels) or \
            not (torch.isfinite(x_out).all() and torch.isfinite(a_out).all()):
        fail(f"causal window sampler output {tuple(x_out.shape)} "
             f"{tuple(a_out.shape)} or not finite")

    # step 0: the whole window through a fresh ring, against one uncached
    # forward (the kernel route) of the same window
    wt = torch.full((1, W), sampler.noise_prev, dtype=bf, device=dev)
    wt[:, -1] = 1.0
    hc = torch.ones(1, dtype=torch.bool, device=dev)
    with torch.no_grad():
        cache = KVCache.from_config(cfg, 1, capacity_frames=W, dtype=bf,
                                    device=dev)
        cv, ca = core(x, a, wt, m, b, has_controls=hc, kv_cache=cache,
                      write=True)
        check_no_port_kernels("the causal sampler's step 0")
        uv, ua = core(x, a, wt, m, b, has_controls=hc)
    launched = {k: v for k, v in kernel_counts().items() if v}
    reset_counts()
    errs = dict(video=rel_l2(cv, uv), audio=rel_l2(ca, ua))
    print(f"[causal]   {CAUSAL_FRAMES} frames in {secs:.2f} s "
          f"({1e3 * secs / CAUSAL_FRAMES:.1f} ms a frame, eager: fresh rings "
          f"every frame); no port kernel launched; step 0 (L "
          f"{W * cfg.tokens_per_frame} through a fresh ring) vs the "
          f"uncached forward (the kernel route: {launched}, not counted): "
          f"rel L2 "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance "
          f"{FORWARD_REL_L2})", flush=True)
    if not all(e <= FORWARD_REL_L2 for e in errs.values()):
        fail("the causal sampler's step 0 disagrees with the uncached "
             "forward")
    del core, sampler, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(frames=CAUSAL_FRAMES, ms_per_frame=1e3 * secs / CAUSAL_FRAMES,
                step0_vs_full=errs)


def pipeline_config():
    """configs/causvid.yml's model with a RoPE table twice the ring: at
    its n_frames 16 (a 32-frame table) a 120-frame ring could not rebase,
    and positions past the table would clamp."""
    conf = phase11_config("causvid.yml")
    cfg = conf.model
    headroom = 2 * PIPE_WINDOW - cfg.n_frames
    print(f"[serve11] configs/causvid.yml model ({cfg.n_layers} layers x d "
          f"{cfg.d_model}, {cfg.n_heads} heads, tpf {cfg.tokens_per_frame}, "
          f"local window {cfg.local_window}); cut: rope_headroom "
          f"{cfg.get('rope_headroom')!r} -> {headroom} (a "
          f"{2 * PIPE_WINDOW}-frame RoPE table, twice the "
          f"{PIPE_WINDOW}-frame ring)", flush=True)
    cfg.rope_headroom = headroom
    return cfg


def trace_call(fn):
    """(device us by kernel name, wall ms) of one traced call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    return per_name, wall_ms


def cached_pipeline_phase(dev, window_tick_ms: float):
    """``AVCachedStreamingPipeline`` at configs/causvid.yml's width: 120
    frame ring, 2 steps, fused write; 1 and 8 sessions, graph vs eager,
    ms and kernels a tick, one traced tick, a session across a rebase."""
    import numpy as np
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)

    cfg = pipeline_config()
    core = make_core(cfg, dev, seed=7)
    gen = torch.Generator(device=dev).manual_seed(41)
    p = cfg.sample_size
    rs = np.random.RandomState(5)

    def context(B):
        return (torch.randn(B, PIPE_PRIME, cfg.channels, p, p, generator=gen,
                            device=dev),
                torch.randn(B, PIPE_PRIME, cfg.audio_channels, generator=gen,
                            device=dev),
                torch.randn(B, PIPE_PRIME, 2, generator=gen, device=dev),
                (torch.rand(B, PIPE_PRIME, cfg.n_buttons, generator=gen,
                            device=dev) > 0.5).float())

    def controls(B):
        return (rs.randn(B, 2).astype(np.float32),
                (rs.rand(B, cfg.n_buttons) > 0.5).astype(np.float32))

    def pipe_of(B, graphed, seed=9):
        return AVCachedStreamingPipeline(
            core, cfg, window_frames=PIPE_WINDOW, sampling_steps=PIPE_STEPS,
            seed=seed, n_sessions=B, fused_write=True, device=dev,
            graphed=graphed)

    def tick_ms(pipe, B, n):
        ms = []
        for _ in range(n):
            frame, audio, secs = pipe(*controls(B))
            if not (torch.isfinite(frame.float()).all()
                    and torch.isfinite(audio.float()).all()):
                fail("a cached tick gave non-finite output")
            ms.append(1e3 * secs)
        return statistics.median(ms), ms

    out = {}
    for B in PIPE_SESSIONS:
        reset_counts()
        ctx = context(B)
        pipes = [pipe_of(B, True), pipe_of(B, False)]
        for pipe in pipes:
            pipe.prime(*ctx)
        # graph vs eager on the same draws, through the warm-up, the
        # capture and the first replays
        d, same = 0.0, True
        for i in range(PIPE_COMPARE_TICKS):
            ctrl = controls(B)
            (fg, ag, _), (fe, ae, _) = (pp(*ctrl) for pp in pipes)
            d = max(d, max_abs(fg, fe), max_abs(ag, ae))
            same = same and torch.equal(fg, fe) and torch.equal(ag, ae)
        graphed, eager = pipes
        if not graphed.loop.graphs or not fg.is_cuda:
            fail(f"{B} sessions: no CUDA graph was captured for the steady "
                 "tick")
        if tuple(fg.shape) != (B, cfg.channels, p, p) or \
                tuple(ag.shape) != (B, cfg.audio_channels):
            fail(f"tick output shapes {tuple(fg.shape)} {tuple(ag.shape)}")
        if d > CACHED_GRAPH_MAX_ABS:
            fail(f"{B} sessions: the graphed tick disagrees with the eager "
                 "tick")
        g_ms, g_all = tick_ms(graphed, B, PIPE_TICKS)
        e_ms, e_all = tick_ms(eager, B, PIPE_EAGER_TICKS)
        del eager, pipes
        per_name, wall = trace_call(lambda: graphed(*controls(B)))
        e_pipe = pipe_of(B, False)
        e_pipe.prime(*ctx)
        e_pipe(*controls(B))     # the first tick; later ticks are steady
        e_per_name, e_wall = trace_call(lambda: e_pipe(*controls(B)))
        del e_pipe
        busy = sum(us for us, _ in per_name.values()) / 1e3
        kernels = sum(c for _, c in per_name.values())
        e_kernels = sum(c for _, c in e_per_name.values())
        if busy == 0:
            fail("the profiler recorded no device time in the cached tick")
        classes = kernel_classes(per_name)
        print(f"[serve11] {B} session(s), ring {PIPE_WINDOW} frames (L "
              f"{PIPE_WINDOW * cfg.tokens_per_frame}), {PIPE_STEPS} steps, "
              f"fused write, primed with {PIPE_PRIME} frames: graph vs eager "
              f"over {PIPE_COMPARE_TICKS} ticks identical {same}, max |diff| "
              f"{d:.3e} (tolerance {CACHED_GRAPH_MAX_ABS}); ms a tick median "
              f"graphed {g_ms:.2f} (min {min(g_all):.2f} max {max(g_all):.2f},"
              f" {PIPE_TICKS} ticks), eager {e_ms:.2f} (min {min(e_all):.2f} "
              f"max {max(e_all):.2f}, {PIPE_EAGER_TICKS} ticks); kernels a "
              f"tick {kernels} graphed, {e_kernels} eager; one traced "
              f"graphed tick: device busy {busy:.2f} ms = "
              f"{100 * busy / g_ms:.1f}% of the untraced median tick "
              f"({100 * busy / wall:.1f}% of its traced wall {wall:.2f} ms)",
              flush=True)
        for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
            print(f"[serve11]   {cls}: {us / 1e3:.3f} ms "
                  f"({100 * us / 1e3 / busy:.1f}% of busy)", flush=True)
        for name, (us, c) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            print(f"[serve11]   {us / 1e3:8.3f} ms {c:5d}x {name[:100]}",
                  flush=True)
        row = dict(graph_identical=same, graph_max_abs=d,
                   tick_ms=dict(graphed=g_ms, eager=e_ms),
                   kernels_per_tick=dict(graphed=kernels, eager=e_kernels),
                   busy_ms=busy, traced_wall_ms=wall,
                   busy_share_of_tick=busy / g_ms,
                   device_ms_by_class={c: us / 1e3
                                       for c, us in classes.items()})
        if B == 1:
            # run the session on until the next frame would leave the
            # RoPE table: one rebase between two ticks
            rebase_at = None
            for i in range(2 * PIPE_WINDOW + 8):
                off = graphed._off_frames
                frame, audio, _ = graphed(*controls(B))
                if not torch.isfinite(frame.float()).all():
                    fail(f"tick {i} of the long session is not finite")
                if graphed._off_frames < off:
                    rebase_at = off
                    break
            if rebase_at is None:
                fail("the long session never rebased its RoPE positions")
            for _ in range(4):
                frame, audio, _ = graphed(*controls(B))
            if not (torch.isfinite(frame.float()).all()
                    and torch.isfinite(audio.float()).all()):
                fail("ticks after the rebase are not finite")
            print(f"[serve11]   the session rebased its ring at frame "
                  f"{rebase_at} (RoPE table {graphed._table_f} frames, "
                  f"moved down {graphed._delta_f}); 4 graphed ticks after it "
                  f"finite; rope_offset {int(graphed.cache.rope_offset)} "
                  f"tokens", flush=True)
            row["rebase_at_frame"] = rebase_at
        check_no_port_kernels(f"the cached AV serve ({B} sessions)")
        out[f"sessions_{B}"] = row
        del graphed
        gc.collect()
        torch.cuda.empty_cache()
    one = out["sessions_1"]["tick_ms"]["graphed"]
    print(f"[serve11] cached tick (1 session, graphed) {one:.2f} ms against "
          f"phase 3's window-recompute tick {window_tick_ms:.2f} ms (W 60, "
          f"the same 24 x 1536 width, 128 video channels there, 64 here): "
          f"{window_tick_ms / one:.2f}x", flush=True)
    out["window_recompute_tick_ms"] = window_tick_ms
    del core
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cached_serve_phase(dev, window_tick_ms: float):
    """Phase 11: the KV-cached video and AV serve; reaches no kernel of
    the port."""
    out = dict(sampler=cached_sampler_phase(dev),
               causal_window=causal_window_phase(dev),
               pipeline=cached_pipeline_phase(dev, window_tick_ms),
               port_kernel_launches=0)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve11] still allocated after the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    return out


# --------------------------------------------------------------- phase 12
DISTILL_DIR = os.path.join(ROOT, "build", "chip_smoke_distill")
# outer steps of each trainer (CausVid: update_ratio critic steps and one
# student step each); the distilled student's served frames
CAUSVID_STEPS, SF_STEPS, ODE_STEPS, DISTILL_SERVE_FRAMES = 2, 1, 1, 8
K1_NAMES = ("frame_attention_fwd", "frame_attention_bwd_dq",
            "frame_attention_bwd_dkv")


def k1_counts(fwd: int, bwd: int):
    counts = dict.fromkeys(kernel_counts(), 0)
    counts.update(zip(K1_NAMES, (fwd, bwd, bwd)))
    return counts


def distill_cut(tc, name, key, value, why):
    print(f"[distill] cut from configs/{name}: {key} {tc.get(key)!r} -> "
          f"{value!r} ({why})", flush=True)
    tc[key] = value


def distill_config(name: str, teacher: str, **cuts):
    """configs/<name> with phase 12's cuts, each printed: the loaders to
    the synthetic source (train.py port_cuts), accumulation 1, the
    teacher (and the student) from the saved seeded export, and ``cuts``
    ({key: (value, reason)}). The configs' save_interval is not reached:
    a full checkpoint (the student, its EMA, the critic and both AdamW
    states) is ~20 GB at this width, more disk writes than a smoke run
    should make; the CPU tests write and read it back."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.train import port_cuts
    conf = Config.from_yaml(os.path.join(ROOT, "configs", name))
    tc = conf.train
    for line in port_cuts(conf, 1):
        print(f"[distill] cut from configs/{name}: {line}", flush=True)
    work = os.path.join(DISTILL_DIR, name.split(".")[0])
    base = {
        "target_batch_size": (1, "accumulation 1: one micro-batch a step"),
        "teacher_cfg": (os.path.join(ROOT, tc.teacher_cfg),
                        "the same file, from the repository root"),
        "teacher_ckpt": (teacher, "the seeded dit_v4 export saved above"),
        "student_ckpt": (teacher, "the seeded dit_v4 export saved above"),
        "checkpoint_dir": (os.path.join(work, "ckpt"), "under build/"),
        "log_interval": (1, "metrics drained every step")}
    base.update(cuts)
    for key, (value, why) in base.items():
        distill_cut(tc, name, key, value, why)
    return conf


def save_distill_teacher(dev) -> str:
    """A seeded configs/dit_v4.yml core (float32 master weights) saved
    with the port's save_clean_export; returns its directory."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    from owl_audio_exps_tpu_torch.utils.checkpoints import save_clean_export
    import shutil
    shutil.rmtree(DISTILL_DIR, ignore_errors=True)
    cfg = Config.from_yaml(os.path.join(ROOT, "configs", "dit_v4.yml")).model
    core = GameRFTCore(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    path = os.path.join(DISTILL_DIR, "teacher")
    t0 = time.perf_counter()
    save_clean_export(path, {n: p.detach() for n, p in
                             core.named_parameters()})
    n = sum(p.numel() for p in core.parameters())
    print(f"[distill] teacher: configs/dit_v4.yml seeded (seed 0), "
          f"{n / 1e6:.1f} M float32 params, saved with save_clean_export to "
          f"{os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    del core
    torch.cuda.empty_cache()
    return path


def counted_distill(base):
    """A subclass of the distillation trainer ``base`` that sets every
    kernel count to 0 before each critic, student or ODE step and records
    the counts, the step's seconds and its metrics after it."""

    class CountedDistill(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []

        def _counted(self, kind, step, *a):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(*a)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            self.calls.append(dict(kind=kind, s=s, counts=kernel_counts(),
                                   metrics={k: float(v) for k, v in
                                            metrics.items()}))
            return metrics

        def init_distill_state(self):
            state = super().init_distill_state()
            self.initial_student = {n: p.detach().to("cpu", copy=True)
                                    for n, p in
                                    state.student.named_parameters()}
            return state

        def critic_step(self, *a):
            return self._counted("critic", super().critic_step, *a)

        def student_step(self, *a):
            return self._counted("student", super().student_step, *a)

        def step(self, *a):
            return self._counted("ode", super().step, *a)

    return CountedDistill


def distill_expect(trainer, L: int):
    """Exact launches of each kind of step of ``trainer`` at L tokens,
    from the configs: every layer of teacher, student and critic takes K1
    (attention_route), a graded forward launches what the remat structure
    says (attention_forwards_per_step), a forward under no gradient one
    per layer, and each graded layer one dq and one dkv."""
    from owl_audio_exps_tpu_torch.nn.attn import (attention_forwards_per_step,
                                                  attention_route)
    from owl_audio_exps_tpu_torch.trainers.ode_distill import (
        DistillODETrainer)
    from owl_audio_exps_tpu_torch.trainers.self_forcing import (
        SelfForceTrainer)
    s_cfg, t_cfg = trainer.model_cfg, trainer.teacher_cfg
    for cfg in (s_cfg, t_cfg):
        for local in (True, False):
            if attention_route(cfg, local, L)[0] != "splash":
                fail(f"distill: a layer at L {L} does not route to K1")
    n_s, n_t = s_cfg.n_layers, t_cfg.n_layers
    graded = sum(attention_forwards_per_step(s_cfg))
    if isinstance(trainer, DistillODETrainer):
        steps = trainer.train_cfg.get("ode_steps", 8)
        return {"ode": k1_counts(steps * 2 * n_t + graded, n_s)}
    if isinstance(trainer, SelfForceTrainer):
        # the rollout's cached forwards take plain attention
        return {"critic": k1_counts(graded, n_s),
                "student": k1_counts(2 * n_t + n_s, 0)}
    return {"critic": k1_counts(n_s + graded, n_s),
            "student": k1_counts(graded + 2 * n_t + n_s, n_s)}


def run_distill(dev, conf, base, steps: int, tag: str):
    """Train ``steps`` outer steps of ``base`` (counted) on ``conf``; fails
    unless every step's launches are exact and its metrics finite, the
    teacher bit-equal to its export, and the student, its EMA and (where
    it trains) the critic moved. Returns (trainer, state, summary)."""
    from owl_audio_exps_tpu_torch.utils.checkpoints import versatile_load
    tc = conf.train
    L = tc.data_kwargs.window_length * conf.model.tokens_per_frame
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = counted_distill(base)(conf, device=dev)
    t0 = time.perf_counter()
    state = trainer.train(max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = distill_expect(trainer, L)
    by_kind = {}
    for i, call in enumerate(trainer.calls):
        print(f"[{tag}]   {call['kind']} step {i + 1}: {call['s']:.3f} s "
              f"{call['metrics']} K1 "
              f"{[call['counts'][k] for k in K1_NAMES]}", flush=True)
        if not all(math.isfinite(v) for v in call["metrics"].values()):
            fail(f"{tag}: {call['kind']} step {i + 1} metrics not finite")
        if call["counts"] != expect[call["kind"]]:
            fail(f"{tag}: {call['kind']} step {i + 1} launched "
                 f"{call['counts']}, expected {expect[call['kind']]}")
        by_kind.setdefault(call["kind"], []).append(call["s"])

    teacher = versatile_load(tc.teacher_ckpt, map_location=dev)
    for name, p in trainer.teacher.named_parameters():
        if not torch.equal(p, teacher[name]):
            fail(f"{tag}: the teacher's {name} changed")
    init = trainer.initial_student
    moved = {"student": state.student.named_parameters(),
             "EMA": state.student_ema.items()}
    if "critic" in by_kind:
        moved["critic"] = state.critic.named_parameters()
    for what, named in moved.items():
        if all(torch.equal(p.detach().cpu(), init[n]) for n, p in named):
            fail(f"{tag}: the {what} did not change")
    print(f"[{tag}] teacher bit-equal to its export; "
          f"{', '.join(moved)} changed", flush=True)

    tokens = L * tc.batch_size * trainer.accum_steps()
    summary = dict(L=L, batch=tc.batch_size, steps=steps, wall_s=wall,
                   peak_gib=peak, tokens_per_micro_step=tokens,
                   launches_per_step={k: {n: c[n] for n in K1_NAMES}
                                      for k, c in expect.items()},
                   totals={n: sum(c["counts"][n] for c in trainer.calls)
                           for n in K1_NAMES})
    for kind, secs in by_kind.items():
        med = statistics.median(secs[1:] or secs)
        summary[f"{kind}_step_s"] = med
        summary[f"{kind}_tokens_per_s"] = tokens / med
        print(f"[{tag}] {kind} step: median {med:.4f} s (of {len(secs)}, "
              f"the first left out where there are more; min "
              f"{min(secs):.4f} max {max(secs):.4f}), {tokens / med:.0f} "
              f"tokens/s, K1 {[expect[kind][n] for n in K1_NAMES]} "
              f"(fwd, dq, dkv) a step", flush=True)
    print(f"[{tag}] {type(trainer).__bases__[0].__name__} on {tc.trainer_id}"
          f": {steps} outer steps in {wall:.1f} s, L {L}, batch "
          f"{tc.batch_size}, peak memory {peak:.2f} GiB "
          f"(max_memory_allocated)", flush=True)
    return trainer, state, summary


def distill_batch(trainer):
    from owl_audio_exps_tpu_torch.data import get_loader
    tc = trainer.train_cfg
    return trainer.to_device(next(iter(get_loader(
        tc.data_id, tc.batch_size, **dict(tc.data_kwargs.items())))))


def dmd_route_phase(dev):
    """One DMD loss at full width and 4 layers (teacher and student) through
    the kernels and through dense attention, on the same draws: loss and
    student gradients held to phase 6's limits."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.train import port_cuts
    from owl_audio_exps_tpu_torch.trainers.causvid import CausVidTrainer
    print("[distill-route] configs/dit_v4_dmd.yml at 4 layers, seeded "
          "teacher (the student's config, seed 1), student and critic "
          "(seed 0); one DMD loss", flush=True)
    batch, draws = None, None

    def one(attn_impl):
        nonlocal batch, draws
        conf = Config.from_yaml(os.path.join(ROOT, "configs",
                                             "dit_v4_dmd.yml"))
        port_cuts(conf, 1)
        conf.model.n_layers = 4
        conf.model.attn_impl = attn_impl
        for key in ("teacher_cfg", "teacher_ckpt", "student_ckpt"):
            conf.train[key] = None
        trainer = CausVidTrainer(conf, device=dev)
        state = trainer.init_distill_state()
        if batch is None:
            batch = distill_batch(trainer)
            draws = trainer.loss_draws(trainer.scaled_video(batch[0]),
                                       batch[1])
        reset_counts()
        loss, _ = trainer.dmd_loss(state.student, state.critic, batch, draws)
        loss.backward()
        counts = kernel_counts()
        return loss.item(), {n: p.grad.float() for n, p in
                             state.student.named_parameters()}, counts

    lk, gk, ck = one("auto")
    ld, gd, cd = one("dense")
    if not all(ck[n] for n in K1_NAMES) or any(cd.values()):
        fail(f"distill route: kernels {ck}, dense {cd}")
    loss_rel = abs(lk - ld) / abs(ld)
    num = sum((gk[n] - gd[n]).pow(2).sum() for n in gd)
    den = sum(gd[n].pow(2).sum() for n in gd)
    total = (num / den).sqrt().item()
    per = {n: rel_l2(gk[n], gd[n]) for n in gd if gd[n].norm() > 0}
    worst = max(per, key=per.get)
    print(f"[distill-route] kernels (K1 {[ck[n] for n in K1_NAMES]}) vs "
          f"dense: DMD loss {lk:.6f} vs {ld:.6f} (rel {loss_rel:.2e}, "
          f"tolerance {ROUTE_LOSS_REL}); student gradient rel L2 "
          f"{total:.3e} (tolerance {ROUTE_GRAD_REL_L2}), worst "
          f"{per[worst]:.3e} ({worst}; tolerance {ROUTE_PARAM_REL_L2})",
          flush=True)
    if loss_rel > ROUTE_LOSS_REL or total > ROUTE_GRAD_REL_L2 or \
            per[worst] > ROUTE_PARAM_REL_L2:
        fail("the DMD loss through the kernels disagrees with dense")
    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_l2=total, worst_param=per[worst])


def sf_rollout_check(trainer, state, tag):
    """One Self-Forcing rollout with gradient and its backward: no kernel
    of the port launches (the cached forwards take plain attention)."""
    vid, mouse, btn = distill_batch(trainer)[:3]
    vid = trainer.scaled_video(vid)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window, mask, *_ = trainer.get_rollouts(state.student, vid, mouse, btn,
                                            True)
    (window * mask[:, :, None, None, None]).sum().backward()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    check_no_port_kernels("the Self-Forcing rollout")
    state.student.zero_grad(set_to_none=True)
    if not torch.isfinite(window).all():
        fail(f"{tag}: the rollout is not finite")
    print(f"[{tag}] one rollout ({trainer.rollout_frames()} frames, "
          f"rollout_steps {trainer.train_cfg.rollout_steps}, ring of "
          f"{vid.shape[1]} frames) with its backward: {s:.3f} s, 0 port "
          f"kernels", flush=True)
    return s


def distilled_serve_phase(dev, export: str, conf):
    """The CausVid student's EMA export, read back with versatile_load
    into a core and served by the config's eval sampler for a few frames;
    no kernel of the port launches."""
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
    from owl_audio_exps_tpu_torch.utils.checkpoints import (unwrap_core,
                                                            versatile_load)
    cfg, tc = conf.model, conf.train
    core = GameRFTCore(cfg, dtype=torch.bfloat16, device=dev, seed=None)
    core.load_state_dict(unwrap_core(versatile_load(export,
                                                    map_location=dev)))
    core = core.to(torch.bfloat16).eval()
    kw = tc.sampler_kwargs.to_dict()
    print(f"[distill-serve] cut: sampler_kwargs num_frames "
          f"{kw['num_frames']} -> {DISTILL_SERVE_FRAMES} (a few frames)",
          flush=True)
    kw["num_frames"] = DISTILL_SERVE_FRAMES
    sampler = get_sampler_cls(tc.sampler_id)(**kw)
    n_ctx = 8
    gen = torch.Generator(device=dev).manual_seed(7)
    ctx = torch.randn(1, n_ctx, cfg.channels, cfg.sample_size,
                      cfg.sample_size, generator=gen, device=dev
                      ).to(torch.bfloat16)
    total = n_ctx + DISTILL_SERVE_FRAMES
    mouse = torch.zeros(1, total, 2, dtype=torch.bfloat16, device=dev)
    btn = torch.zeros(1, total, cfg.n_buttons, dtype=torch.bfloat16,
                      device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sampler(core, ctx, mouse, btn, generator=gen.manual_seed(8))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    check_no_port_kernels("the distilled student's serve")
    want = (1, total, cfg.channels, cfg.sample_size, cfg.sample_size)
    if tuple(out.shape) != want or not torch.isfinite(out.float()).all():
        fail(f"distilled serve: output {tuple(out.shape)} (want {want}) or "
             f"not finite")
    print(f"[distill-serve] {tc.sampler_id} ({kw['n_steps']} steps at "
          f"{kw.get('custom_schedule')}, cfg {kw['cfg_scale']}) on "
          f"{os.path.relpath(export, ROOT)}: {DISTILL_SERVE_FRAMES} frames "
          f"after {n_ctx} of context in {s:.2f} s (graph capture "
          f"included), std {out.float().std().item():.4f}, finite, 0 port "
          f"kernels", flush=True)
    del core, sampler
    return dict(frames=DISTILL_SERVE_FRAMES, s=s)


def distill_phase(dev):
    """Phase 12: the distillation trainers at dit_v4 width."""
    from owl_audio_exps_tpu_torch.trainers.causvid import CausVidTrainer
    from owl_audio_exps_tpu_torch.trainers.ode_distill import (
        DistillODETrainer, prune_layer_indices, transfer_pruned_params)
    from owl_audio_exps_tpu_torch.trainers.self_forcing import (
        SelfForceTrainer)
    from owl_audio_exps_tpu_torch.utils.checkpoints import (save_clean_export,
                                                            versatile_load)
    teacher = save_distill_teacher(dev)
    out = {}

    conf = distill_config("dit_v4_dmd.yml", teacher)
    trainer, state, out["CausVidTrainer"] = run_distill(
        dev, conf, CausVidTrainer, CAUSVID_STEPS, "distill-dmd")
    step_s = out["CausVidTrainer"]["student_step_s"]
    micro = [distill_batch(trainer)]
    out["CausVidTrainer"]["device_ms"] = profile_call(
        lambda: CausVidTrainer.student_step(trainer, state, micro), step_s,
        "distill-dmd")
    export = os.path.join(DISTILL_DIR, "dit_v4_dmd_export")
    save_clean_export(export, state.student_ema)
    print(f"[distill-dmd] the student's EMA exported with save_clean_export "
          f"(the trainer's output_path export) to "
          f"{os.path.relpath(export, ROOT)}", flush=True)
    del trainer, state, micro
    out["route"] = dmd_route_phase(dev)

    conf_sf = distill_config("dit_v4_sf.yml", teacher)
    trainer, state, out["SelfForceTrainer"] = run_distill(
        dev, conf_sf, SelfForceTrainer, SF_STEPS, "distill-sf")
    out["SelfForceTrainer"]["rollout_s"] = sf_rollout_check(
        trainer, state, "distill-sf")
    del trainer, state

    conf_ode = distill_config(
        "dit_v4_prune.yml", teacher,
        opt=("AdamW", "the reference's build_simple_opt rejects Muon, "
             "owl_audio_exps_tpu/trainers/distill_common.py:68"),
        batch_size=(1, "the 8 trajectory states stack on the batch axis: "
                    "at batch 8 that is 245,760 tokens with gradient"),
        student_ckpt=(None, "the 16-layer export does not fit the 8-layer "
                      "student; the reference raises in device_put, "
                      "owl_audio_exps_tpu/trainers/distill_common.py:"
                      "150-152; the student starts pruned from the "
                      "teacher"))
    trainer, state, out["DistillODETrainer"] = run_distill(
        dev, conf_ode, DistillODETrainer, ODE_STEPS, "distill-ode")
    n_t, n_s = trainer.teacher_cfg.n_layers, trainer.model_cfg.n_layers
    pruned = transfer_pruned_params(
        versatile_load(teacher, map_location="cpu"), n_t, n_s)
    if set(pruned) != set(trainer.initial_student) or not all(
            torch.equal(v, trainer.initial_student[n])
            for n, v in pruned.items()):
        fail("distill-ode: the student did not start as the pruned teacher")
    idx = prune_layer_indices(n_t, n_s)
    print(f"[distill-ode] the {n_s}-layer student started as teacher blocks "
          f"{idx} (transfer_pruned_params of the export, exact)", flush=True)
    out["DistillODETrainer"]["pruned_from"] = idx
    del trainer, state

    out["serve"] = distilled_serve_phase(dev, export, conf)
    import shutil
    shutil.rmtree(DISTILL_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[distill] still allocated after the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    return out


# --------------------------------------------------------------- phase 13
VAE_DIR = os.path.join(ROOT, "build", "chip_smoke_vae")
# decoded serve: ticks compared (decoded vs the decoders applied to the
# undecoded tick's latents) and timed, each pipeline in turn; the
# headless game loop's ticks (at most 60 a second, so its stats line,
# printed each second, comes at least once)
VAE_COMPARE_TICKS, VAE_TICKS, GAME_TICKS = 4, 12, 72
VAE_TRAIN_STEPS = 6
# float32 references of the VAEs run with TF32 off (main); the two forms
# of the audio decoder's transposed convolution agree to float32
# reassociation
UPCONV_REL_L2 = 1e-5


def dcae_flops(latent_channels: int, hw: int) -> int:
    """FLOPs (2 a multiply-add) of one DC-AE decode of an hw x hw latent,
    counted from the shapes on the meta device: every convolution and
    projection and the attention's products; elementwise work (norms,
    activations, shuffles) is not counted."""
    from owl_audio_exps_tpu_torch.nn import dcae
    m = dcae.DCAEDecoder(latent_channels=latent_channels, device="meta",
                         seed=None)
    total = [0]

    def dense(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    def attn(mod, inp, out):
        b, c, hh, ww = out.shape
        L, hd = hh * ww, mod.head_dim
        inner = mod.to_q.out_features
        g = (1 + len(mod.to_qkv_multiscale)) * inner // hd
        total[0] += 2 * b * L * c * 3 * inner      # the fused q, k, v
        if L > hd:     # v kᵀ, its product with q, and the key sums
            total[0] += 2 * b * g * L * hd * (2 * hd + 1)
        else:
            total[0] += 4 * b * g * L * L * hd

    for mod in m.modules():
        if isinstance(mod, (dcae.Conv2d,)) or type(mod).__name__ == "Linear":
            mod.register_forward_hook(dense)
        elif isinstance(mod, dcae.MultiscaleLinearAttention):
            mod.register_forward_hook(attn)
    with torch.no_grad():
        m(torch.zeros(1, latent_channels, hw, hw, device="meta"))
    return total[0]


def video_decode_phase(dev):
    """The DC-AE decoder at the JAX defaults (dc-ae-f64c128 widths) with
    configs/causvid.yml's 64 latent channels, seeded bf16 weights: ms a
    frame at batch 1 and 8, TFLOP/s, share of the bound, peak memory;
    bf16 against a float32 decode of the same weights."""
    from owl_audio_exps_tpu_torch.nn.dcae import DCAEDecoder
    from owl_audio_exps_tpu_torch.utils.owl_vae_bridge import (
        DCAEVideoDecoder)
    lc = phase11_config("causvid.yml").model.channels
    dec = DCAEVideoDecoder(latent_channels=lc, device=dev)
    n_params = sum(p.numel() for p in dec.module.parameters())
    w_bytes = sum(p.numel() * p.element_size()
                  for p in dec.module.parameters())
    flops = dcae_flops(lc, 8)
    gen = torch.Generator(device=dev).manual_seed(17)
    print(f"[vae13] DCAEDecoder (dc-ae-f64c128 widths, latent_channels {lc} "
          f"of configs/causvid.yml), {n_params:,} parameters, seeded bf16 "
          f"weights ({w_bytes / 2 ** 20:.1f} MiB), 8 x 8 latent -> 256 x 256 "
          f"x 3; {flops / 1e12:.4f} TFLOP a frame (convolutions, "
          f"projections, attention; counted from the shapes)", flush=True)
    out = dict(parameters=n_params, tflop_per_frame=flops / 1e12)
    for b in (1, 8):
        z = torch.randn(b, lc, 8, 8, generator=gen, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frames = dec(z)
        if tuple(frames.shape) != (b, 256, 256, 3) or \
                frames.dtype != torch.float32 or \
                not torch.isfinite(frames).all():
            fail(f"DCAE frames {tuple(frames.shape)} {frames.dtype} or not "
                 "finite")
        # warm-up past cuDNN's first plans for each shape and the clocks'
        # ramp (the first calls of the process)
        ms = cuda_ms(lambda: dec(z), 20, warmup=10) / b
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # per frame: the weights read once a call, a float32 latent in,
        # a float32 frame out
        row = bound_row(flops,
                        w_bytes / b + z[0].numel() * 4 + 256 * 256 * 3 * 4)
        bound, bound_by = row["bound_ms"], row["bound_by"]
        tflops = flops / (ms * 1e-3) / 1e12
        print(f"[vae13]   batch {b}: {ms:.4f} ms a frame, {tflops:.1f} "
              f"TFLOP/s, bound {bound:.4f} ms ({bound_by}) = "
              f"{100 * bound / ms:.1f}% of it, peak {peak:.2f} GiB",
              flush=True)
        out[f"batch_{b}"] = dict(ms_per_frame=ms, tflops=tflops,
                                 bound_ms=bound, bound_by=bound_by,
                                 share_of_bound=bound / ms, peak_gib=peak)
    # one traced batch-1 decode: device busy against its wall time
    z = torch.randn(1, lc, 8, 8, generator=gen, device=dev)
    per_name, wall = trace_call(lambda: dec(z))
    busy = sum(us for us, _ in per_name.values()) / 1e3
    kernels = sum(c for _, c in per_name.values())
    print(f"[vae13]   one traced batch-1 decode: {kernels} kernels, device "
          f"busy {busy:.2f} ms of {wall:.2f} ms wall "
          f"({100 * busy / wall:.1f}%); the largest:", flush=True)
    for name, (us, c) in sorted(per_name.items(),
                                key=lambda kv: -kv[1][0])[:6]:
        print(f"[vae13]     {us / 1e3:7.3f} ms {c:4d}x {name[:90]}",
              flush=True)
    out["traced_batch_1"] = dict(kernels=kernels, busy_ms=busy,
                                 wall_ms=wall)
    # float32 on the same (bf16-rounded) weights, TF32 off
    ref = DCAEDecoder(latent_channels=lc, dtype=torch.float32, device=dev,
                      seed=None).eval()
    ref.load_state_dict({k: v.float() for k, v in
                         dec.module.state_dict().items()})
    ref = ref.to(memory_format=torch.channels_last)
    z = torch.randn(2, lc, 8, 8, generator=gen, device=dev)
    with torch.no_grad():
        want = ref(z).permute(0, 2, 3, 1)
    err = rel_l2(dec(z), want)
    f32_ms = cuda_ms(lambda: ref(z), 3) / 2
    print(f"[vae13]   bf16 vs a float32 decode of the same weights (TF32 "
          f"off, {f32_ms:.2f} ms a frame): rel L2 {err:.3e} (tolerance "
          f"{FORWARD_REL_L2})", flush=True)
    if err > FORWARD_REL_L2:
        fail("the bf16 DCAE decode disagrees with float32")
    out.update(bf16_vs_f32_rel_l2=err, f32_ms_per_frame=f32_ms)
    del dec, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def audio_codec_phase(dev):
    """The bridge's audio decoder on one latent (a tick) and on a
    120-latent window, its encoder on 88,200 samples at batch 16, bf16
    against float32 on the same weights; both forms of every transposed
    convolution in float32 at the window's shapes."""
    from owl_audio_exps_tpu_torch.nn.audio_vae import (AudioDecoder,
                                                       AudioEncoder)
    from owl_audio_exps_tpu_torch.utils.owl_vae_bridge import (
        SAMPLES_PER_LATENT, get_audio_encoder_decoder)
    lc = phase11_config("causvid.yml").model.audio_channels
    enc, adec = get_audio_encoder_decoder(latent_channels=lc, device=dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    tick = torch.randn(1, 1, lc, generator=gen, device=dev)
    window = torch.randn(1, 120, lc, generator=gen, device=dev)
    wf = 0.3 * torch.randn(16, 120 * SAMPLES_PER_LATENT, 2, generator=gen,
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    rows = dict(decode_tick_ms=cuda_ms(lambda: adec(tick), 20, warmup=10),
                decode_window_ms=cuda_ms(lambda: adec(window), 20,
                                         warmup=10),
                encode_b16_ms=cuda_ms(lambda: enc(wf), 10, warmup=5),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    refs = []
    for fast, cls in ((enc, AudioEncoder), (adec, AudioDecoder)):
        ref = cls(latent_channels=lc, dtype=torch.float32, device=dev).eval()
        ref.load_state_dict({k: v.float() for k, v in
                             fast.module.state_dict().items()})
        refs.append(ref)
    with torch.no_grad():
        errs = dict(decode_window=rel_l2(adec(window), refs[1](window)),
                    encode_b16=rel_l2(enc(wf), refs[0](wf)))
    up_errs, t = {}, 120
    with torch.no_grad():
        for i in range(refs[1].n_stages):
            up = getattr(refs[1], f"up_{i}")
            x = torch.randn(1, up.weight.shape[1], t, generator=gen,
                            device=dev)
            up_errs[f"up_{i}"] = rel_l2(up(x), up.dilated(x))
            t *= up.s
    print(f"[vae13] audio VAE of the bridge (latent_channels {lc}), seeded "
          f"bf16 weights: decode one latent (735 samples) "
          f"{rows['decode_tick_ms']:.3f} ms, a 120-latent window (88,200 "
          f"samples) {rows['decode_window_ms']:.3f} ms; encode 16 x 88,200 "
          f"samples {rows['encode_b16_ms']:.3f} ms; peak "
          f"{rows['peak_gib']:.2f} GiB; bf16 vs float32 rel L2 "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance "
          f"{FORWARD_REL_L2}); conv_transpose1d vs the zero-dilated form, "
          f"float32, rel L2 { {k: f'{v:.2e}' for k, v in up_errs.items()} } "
          f"(tolerance {UPCONV_REL_L2})", flush=True)
    if any(e > FORWARD_REL_L2 for e in errs.values()):
        fail("the bf16 audio VAE disagrees with float32")
    if any(e > UPCONV_REL_L2 for e in up_errs.values()):
        fail("the two forms of the transposed convolution disagree")
    rows.update(bf16_vs_f32_rel_l2=errs, upconv_forms_rel_l2=up_errs)
    del enc, adec, refs
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def decoded_serve_phase(dev):
    """``AVCachedStreamingPipeline`` at configs/causvid.yml's width (as
    phase 11: ring 120, 2 steps, fused write, graphed) decoding every
    tick through DC-AE and the bridge's audio decoder, at 1 and 8
    sessions, beside an undecoded pipeline on the same draws; then the
    headless game loop with --vae dcae."""
    import contextlib
    import io
    import numpy as np
    from owl_audio_exps_tpu_torch.inference import game_cv
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.utils.owl_vae_bridge import (
        DCAEVideoDecoder, get_audio_encoder_decoder,
        make_batched_audio_decode_fn, make_batched_decode_fn)

    cfg = pipeline_config()
    tc = phase11_config("causvid.yml").train
    core = make_core(cfg, dev, seed=7)
    dec = DCAEVideoDecoder(latent_channels=cfg.channels, device=dev)
    _, adec = get_audio_encoder_decoder(latent_channels=cfg.audio_channels,
                                        device=dev)
    fdec = make_batched_decode_fn(dec, tc.vae_batch_size)
    afn = make_batched_audio_decode_fn(adec, tc.vae_batch_size)
    scales = dict(image_scale=tc.vae_scale, audio_scale=tc.audio_vae_scale)
    print(f"[vae13] decoded serve: frames through DC-AE and audio through "
          f"the bridge, {tc.vae_batch_size} at a time (vae_batch_size), "
          f"scales {scales} (configs/causvid.yml)", flush=True)
    rs = np.random.RandomState(7)
    gen = torch.Generator(device=dev).manual_seed(43)
    p = cfg.sample_size
    out = {}
    for B in PIPE_SESSIONS:
        reset_counts()
        ctx = (torch.randn(B, PIPE_PRIME, cfg.channels, p, p, generator=gen,
                           device=dev),
               torch.randn(B, PIPE_PRIME, cfg.audio_channels, generator=gen,
                           device=dev),
               torch.randn(B, PIPE_PRIME, 2, generator=gen, device=dev),
               (torch.rand(B, PIPE_PRIME, cfg.n_buttons, generator=gen,
                           device=dev) > 0.5).float())
        kw = dict(window_frames=PIPE_WINDOW, sampling_steps=PIPE_STEPS,
                  seed=9, n_sessions=B, fused_write=True, device=dev)
        decoded = AVCachedStreamingPipeline(
            core, cfg, frame_decode_fn=fdec, audio_decode_fn=afn, **scales,
            **kw)
        plain = AVCachedStreamingPipeline(core, cfg, **kw)
        for pipe in (decoded, plain):
            pipe.prime(*ctx)
        d_ms, u_ms, diff = [], [], 0.0
        for i in range(VAE_COMPARE_TICKS + VAE_TICKS):
            ctrl = (rs.randn(B, 2).astype(np.float32),
                    (rs.rand(B, cfg.n_buttons) > 0.5).astype(np.float32))
            frame, audio, secs_d = decoded(*ctrl)
            lat, alat, secs_u = plain(*ctrl)
            if i < VAE_COMPARE_TICKS:
                want_f = fdec(lat[:, None] * tc.vae_scale)
                want_f = want_f[0] if B == 1 else want_f
                want_a = afn(alat[:, None] * tc.audio_vae_scale)
                diff = max(diff, max_abs(frame, want_f),
                           max_abs(audio, want_a))
            else:
                d_ms.append(1e3 * secs_d)
                u_ms.append(1e3 * secs_u)
        shape = (1, 256, 256, 3) if B == 1 else (B, 1, 256, 256, 3)
        if tuple(frame.shape) != shape or \
                tuple(audio.shape) != (B, 735, 2) or \
                not (torch.isfinite(frame).all()
                     and torch.isfinite(audio).all()):
            fail(f"decoded tick output {tuple(frame.shape)} "
                 f"{tuple(audio.shape)} or not finite")
        if diff > CACHED_GRAPH_MAX_ABS:
            fail(f"{B} sessions: the decoded tick disagrees with the "
                 "decoders applied to the undecoded tick's latents")
        check_no_port_kernels(f"the decoded serve ({B} sessions)")
        dm, um = statistics.median(d_ms), statistics.median(u_ms)
        print(f"[vae13] {B} session(s): frames {tuple(frame.shape)}, audio "
              f"{tuple(audio.shape)}; decoded tick vs the decoders on the "
              f"undecoded tick's latents (same draws, {VAE_COMPARE_TICKS} "
              f"ticks) max |diff| {diff:.3e} (tolerance "
              f"{CACHED_GRAPH_MAX_ABS}); ms a tick median decoded {dm:.2f} "
              f"(min {min(d_ms):.2f}), undecoded {um:.2f} (min "
              f"{min(u_ms):.2f}) over {VAE_TICKS} ticks each in turn: "
              f"decoding adds {dm - um:.2f} ms; no port kernel launched",
              flush=True)
        out[f"sessions_{B}"] = dict(tick_ms_decoded=dm, tick_ms_undecoded=um,
                                    decode_vs_latents_max_abs=diff)
        del decoded, plain
        gc.collect()
        torch.cuda.empty_cache()
    del core, dec, adec, fdec, afn
    gc.collect()
    torch.cuda.empty_cache()

    # the game loop reads a config file: configs/causvid.yml with phase
    # 11's RoPE cut, so its 8 + GAME_TICKS frames stay inside the table
    import yaml
    with open(os.path.join(ROOT, "configs", "causvid.yml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["rope_headroom"] = cfg.rope_headroom
    os.makedirs(VAE_DIR, exist_ok=True)
    cfg_path = os.path.join(VAE_DIR, "causvid_rope.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    reset_counts()
    buf = io.StringIO()
    argv = ["--config_path", cfg_path, "--headless", "--vae", "dcae",
            "--ticks", str(GAME_TICKS)]
    with contextlib.redirect_stdout(buf):
        ticks = game_cv.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("fps=")]
    print(f"[vae13] game_cv.main on configs/causvid.yml (rope_headroom "
          f"{cfg.rope_headroom}, as above) {' '.join(argv[2:])}: {ticks} "
          f"ticks; its stats: {lines}", flush=True)
    check_no_port_kernels("the headless game loop")
    if ticks != GAME_TICKS or not lines:
        fail("the headless game loop printed no FPS line")
    out["game_cv_fps_lines"] = lines
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vae_train_phase(dev):
    """configs/audio_vae.yml as written (batch 16, 88,200-sample windows,
    AdamW 1e-4 / wd 1e-4) with two cuts, printed: root_dir -> seeded tone
    files this phase writes, and VAE_TRAIN_STEPS steps."""
    import shutil
    import numpy as np
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls

    conf = phase11_config("audio_vae.yml")
    tc = conf.train
    root = os.path.join(VAE_DIR, "waveforms")
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(23)
    for i in range(8):      # 3 s stereo tones with noise
        t = np.arange(3 * 44100) / 44100.0
        f = rs.uniform(80, 4000, size=2)
        wf = 0.4 * np.sin(2 * np.pi * f[None] * t[:, None]) \
            + 0.02 * rs.randn(t.size, 2)
        torch.save(torch.from_numpy(wf.astype(np.float32)),
                   os.path.join(root, f"tone{i}_wf.pt"))
    print(f"[vae13] configs/audio_vae.yml: batch {tc.batch_size} x "
          f"{tc.data_kwargs.window_length} samples, opt_kwargs "
          f"{tc.opt_kwargs.to_dict()}; cuts: data_kwargs.root_dir "
          f"{tc.data_kwargs.root_dir!r} -> 8 seeded 3 s tone files under "
          f"{os.path.relpath(root, ROOT)} (no waveform data in the "
          f"repository), {VAE_TRAIN_STEPS} steps; checkpoint_dir -> "
          f"{os.path.relpath(VAE_DIR, ROOT)} (save_interval "
          f"{tc.save_interval}: no save in these steps)", flush=True)
    tc.data_kwargs.root_dir = root
    tc.checkpoint_dir = os.path.join(VAE_DIR, "ckpt")
    trainer = get_trainer_cls(tc.trainer_id)(conf, device=dev)
    logs, init = [], {}
    trainer.logger.log = lambda log, step: logs.append(dict(log))
    make_state = trainer.init_state

    def init_state(seed=0):
        state = make_state(seed)
        init.update({n: p.detach().clone()
                     for n, p in state.model.named_parameters()})
        return state

    trainer.init_state = init_state
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.train(max_steps=VAE_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_no_port_kernels("the audio VAE trainer")
    if state.step != VAE_TRAIN_STEPS or len(logs) != VAE_TRAIN_STEPS:
        fail("the audio VAE trainer did not take its steps")
    for log in logs:
        if not all(math.isfinite(log[k])
                   for k in ("loss", "l1", "stft", "latent_l2")):
            fail(f"audio VAE metrics not finite: {log}")
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p.detach(), init[n])
             and not torch.equal(state.ema[n], init[n])]
    if len(moved) != len(init):
        fail(f"params or EMA unchanged: "
             f"{sorted(set(init) - set(moved))[:4]}")
    step_s = statistics.median(log["time"] for log in logs[1:])
    audio_s = tc.batch_size * tc.data_kwargs.window_length / 44100.0
    print(f"[vae13] audio VAE trainer, {VAE_TRAIN_STEPS} steps: s/step "
          f"median of steps 2-{VAE_TRAIN_STEPS} {step_s:.4f} (first "
          f"{logs[0]['time']:.2f} s), {audio_s / step_s:.1f} audio-seconds "
          f"a second, peak {peak:.2f} GiB; loss {logs[0]['loss']:.4f} -> "
          f"{logs[-1]['loss']:.4f}, metrics finite, every parameter and its "
          f"EMA changed", flush=True)
    del trainer, state, init
    shutil.rmtree(VAE_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_s=step_s, first_step_s=logs[0]["time"],
                audio_seconds_per_s=audio_s / step_s, peak_gib=peak,
                loss_first=logs[0]["loss"], loss_last=logs[-1]["loss"])


def av_export_phase(dev):
    """One AV clip sampled by configs/av_v5_8x8_weak.yml's eval sampler
    (frames cut as in phase 11) on a seeded core, decoded through the
    trainer's decoders with vae_id dcae, and its WAV written and read
    back. The GIF and AVI writers need PIL, which the CPU tests hold."""
    from scipy.io import wavfile
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
    from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
    from owl_audio_exps_tpu_torch.utils.media import write_wav

    conf = phase11_config("av_v5_8x8_weak.yml")
    cfg, tc = conf.model, conf.train
    kw = tc.sampler_kwargs.to_dict()
    print(f"[vae13] AV eval export on configs/av_v5_8x8_weak.yml: cuts "
          f"vae_id {tc.vae_id!r} -> 'dcae' (the decoder this phase runs), "
          f"num_frames {kw['num_frames']} -> {CAUSAL_FRAMES} for time",
          flush=True)
    tc.vae_id = "dcae"
    kw["num_frames"] = CAUSAL_FRAMES
    trainer = get_trainer_cls(tc.trainer_id)(conf, device=dev)
    core = make_core(cfg, dev, seed=6)
    sampler = get_sampler_cls(tc.sampler_id)(**kw)
    W = sampler.window_length
    gen = torch.Generator(device=dev).manual_seed(37)
    bf = torch.bfloat16
    p = cfg.sample_size
    x = torch.randn(1, W, cfg.channels, p, p, generator=gen,
                    device=dev).to(bf)
    a = torch.randn(1, W, cfg.audio_channels, generator=gen,
                    device=dev).to(bf)
    m = torch.randn(1, W, 2, generator=gen, device=dev).to(bf)
    b = (torch.rand(1, W, cfg.n_buttons, generator=gen, device=dev)
         > 0.5).to(bf)
    reset_counts()
    _, _, xl, al, em, eb = sampler(core, x, a, m, b, generator=gen)
    t0 = time.perf_counter()
    frames, wf, mouse, btn = trainer.decode_media(xl, al, em, eb)
    secs = time.perf_counter() - t0
    check_no_port_kernels("the AV export's decode")
    n = min(xl.shape[1], al.shape[1], em.shape[1], eb.shape[1])
    if frames.shape != (n, 256, 256, 3) or wf.shape != (n * 735, 2) or \
            mouse.shape != (n, 2) or not (np_finite(frames)
                                          and np_finite(wf)):
        fail(f"AV export decode {frames.shape} {wf.shape} or not finite")
    os.makedirs(VAE_DIR, exist_ok=True)
    path = write_wav(os.path.join(VAE_DIR, "step_0.wav"), wf)
    rate, back = wavfile.read(path)
    if rate != 44100 or back.shape != wf.shape:
        fail(f"the exported WAV reads back as {rate} Hz {back.shape}")
    print(f"[vae13]   a {n}-frame clip sampled ({tc.sampler_id}), decoded "
          f"in {secs:.2f} s through the trainer's decoders: frames "
          f"{frames.shape}, waveform {wf.shape}; {os.path.relpath(path, ROOT)} "
          f"written and read back at {rate} Hz", flush=True)
    import shutil
    shutil.rmtree(VAE_DIR, ignore_errors=True)
    del trainer, core, sampler
    gc.collect()
    torch.cuda.empty_cache()
    return dict(frames=n, decode_s=secs)


def np_finite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(a).all())


def vae_phase(dev):
    """Phase 13: the VAEs, the decoded serve, the audio VAE trainer and
    the AV export's decode; reaches no kernel of the port."""
    out = dict(video_decode=video_decode_phase(dev),
               audio_codec=audio_codec_phase(dev),
               decoded_serve=decoded_serve_phase(dev),
               audio_vae_train=vae_train_phase(dev),
               av_export=av_export_phase(dev), port_kernel_launches=0)
    print(f"[vae13] still allocated after the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    return out


# --------------------------------------------------------------- phase 14
PACKED_DIR = os.path.join(ROOT, "build", "chip_smoke_packed")
# the table: documents of 128-channel 8 x 8 video latents (float16), mouse
# and buttons, their lengths drawn from a seed in [200, 2000] frames, so a
# 1,536-frame window holds several documents and cuts some
PACKED_DOCS, PACKED_DOC_FRAMES, PACKED_SEED = 80, (200, 2000), 14
PACKED_STEPS = 3
# K1 with the loader's documents against its plain version: a 256-frame
# packed window (L 16,384), the global and the local layers' masks
PACKED_CHECK_FRAMES = 256
# at the full window the plain version takes this many queries at a time
# (2 heads x 4,096 queries x 98,304 keys of f32 scores: 3.2 GB)
FULL_CHECK_QUERIES = 4096
# MeanFlow at av_v5_8x8_weak.yml's width: 15 frames (975 tokens, below
# K1's 1,024 threshold, as the reference's only on-chip MeanFlow run);
# then one forward of the objective at 16 frames (1,040 tokens)
MFT_FRAMES, MFT_BATCH, MFT_STEPS, MFT_K1_FRAMES = 15, 2, 3, 16
# --packed-fit: dit_v4.yml without remat at its window and the offered cuts
PACKED_FIT_WINDOWS = (1536, 1024, 768, 512)
# the native gather against its plain version on a warm page cache:
# (window frames, windows a batch) of the cod loaders of
# configs/dit_v4_prune.yml (60 x 8) and configs/dit_v2.yml (1,000 x 1),
# and 3 windows of the packed 1,536; each timed GATHER_REPS times, the two
# read paths alternating which goes first
GATHER_CASES = ((60, 8), (1000, 1), (1536, 3))
GATHER_REPS = 10


class TimedIter:
    """An iterator that keeps the seconds each ``next`` took."""

    def __init__(self, it):
        self.it, self.times = it, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self.it)
        self.times.append(time.perf_counter() - t0)
        return item


def write_packed_table(path: str, cfg, docs: int = PACKED_DOCS,
                       doc_frames=PACKED_DOC_FRAMES):
    """The phase's npy table (``docs`` documents of ``doc_frames`` frames),
    written with the port's NpyTable from PACKED_SEED; returns the
    document lengths."""
    import numpy as np
    from owl_audio_exps_tpu_torch.data.npy_table import NpyTable

    rng = np.random.default_rng(PACKED_SEED)
    lens = rng.integers(doc_frames[0], doc_frames[1] + 1, docs)
    table = NpyTable(path, columns=[
        "video", "mouse", "buttons", "tarball", "pt_idx", "missing",
        "truncated", "seq_len"], array_columns=["video", "mouse", "buttons"])
    p = cfg.sample_size
    for i, n in enumerate(lens):
        n = int(n)
        table.append(
            video=rng.standard_normal((n, cfg.channels, p, p),
                                      dtype=np.float32).astype(np.float16),
            mouse=rng.standard_normal((n, 2), dtype=np.float32),
            buttons=(rng.random((n, cfg.n_buttons)) > 0.5).astype(
                np.float32),
            tarball=f"doc{i}", pt_idx=i, missing=False, truncated=False,
            seq_len=n)
    return [int(n) for n in lens]


def print_cut(tag, name, node, key, value, why):
    print(f"[{tag}] cut from configs/{name}: {key} {node.get(key)!r} -> "
          f"{value!r} ({why})", flush=True)
    node[key] = value


def packed_config(table: str, remat: bool = True, tag: str = "packed"):
    """configs/dit_v4.yml with the phase's cuts, each printed; group
    remat unless ``remat`` is false."""
    from owl_audio_exps_tpu_torch.configs import Config

    conf = Config.from_yaml(os.path.join(ROOT, "configs", "dit_v4.yml"))
    mc, tc = conf.model, conf.train
    why_remat = ("without it one step runs out of the card's memory at "
                 "the written 1,536-frame window and at the 1,024-frame "
                 "cut (python3 chip_smoke.py --packed-fit); remat changes "
                 "no value, and configs/dit_v4_98k_sp.yml sets it for "
                 "this length")
    cuts = [(tc.data_kwargs, "dataset_path", table, "the phase's table"),
            (tc.sample_data_kwargs, "dataset_path", table,
             "the phase's table; the eval never samples in this run"),
            (tc, "target_batch_size", tc.batch_size,
             "accumulation 16 -> 1"),
            (tc, "sample_interval", PACKED_STEPS + 1, "past the run")]
    if remat:
        cuts += [(mc, "gradient_checkpointing", True, why_remat),
                 (mc, "remat_granularity", "group", why_remat)]
    for node, key, value, why in cuts:
        print_cut(tag, "dit_v4.yml", node, key, value, why)
    return conf


def packed_fit_phase(dev):
    """``python3 chip_smoke.py --packed-fit``: configs/dit_v4.yml from the
    phase's packed table without remat, as written (a 1,536-frame window)
    and at each window cut offered for a card the written window does not
    fit (1,024 / 768 / 512 frames), two steps each: its step time and
    peak memory, or the CUDA out-of-memory error it raised. This is why
    phase 14 trains the written window with group remat."""
    import shutil
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import RFTTrainer

    shutil.rmtree(PACKED_DIR, ignore_errors=True)
    table = os.path.join(PACKED_DIR, "table")
    write_packed_table(table, Config.from_yaml(
        os.path.join(ROOT, "configs", "dit_v4.yml")).model)
    results = {}
    for frames in PACKED_FIT_WINDOWS:
        conf = packed_config(table, remat=False, tag="fit")
        if frames != conf.train.data_kwargs.window_length:
            print_cut("fit", "dit_v4.yml", conf.train.data_kwargs,
                      "window_length", frames, "the offered window cut")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = counted_trainer(RFTTrainer)(conf, device=dev)
        try:
            trainer.train(max_steps=2)
            res = dict(fits=True, step_s=trainer.steps[-1]["s"])
        except torch.OutOfMemoryError as e:
            res = dict(fits=False, error=str(e).splitlines()[0])
        res.update(frames=frames, L=frames * conf.model.tokens_per_frame,
                   steps_done=len(trainer.steps),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        trainer = None
        print(f"[fit] dit_v4.yml without remat, {frames} frames "
              f"(L = {res['L']}): " + (
                  f"fits, step 2 {res['step_s']:.3f} s" if res["fits"] else
                  f"out of memory after {res['steps_done']} steps: "
                  f"{res['error']}")
              + f"; peak allocated {res['peak_gib']:.2f} GiB", flush=True)
        results[frames] = res
    shutil.rmtree(PACKED_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return results


def packed_train_phase(dev, table: str):
    """(a) RFTTrainer on configs/dit_v4.yml from the packed table: exact
    K1 launches per step (every layer on K1, no band), s/step, tokens/s,
    MFU, peak memory, one traced step, the loader's time per batch and
    the share of the step spent waiting on the prefetch queue."""
    import gc
    from owl_audio_exps_tpu_torch.nn.attn import (attention_forwards_per_step,
                                                  attention_route,
                                                  local_layer_flags)
    from owl_audio_exps_tpu_torch.trainers import base as trainer_base
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import RFTTrainer
    from owl_audio_exps_tpu_torch.utils.mfu import (H100_PEAK_TFLOPS,
                                                    training_flops_per_token)

    conf = packed_config(table)
    cfg, tc = conf.model, conf.train
    L = tc.data_kwargs.window_length * cfg.tokens_per_frame
    expect = dict.fromkeys(kernel_counts(), 0)
    expect.update(frame_attention_fwd=sum(attention_forwards_per_step(cfg)),
                  frame_attention_bwd_dq=cfg.n_layers,
                  frame_attention_bwd_dkv=cfg.n_layers)

    loads = []
    real_get_loader = trainer_base.get_loader

    def timed_get_loader(*a, **kw):
        loader = TimedIter(iter(real_get_loader(*a, **kw)))
        loads.append(loader)
        return loader

    class PackedTrainer(counted_trainer(RFTTrainer)):
        waits = None

        def data_stream(self, *a, **kw):
            stream = TimedIter(super().data_stream(*a, **kw))
            self.waits = self.waits or stream
            return stream

    trainer_base.get_loader = timed_get_loader
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer = PackedTrainer(conf, device=dev)
        t0 = time.perf_counter()
        state = trainer.train(max_steps=PACKED_STEPS)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        batch = next(trainer.data_stream(tc.data_id, tc.batch_size,
                                         tc.data_kwargs))
    finally:
        trainer_base.get_loader = real_get_loader
    doc = batch[3]
    routes = {attention_route(cfg, local, L, doc)
              for local in set(local_layer_flags(cfg))}
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[packed] RFTTrainer {cfg.n_layers} layers x d {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M params fp32, data {tc.data_id} window "
          f"{tc.data_kwargs.window_length} frames (L = {L}), batch "
          f"{tc.batch_size}, opt {tc.opt}, remat {cfg.remat_granularity}: "
          f"{PACKED_STEPS} steps in {wall:.1f} s; layer routes with the "
          f"batch's doc_id {sorted(routes)}; documents in the first window "
          f"{n_docs(doc)}; expected launches per step "
          f"{ {k: n for k, n in expect.items() if n} }", flush=True)
    if routes != {("splash", None)}:
        fail(f"packed: a layer does not route to K1: {routes}")
    if doc.dtype != torch.int32 or tuple(doc.shape) != (
            1, tc.data_kwargs.window_length) or n_docs(doc) < 2:
        fail(f"packed: doc_id {doc.dtype} {tuple(doc.shape)} with "
             f"{n_docs(doc)} documents")
    for i, st in enumerate(trainer.steps):
        print(f"[packed]   step {i + 1}: {st['s']:.3f} s loss "
              f"{st['loss']:.5f} launches "
              f"{ {k: n for k, n in st['counts'].items() if n} }",
              flush=True)
        if not math.isfinite(st["loss"]):
            fail(f"packed step {i + 1}: loss not finite")
        if st["counts"] != expect:
            fail(f"packed step {i + 1}: kernel launches {st['counts']}, "
                 f"expected {expect}")
        # one document summary for each K1 forward with documents
        if st["doc_tiles"] != expect["frame_attention_fwd"]:
            fail(f"packed step {i + 1}: {st['doc_tiles']} document summary "
                 f"launches, expected {expect['frame_attention_fwd']}")
    print(f"[packed]   document summary launches per step "
          f"{[st['doc_tiles'] for st in trainer.steps]} (one a K1 "
          f"forward)", flush=True)
    timed = [st["s"] for st in trainer.steps[1:]]
    step_s = statistics.median(timed)
    tokens = L * tc.batch_size * trainer.accum_steps()
    mfu = training_flops_per_token(cfg, L) * tokens / step_s / \
        (H100_PEAK_TFLOPS * 1e12)
    load_s = loads[0].times
    waits = trainer.waits.times
    wait_share = sum(waits[1:]) / (sum(waits[1:]) + sum(timed))
    print(f"[packed] s/step median {step_s:.4f} (steps 2-{PACKED_STEPS}, "
          f"min {min(timed):.4f} max {max(timed):.4f}), "
          f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of "
          f"{H100_PEAK_TFLOPS:.0f} TFLOP/s (the formula's causal FLOPs; the "
          f"documents mask some away), peak memory {peak_gb:.2f} GiB "
          f"(max_memory_allocated)", flush=True)
    print(f"[packed] loader: {len(load_s)} batches read, "
          f"{1e3 * statistics.median(load_s):.1f} ms a batch (median; "
          f"first {1e3 * load_s[0]:.1f} ms); the trainer waited on the "
          f"prefetch queue {1e3 * waits[0]:.1f} ms before step 1 and "
          f"{[round(1e3 * w, 2) for w in waits[1:]]} ms before steps "
          f"2-{PACKED_STEPS}: {100 * wait_share:.2f}% of those steps",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(97)
    breakdown = profile_step(trainer, state, [batch], gen, step_s,
                             tag="packed")
    out = dict(window_frames=tc.data_kwargs.window_length, L=L,
               step_s=step_s, tokens_per_s=tokens / step_s, mfu=mfu,
               peak_gib=peak_gb, losses=[st["loss"] for st in trainer.steps],
               loader_ms_per_batch=1e3 * statistics.median(load_s),
               prefetch_wait_share=wait_share, device_ms=breakdown,
               per_step=expect,
               totals={k: sum(st["counts"][k] for st in trainer.steps)
                       for k in expect},
               doc_tile_totals=sum(st["doc_tiles"] for st in trainer.steps))
    del trainer, state, batch, doc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mask_name(window) -> str:
    return "global" if window is None else f"w{window}"


def doc_spans(doc):
    """[(first frame, end frame)] of the runs of equal ids in a per-frame
    doc_id row."""
    ids = doc.tolist()
    starts = [0] + [f for f in range(1, len(ids)) if ids[f] != ids[f - 1]]
    return list(zip(starts, starts[1:] + [len(ids)]))


def query_chunks(L, tpf, window, doc, chunk, device=None):
    """The query chunks of K1's frame-causal mask where its [L, L] f32
    scores do not fit (the packed window, L 98,304; the MMDiT's, L
    65,000): [(first query, end query, first key, the chunk's mask)],
    ``chunk`` queries at a time over the keys from the first frame those
    queries see to their end; ``doc`` per-frame [1, n_frames] or None."""
    from owl_audio_exps_tpu_torch.ops.masks import dense_mask

    if chunk % tpf or L % tpf:
        fail(f"plain: {chunk} queries or L {L} not whole frames of {tpf}")
    nf = L // tpf
    device = doc.device if doc is not None else device
    f = torch.arange(nf, device=device)
    seen = f[None] <= f[:, None]
    if doc is not None:
        seen &= doc[0][None] == doc[0][:, None]
    if window is not None:
        seen &= f[:, None] - f[None] < window
    first = torch.where(seen, f[None], nf).amin(1).tolist()
    parts = []
    for a in range(0, L, chunk):
        b = min(a + chunk, L)
        lo = min(first[a // tpf:b // tpf]) * tpf
        parts.append((a, b, lo, dense_mask(
            b - lo, tpf, window,
            None if doc is None else doc[:, lo // tpf:b // tpf].long(),
            a - lo, True, device=device)))
    return parts


def query_chunked_plain(parts):
    """K1's plain version a chunk of queries at a time (the ``parts`` of
    ``query_chunks``): the port's dot_attention on each chunk under a
    checkpoint, so that the backward recomputes it. Returns fn(q, k, v,
    *mask args) for fwd_case and grad_case; it takes the mask the parts
    were made with."""
    from torch.utils.checkpoint import checkpoint
    from owl_audio_exps_tpu_torch.ops.attention import dot_attention

    def plain(q, k, v, *_):
        scale = q.shape[-1] ** -0.5
        return torch.cat([checkpoint(
            dot_attention, q[:, :, a:b] * scale, k[:, :, lo:b],
            v[:, :, lo:b], mask, 1.0, use_reentrant=False)
            for a, b, lo, mask in parts], dim=2)
    return plain


def query_chunked_sdpa(parts):
    """The library yardstick where one SDPA call's [L, L] mask does not
    fit: ``F.scaled_dot_product_attention`` with the same mask on the
    ``parts`` of ``query_chunks``, one call a chunk (its time is the sum
    of the chunks' calls). Returns fn(q, k, v) for fwd_case and
    grad_case."""
    import torch.nn.functional as F

    def sdpa(q, k, v):
        return torch.cat([F.scaled_dot_product_attention(
            q[:, :, a:b], k[:, :, lo:b], v[:, :, lo:b],
            attn_mask=mask[None, None] if mask.ndim == 2 else mask[:, None])
            for a, b, lo, mask in parts], dim=2)
    return sdpa


def packed_kernel_phase(dev, table: str, cfg):
    """(b) K1 with the documents of the loader's packed windows: at L
    16,384 forward and backward against the plain version at every head
    (global and local masks); at the full window (L 98,304) forward and
    backward against the plain version taken a chunk of queries at a time
    (query_chunked_plain), and the packed output against K1 run on each
    document's span alone; and the native gather against its plain
    version, byte for byte and timed on a warm page cache."""
    from owl_audio_exps_tpu_torch.data.latent_seq_packing import \
        PackedSequenceDataset
    from owl_audio_exps_tpu_torch.ops import splash

    tpf, W = cfg.tokens_per_frame, cfg.local_window
    ds = PackedSequenceDataset(table, PACKED_CHECK_FRAMES)
    ds.set_epoch(0)
    item = next(ds[i] for i in range(len(ds))
                if len(set(ds[i]["doc_id"].tolist())) > 1)
    doc = torch.from_numpy(item["doc_id"])[None].to(dev)
    L = PACKED_CHECK_FRAMES * tpf
    fwd_rows, grad_rows = {}, {}
    gen = torch.Generator(device=dev).manual_seed(14)
    for window in (None, W):
        name = f"L{L}_tpf{tpf}_packed_{mask_name(window)}"
        fwd_rows[name] = fwd_case(dev, gen, name, L, tpf, True, window, doc,
                                  1)
        grad_rows.update(grad_case(dev, gen, name, "frame", L, tpf, True,
                                   window, doc, None, 1))

    # the full window: out, dq, dk, dv at every head against the plain
    # version taken a chunk of queries at a time, and the packed output
    # against K1 run on each document's span alone
    frames = cfg.n_frames
    full = PackedSequenceDataset(table, frames)
    full.set_epoch(0)
    item = next(full[i] for i in range(len(full))
                if len(set(full[i]["doc_id"].tolist())) > 1)
    doc = torch.from_numpy(item["doc_id"])[None].to(dev)
    spans = doc_spans(doc[0])
    L = frames * tpf
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    full_rows = {}
    for window in (None, W):
        name = f"L{L}_tpf{tpf}_packed_{mask_name(window)}"
        print(f"[packed] {name}: {len(spans)} document spans {spans}; the "
              f"plain version and SDPA (the library yardstick, the sum of "
              f"its calls) run {FULL_CHECK_QUERIES} queries at a time with "
              f"the same mask", flush=True)
        parts = query_chunks(L, tpf, window, doc, FULL_CHECK_QUERIES)
        plain, sdpa = query_chunked_plain(parts), query_chunked_sdpa(parts)
        fwd_rows[name] = fwd_case(dev, gen, name, L, tpf, True, window, doc,
                                  1, plain=plain, library=sdpa)
        grad_rows.update(grad_case(dev, gen, name, "frame", L, tpf, True,
                                   window, doc, None, 1, plain=plain,
                                   library=sdpa))
        del plain, sdpa, parts
        torch.cuda.empty_cache()
        q, k, v = (torch.randn(1, H, L, Dh, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        with torch.no_grad():
            out = splash.splash_attention(q, k, v, tpf, window, True, doc)
            worst = 0.0
            for f0, f1 in spans:
                a, b = f0 * tpf, f1 * tpf
                alone = splash.splash_attention(
                    *(t[:, :, a:b].contiguous() for t in (q, k, v)), tpf,
                    window, True, None)
                worst = max(worst, (out[:, :, a:b].float()
                                    - alone.float()).abs().max().item())
        full_rows[name] = dict(max_abs_err_vs_spans=worst, spans=len(spans),
                               checked_heads=H)
        print(f"[packed] frame_attention_fwd {name}: packed vs each span "
              f"alone max|d|={worst:.3e}", flush=True)
        if not torch.isfinite(out).all() or worst > KERNEL_MAX_ABS:
            fail(f"packed {name}: K1 with documents disagrees with K1 on "
                 f"each span (max {worst:.3e} > {KERNEL_MAX_ABS})")
        del q, k, v, out, alone
        torch.cuda.empty_cache()

    return fwd_rows, grad_rows, dict(full_window=full_rows,
                                     gather=gather_phase(table))


def gather_phase(table: str):
    """The native gather against its plain version on the phase's table:
    byte-equal, and both timed on the same warm page cache, alternating
    which goes first (GATHER_CASES)."""
    import numpy as np
    from owl_audio_exps_tpu_torch.data import native_loader
    from owl_audio_exps_tpu_torch.data.cod_latent import WindowedViewDataset

    t0 = time.perf_counter()
    native_loader.load_library()
    build_s = time.perf_counter() - t0
    gather = dict(build_s=build_s)
    for frames, n in GATHER_CASES:
        wds = WindowedViewDataset(table, frames)
        if len(wds) < n:
            fail(f"packed: {len(wds)} windows of {frames} frames < {n}")
        idxs = np.random.default_rng(PACKED_SEED).choice(len(wds), n,
                                                         replace=False)
        got = {impl: wds.batch(idxs, impl=impl)
               for impl in ("native", "plain")}
        same = all(got["native"][c].tobytes() == got["plain"][c].tobytes()
                   for c in got["plain"])
        times = {"native": [], "plain": []}
        for r in range(GATHER_REPS):
            for impl in (("native", "plain") if r % 2 == 0
                         else ("plain", "native")):
                t0 = time.perf_counter()
                wds.batch(idxs, impl=impl)
                times[impl].append(1e3 * (time.perf_counter() - t0))
        mib = sum(a.nbytes for a in got["plain"].values()) / 2 ** 20
        med = {impl: statistics.median(t) for impl, t in times.items()}
        gather[f"{frames}x{n}"] = dict(
            native_ms=med["native"], plain_ms=med["plain"], mib=mib,
            native_ms_all=times["native"], plain_ms_all=times["plain"])
        print(f"[packed] gather of {n} windows of {frames} frames "
              f"({mib:.1f} MiB, columns {sorted(got['plain'])}), warm page "
              f"cache, {GATHER_REPS} reps alternating: native median "
              f"{med['native']:.2f} ms (min {min(times['native']):.2f}), "
              f"plain median {med['plain']:.2f} ms (min "
              f"{min(times['plain']):.2f}), plain / native "
              f"{med['plain'] / med['native']:.2f}; byte-equal {same}",
              flush=True)
        if not same:
            fail("packed: the native gather differs from its plain version")
    print(f"[packed] g++ build of csrc/owl_loader.cpp {build_s:.2f} s",
          flush=True)
    return gather


def meanflow_phase(dev):
    """(c) game_mft_audio under the av trainer at the width of
    configs/av_v5_8x8_weak.yml, below K1's threshold: exact 0 port-kernel
    launches, s/step, peak memory, the loss and its parts, the
    parameters moved; then one forward of the objective at 16 frames,
    where the jvp reaches K1, which refuses it as the reference's
    custom_vjp does."""
    import gc
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.nn.attn import use_splash_path
    from owl_audio_exps_tpu_torch.train import port_cuts
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import AVRFTTrainer

    name = "av_v5_8x8_weak.yml"
    conf = Config.from_yaml(os.path.join(ROOT, "configs", name))
    mc, tc = conf.model, conf.train
    for node, key, value, why in (
            (mc, "model_id", "game_mft_audio",
             "the MeanFlow objective under the av trainer, as the "
             "reference's only on-chip MeanFlow run"),
            (tc.data_kwargs, "window_length", MFT_FRAMES,
             "975 tokens, below K1's 1,024 threshold"),
            (tc, "batch_size", MFT_BATCH, "the dense f32 logits of 24 "
             "layers, with the autograd graph of the jvp's tangents, do not "
             "fit one card at 4"),
            (tc, "target_batch_size", MFT_BATCH, "accumulation 1"),
            (tc, "sample_interval", MFT_STEPS + 1, "past the run")):
        print_cut("mft", name, node, key, value, why)
    for line in port_cuts(conf, 1):
        print(f"[mft] cut from configs/{name}: {line}", flush=True)
    L = MFT_FRAMES * mc.tokens_per_frame
    if use_splash_path(mc, L, dev):
        fail(f"mft: L {L} would take K1")

    watched = ("core.r_embed.mlp.fc1.weight",
               "core.transformer.blocks.0.attn.qkv.weight",
               "core.audio_proj_out.proj.weight")

    class MFTTrainer(counted_trainer(AVRFTTrainer)):
        start = None

        def init_state(self, *a, **kw):
            state = super().init_state(*a, **kw)
            named = dict(state.model.named_parameters())
            self.start = {n: named[n].detach().clone() for n in watched}
            return state

    torch.cuda.reset_peak_memory_stats()
    trainer = MFTTrainer(conf, device=dev)
    t0 = time.perf_counter()
    state = trainer.train(max_steps=MFT_STEPS)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    named = dict(state.model.named_parameters())
    moved = {n: (named[n] - trainer.start[n]).abs().max().item()
             for n in watched}
    zero = dict.fromkeys(kernel_counts(), 0)
    print(f"[mft] {type(state.model).__name__} under AVRFTTrainer, "
          f"{mc.n_layers} layers x d {mc.d_model}, tpf {mc.tokens_per_frame}"
          f", L = {L}, batch {tc.batch_size}, opt {tc.opt}: {MFT_STEPS} "
          f"steps in {wall:.1f} s", flush=True)
    for i, st in enumerate(trainer.steps):
        m = st["metrics"]
        print(f"[mft]   step {i + 1}: {st['s']:.3f} s loss {st['loss']:.5f} "
              f"(video {m['video_loss']:.5f}, audio {m['audio_loss']:.5f}) "
              f"launches {st['counts']}", flush=True)
        if not all(math.isfinite(m[k]) for k in ("diffusion_loss",
                                                 "video_loss",
                                                 "audio_loss")):
            fail(f"mft step {i + 1}: a loss is not finite")
        if st["counts"] != zero:
            fail(f"mft step {i + 1}: a port kernel launched")
    timed = [st["s"] for st in trainer.steps[1:]]
    step_s = statistics.median(timed)
    print(f"[mft] s/step median {step_s:.4f} (steps 2-{MFT_STEPS}), "
          f"{L * tc.batch_size / step_s:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GiB; max |param change| {moved}", flush=True)
    if not all(0 < d < math.inf for d in moved.values()):
        fail(f"mft: parameters did not move (or went non-finite): {moved}")

    # the objective at 16 frames: the jvp meets K1's autograd Function
    vid, audio, mouse, btn = (
        torch.from_numpy(a).to(dev) for a in next(iter(get_loader(
            "synthetic_av", 1, window_length=MFT_K1_FRAMES,
            channels=mc.channels, audio_channels=mc.audio_channels,
            sample_size=mc.sample_size, n_buttons=mc.n_buttons))))
    L16 = MFT_K1_FRAMES * mc.tokens_per_frame
    reset_counts()
    try:
        state.model(vid.to(torch.bfloat16), audio.to(torch.bfloat16), mouse,
                    btn, generator=torch.Generator(device=dev).manual_seed(5))
        raised = None
    except RuntimeError as e:
        raised = str(e)
    counts = {k: n for k, n in kernel_counts().items() if n}
    print(f"[mft] the objective at {MFT_K1_FRAMES} frames (L = {L16}, "
          f"K1 route {use_splash_path(mc, L16, dev)}): K1 launches before "
          f"the jvp {counts} (the two instant-velocity forwards, no "
          f"gradient); the jvp raised: {raised!r}", flush=True)
    if raised is None or "torch.func transform" not in raised:
        fail("mft: the jvp through K1 did not raise as documented (the "
             "port's kernels have no forward-mode rule, like the "
             "reference's custom_vjp)")
    reset_counts()
    out = dict(L=L, batch=tc.batch_size, step_s=step_s, peak_gib=peak_gb,
               losses=[st["metrics"] for st in trainer.steps],
               param_change=moved, port_kernel_launches=0,
               k1_frames_raises=raised.split("\n")[0])
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def packed_phase(dev):
    """Phase 14: configs/dit_v4.yml trained from a packed table the phase
    writes, K1 with the loader's documents, and MeanFlow at av_v5 width."""
    import shutil
    from owl_audio_exps_tpu_torch.configs import Config

    shutil.rmtree(PACKED_DIR, ignore_errors=True)
    table = os.path.join(PACKED_DIR, "table")
    cfg = Config.from_yaml(os.path.join(ROOT, "configs", "dit_v4.yml")).model
    t0 = time.perf_counter()
    lens = write_packed_table(table, cfg)
    print(f"[packed] wrote {len(lens)} documents of {min(lens)}-{max(lens)} "
          f"frames ({sum(lens)} frames, float16 {cfg.channels} x "
          f"{cfg.sample_size} x {cfg.sample_size} latents) in "
          f"{time.perf_counter() - t0:.1f} s to "
          f"{os.path.relpath(table, ROOT)}", flush=True)
    reset_counts()
    train = packed_train_phase(dev, table)
    fwd_rows, grad_rows, kernels = packed_kernel_phase(dev, table, cfg)
    reset_counts()
    mft = meanflow_phase(dev)
    shutil.rmtree(PACKED_DIR, ignore_errors=True)
    print(f"[packed] still allocated after the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    return dict(train=train, kernels=kernels, meanflow=mft,
                fwd_rows=fwd_rows, grad_rows=grad_rows)


# --------------------------------------------------------------- phase 15
MMDIT_DIR = os.path.join(ROOT, "build", "chip_smoke_mmdit")
# the cod AV table: seeded documents of 1,000-1,400 frames, so that each
# holds one 1,000-frame window of configs/mmdit_v2.yml (non-overlapping
# windows inside a document); video float16 128 x 8 x 8, audio 64, mouse
# 2, buttons 11
MMDIT_DOCS, MMDIT_DOC_FRAMES, MMDIT_SEED = 6, (1000, 1400), 15
MMDIT_STEPS = 3
# K1 at mmdit_v2's geometry (L 65,000, tpf 65): the plain version and the
# SDPA yardstick take 63 whole frames of queries (4,095) at a time
MMDIT_CHECK_QUERIES = 63 * 65
MMDIT_KERNEL_FRAMES = 1000
# mmdit_v1's trainer: the written batch, then these cuts where it does
# not fit (after turning on remat)
V1_BATCH_CUTS = (16, 8)
V1_STEPS = 3
# mmdit_v2's cached serve: the context primed, the ticks (num_frames 900
# cut), the ring, and graph against eager over the first ticks
SERVE_CTX, SERVE_TICKS_V2, SERVE_RING, SERVE_COMPARE = 8, 24, 32, 6
# the UViT and the knob checks: 4 layers at full width
KNOB_LAYERS, UVIT_FRAMES, KNOB_FRAMES = 4, 32, 64


def write_cod_table(path: str, cfg):
    """The phase's cod AV table, written with the port's NpyTable from
    MMDIT_SEED; returns the document lengths."""
    import numpy as np
    from owl_audio_exps_tpu_torch.data.npy_table import NpyTable

    rng = np.random.default_rng(MMDIT_SEED)
    lens = rng.integers(MMDIT_DOC_FRAMES[0], MMDIT_DOC_FRAMES[1] + 1,
                        MMDIT_DOCS)
    table = NpyTable(path, columns=[
        "video", "audio", "mouse", "buttons", "tarball", "pt_idx",
        "missing", "truncated", "seq_len"],
        array_columns=["video", "audio", "mouse", "buttons"])
    p = cfg.sample_size
    for i, n in enumerate(lens):
        n = int(n)
        table.append(
            video=rng.standard_normal((n, cfg.channels, p, p),
                                      dtype=np.float32).astype(np.float16),
            audio=rng.standard_normal((n, cfg.audio_channels),
                                      dtype=np.float32),
            mouse=rng.standard_normal((n, 2), dtype=np.float32),
            buttons=(rng.random((n, cfg.n_buttons)) > 0.5).astype(
                np.float32),
            tarball=f"doc{i}", pt_idx=i, missing=False, truncated=False,
            seq_len=n)
    return [int(n) for n in lens]


def mmdit_v2_config(table: str, remat: bool = True, tag: str = "mmdit"):
    """configs/mmdit_v2.yml with the phase's cuts, each printed; block
    remat unless ``remat`` is false."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.train import port_cuts

    conf = Config.from_yaml(os.path.join(ROOT, "configs", "mmdit_v2.yml"))
    mc, tc = conf.model, conf.train
    order = ["video", "audio", "mouse", "buttons"]
    why_cols = ("the AV trainer reads [video, audio, mouse, buttons]; as "
                "written the cod loader hands it mouse as audio, and both "
                "packages fail (ROADMAP.md Queue 3)")
    cuts = [(tc.data_kwargs, "dataset_path", table, "the phase's table"),
            (tc.data_kwargs, "batch_columns", order, why_cols),
            (tc.sample_data_kwargs, "dataset_path", table,
             "the phase's table; the eval never samples in this run"),
            (tc.sample_data_kwargs, "batch_columns", order, why_cols),
            (tc, "target_batch_size", tc.batch_size,
             "accumulation 8 -> 1"),
            (tc, "checkpoint_dir", os.path.join(MMDIT_DIR, "ckpt"),
             "under build/; save_interval 10,000 is past the run")]
    if remat:
        cuts.append((mc, "gradient_checkpointing", True,
                     "without it one step runs out of the card's memory at "
                     "the written 1,000-frame window (python3 chip_smoke.py "
                     "--mmdit-fit); block remat is the JAX MMDiT's own "
                     "(nn/mmattn.py:160-162) and changes no value"))
    for node, key, value, why in cuts:
        print_cut(tag, "mmdit_v2.yml", node, key, value, why)
    for line in port_cuts(conf, 1):
        print(f"[{tag}] cut from configs/mmdit_v2.yml: {line}", flush=True)
    return conf


def mmdit_fit_phase(dev):
    """``python3 chip_smoke.py --mmdit-fit``: configs/mmdit_v2.yml from the
    phase's cod table without remat, as written (a 1,000-frame window, L
    65,000), one step: its time and peak memory, or the CUDA
    out-of-memory error it raised. This is why phase 15 trains it with
    block remat."""
    import shutil
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import AVRFTTrainer

    shutil.rmtree(MMDIT_DIR, ignore_errors=True)
    table = os.path.join(MMDIT_DIR, "table")
    write_cod_table(table, Config.from_yaml(
        os.path.join(ROOT, "configs", "mmdit_v2.yml")).model)
    conf = mmdit_v2_config(table, remat=False, tag="fit")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = counted_trainer(AVRFTTrainer)(conf, device=dev)
    try:
        trainer.train(max_steps=1)
        res = dict(fits=True, step_s=trainer.steps[-1]["s"])
    except torch.OutOfMemoryError as e:
        res = dict(fits=False, error=str(e).splitlines()[0])
    L = conf.train.data_kwargs.window_length * conf.model.tokens_per_frame
    res.update(L=L, steps_done=len(trainer.steps),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    trainer = None
    print(f"[fit] mmdit_v2.yml without remat (L = {L}): " + (
        f"fits, step 1 {res['step_s']:.3f} s" if res["fits"] else
        f"out of memory after {res['steps_done']} steps: {res['error']}")
        + f"; peak allocated {res['peak_gib']:.2f} GiB", flush=True)
    shutil.rmtree(MMDIT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def per_block_launches(cfg):
    """K1's launches per training step where every layer takes K1."""
    from owl_audio_exps_tpu_torch.nn.attn import attention_forwards_per_step
    expect = dict.fromkeys(kernel_counts(), 0)
    expect.update(frame_attention_fwd=sum(attention_forwards_per_step(cfg)),
                  frame_attention_bwd_dq=cfg.n_layers,
                  frame_attention_bwd_dkv=cfg.n_layers)
    return expect


def check_steps(tag, trainer, expect):
    for i, st in enumerate(trainer.steps):
        print(f"[{tag}]   step {i + 1}: {st['s']:.3f} s loss "
              f"{st['loss']:.5f} launches "
              f"{ {k: n for k, n in st['counts'].items() if n} }",
              flush=True)
        if not math.isfinite(st["loss"]):
            fail(f"{tag} step {i + 1}: loss not finite")
        if st["counts"] != expect:
            fail(f"{tag} step {i + 1}: kernel launches {st['counts']}, "
                 f"expected {expect}")


def check_k1_routes(tag, cfg, L):
    from owl_audio_exps_tpu_torch.nn.attn import (attention_route,
                                                  local_layer_flags)
    routes = {attention_route(cfg, local, L)
              for local in set(local_layer_flags(cfg))}
    if routes != {("splash", None)}:
        fail(f"{tag}: a layer does not route to K1 at L {L}: {routes}")
    return routes


def mmdit_v2_train_phase(dev, table: str):
    """(1) AVRFTTrainer on configs/mmdit_v2.yml from the cod table at the
    written 1,000-frame window (L 65,000), block remat: exact K1 launches
    per step (no band: the local span 1,040 does not divide 65,000),
    s/step, tokens/s, MFU, peak memory, the loader's share, one traced
    step."""
    from owl_audio_exps_tpu_torch.trainers import base as trainer_base
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import AVRFTTrainer
    from owl_audio_exps_tpu_torch.utils.mfu import (H100_PEAK_TFLOPS,
                                                    training_flops_per_token)

    conf = mmdit_v2_config(table)
    cfg, tc = conf.model, conf.train
    L = tc.data_kwargs.window_length * cfg.tokens_per_frame
    routes = check_k1_routes("mmdit_v2", cfg, L)
    expect = per_block_launches(cfg)
    loads = []
    real_get_loader = trainer_base.get_loader

    def timed_get_loader(*a, **kw):
        loader = TimedIter(iter(real_get_loader(*a, **kw)))
        loads.append(loader)
        return loader

    class MMDiTTrainer(counted_trainer(AVRFTTrainer)):
        waits = None

        def data_stream(self, *a, **kw):
            stream = TimedIter(super().data_stream(*a, **kw))
            self.waits = self.waits or stream
            return stream

    trainer_base.get_loader = timed_get_loader
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer = MMDiTTrainer(conf, device=dev)
        t0 = time.perf_counter()
        state = trainer.train(max_steps=MMDIT_STEPS)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        batch = next(trainer.data_stream(tc.data_id, tc.batch_size,
                                         tc.data_kwargs))
    finally:
        trainer_base.get_loader = real_get_loader
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[mmdit] AVRFTTrainer configs/mmdit_v2.yml: MMDiT {cfg.n_layers} "
          f"layers x d {cfg.d_model}, {n_params / 1e6:.1f} M params fp32 "
          f"(two streams; each token passes one), data {tc.data_id} window "
          f"{tc.data_kwargs.window_length} frames (L = {L}: "
          f"{L - tc.data_kwargs.window_length} video + "
          f"{tc.data_kwargs.window_length} audio tokens), batch "
          f"{tc.batch_size}, opt {tc.opt}, block remat: {MMDIT_STEPS} steps "
          f"in {wall:.1f} s; routes {sorted(routes)}; expected launches per "
          f"step { {k: n for k, n in expect.items() if n} }", flush=True)
    check_steps("mmdit", trainer, expect)
    if tuple(batch[1].shape) != (1, tc.data_kwargs.window_length,
                                 cfg.audio_channels):
        fail(f"mmdit: the audio batch has shape {tuple(batch[1].shape)}")
    timed = [st["s"] for st in trainer.steps[1:]]
    step_s = statistics.median(timed)
    tokens = L * tc.batch_size * trainer.accum_steps()
    mfu = training_flops_per_token(cfg, L) * tokens / step_s / \
        (H100_PEAK_TFLOPS * 1e12)
    load_s = loads[0].times
    waits = trainer.waits.times
    wait_share = sum(waits[1:]) / (sum(waits[1:]) + sum(timed))
    print(f"[mmdit] s/step median {step_s:.4f} (steps 2-{MMDIT_STEPS}, "
          f"min {min(timed):.4f} max {max(timed):.4f}), "
          f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of "
          f"{H100_PEAK_TFLOPS:.0f} TFLOP/s (utils/mfu.py: each token through "
          f"one stream's weights; the formula's window FLOPs), peak memory "
          f"{peak_gb:.2f} GiB (max_memory_allocated)", flush=True)
    print(f"[mmdit] loader: {len(load_s)} batches read, "
          f"{1e3 * statistics.median(load_s):.1f} ms a batch (median); the "
          f"trainer waited on the prefetch queue {1e3 * waits[0]:.1f} ms "
          f"before step 1 and {[round(1e3 * w, 2) for w in waits[1:]]} ms "
          f"before steps 2-{MMDIT_STEPS}: {100 * wait_share:.2f}% of those "
          f"steps", flush=True)
    gen = torch.Generator(device=dev).manual_seed(99)
    breakdown = profile_step(trainer, state, [batch], gen, step_s,
                             tag="mmdit")
    out = dict(window_frames=tc.data_kwargs.window_length, L=L,
               params=n_params, step_s=step_s, tokens_per_s=tokens / step_s,
               mfu=mfu, peak_gib=peak_gb,
               losses=[st["loss"] for st in trainer.steps],
               loader_ms_per_batch=1e3 * statistics.median(load_s),
               prefetch_wait_share=wait_share, device_ms=breakdown,
               per_step=expect,
               totals={k: sum(st["counts"][k] for st in trainer.steps)
                       for k in expect})
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mmdit_kernel_phase(dev):
    """(2) K1 at mmdit_v2's geometry, L 65,000, tpf 65, causal, windows
    16 and 256 frames: forward, dq and dkv at all 24 heads against the
    plain version taken MMDIT_CHECK_QUERIES queries at a time, with its
    bound and the SDPA yardstick on the same chunks."""
    fwd_rows, grad_rows = {}, {}
    gen = torch.Generator(device=dev).manual_seed(15)
    L, tpf = MMDIT_KERNEL_FRAMES * 65, 65
    for window in (16, 256):
        name = f"L{L}_tpf{tpf}_causal_w{window}"
        print(f"[mmdit] {name}: the plain version and SDPA (the sum of its "
              f"calls) run {MMDIT_CHECK_QUERIES} queries at a time with the "
              f"same mask", flush=True)
        parts = query_chunks(L, tpf, window, None, MMDIT_CHECK_QUERIES, dev)
        plain, sdpa = query_chunked_plain(parts), query_chunked_sdpa(parts)
        fwd_rows[name] = fwd_case(dev, gen, name, L, tpf, True, window, None,
                                  1, plain=plain, library=sdpa)
        grad_rows.update(grad_case(dev, gen, name, "frame", L, tpf, True,
                                   window, None, None, 1, plain=plain,
                                   library=sdpa))
        del plain, sdpa, parts
        torch.cuda.empty_cache()
    return fwd_rows, grad_rows


def av_window(cfg, W, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf, p = torch.bfloat16, cfg.sample_size
    return (torch.randn(1, W, cfg.channels, p, p, generator=gen,
                        device=dev).to(bf),
            torch.randn(1, W, cfg.audio_channels, generator=gen,
                        device=dev).to(bf),
            torch.randn(1, W, 2, generator=gen, device=dev).to(bf),
            (torch.rand(1, W, cfg.n_buttons, generator=gen, device=dev)
             > 0.5).to(bf), gen)


def mmdit_v1_phase(dev):
    """(3) configs/mmdit_v1.yml: its av_causal sampler with the config's
    kwargs on a seeded core (cached forwards: no port kernel), one
    uncached forward of its window through K1 against the dense route,
    then AVRFTTrainer on synthetic_av at the written batch 32 (remat, then
    the batch, cut where it does not fit; each cut printed)."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
    from owl_audio_exps_tpu_torch.train import port_cuts
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import AVRFTTrainer
    from owl_audio_exps_tpu_torch.utils.mfu import (H100_PEAK_TFLOPS,
                                                    training_flops_per_token)

    conf = Config.from_yaml(os.path.join(ROOT, "configs", "mmdit_v1.yml"))
    cfg, tc = conf.model, conf.train
    kw = tc.sampler_kwargs.to_dict()
    core = make_core(cfg, dev, seed=16)
    sampler = get_sampler_cls(tc.sampler_id)(**kw)
    W = sampler.window_length
    L = W * cfg.tokens_per_frame
    x, a, m, b, gen = av_window(cfg, W, dev, 51)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, x_out, a_out, _, _ = sampler(core, x, a, m, b, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_no_port_kernels("the av_causal sampler over the MMDiT")
    n_out = W + kw["num_frames"]
    if tuple(x_out.shape) != (1, n_out, cfg.channels, 8, 8) or \
            tuple(a_out.shape) != (1, n_out, cfg.audio_channels) or \
            not (torch.isfinite(x_out).all() and torch.isfinite(a_out).all()):
        fail(f"av_causal over the MMDiT: output {tuple(x_out.shape)} "
             f"{tuple(a_out.shape)} or not finite")
    print(f"[mmdit_v1] {tc.sampler_id} with the config's kwargs {kw} over "
          f"the MMDiT ({cfg.n_layers} layers x d {cfg.d_model}, seeded bf16): "
          f"{kw['num_frames']} frames in {secs:.2f} s, "
          f"{1e3 * secs / kw['num_frames']:.1f} ms a frame; 0 port-kernel "
          f"launches (step 0 writes the window into a fresh ring and every "
          f"forward is cached: dense attention over the ring, as in the JAX "
          f"package)", flush=True)

    # the window's uncached forward: K1 on every layer, against dense
    wt = torch.full((1, W), sampler.noise_prev, dtype=torch.bfloat16,
                    device=dev)
    wt[:, -1] = 1.0
    check_k1_routes("mmdit_v1", cfg, L)
    reset_counts()
    with torch.no_grad():
        kv, ka = core(x, a, wt, m, b)
        k1 = splash_count()
        cfg.attn_impl = "dense"
        dv, da = core(x, a, wt, m, b)
        cfg.attn_impl = "auto"
    if k1 != cfg.n_layers or splash_count() != k1:
        fail(f"mmdit_v1: the window's forward launched K1 {k1} times, "
             f"expected {cfg.n_layers}")
    errs = dict(video=rel_l2(kv, dv), audio=rel_l2(ka, da))
    print(f"[mmdit_v1] the window's uncached forward (L {L}): K1 {k1} "
          f"launches (one a layer) against the dense route: rel L2 "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance "
          f"{FORWARD_REL_L2})", flush=True)
    if not all(e <= FORWARD_REL_L2 for e in errs.values()):
        fail("mmdit_v1: the K1 forward disagrees with the dense route")
    del core, sampler
    gc.collect()
    torch.cuda.empty_cache()

    # the trainer at the written batch, cut only where it does not fit
    for line in port_cuts(conf, 1):
        print(f"[mmdit_v1] cut from configs/mmdit_v1.yml: {line}",
              flush=True)
    print_cut("mmdit_v1", "mmdit_v1.yml", tc, "target_batch_size",
              tc.batch_size, "accumulation 8 -> 1")
    print_cut("mmdit_v1", "mmdit_v1.yml", tc, "checkpoint_dir",
              os.path.join(MMDIT_DIR, "ckpt_v1"),
              "under build/; save_interval 1,000 is past the run")
    tries = [(False, tc.batch_size), (True, tc.batch_size)] + \
        [(True, bs) for bs in V1_BATCH_CUTS]
    trainer = None
    for remat, bs in tries:
        if remat and not cfg.get("gradient_checkpointing"):
            print_cut("mmdit_v1", "mmdit_v1.yml", cfg,
                      "gradient_checkpointing", True,
                      "the written batch does not fit without it; block "
                      "remat changes no value")
        if bs != tc.batch_size:
            print_cut("mmdit_v1", "mmdit_v1.yml", tc, "batch_size", bs,
                      "it does not fit with remat")
            print_cut("mmdit_v1", "mmdit_v1.yml", tc, "target_batch_size",
                      bs, "accumulation 1")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = counted_trainer(AVRFTTrainer)(conf, device=dev)
        try:
            state = trainer.train(max_steps=V1_STEPS)
            break
        except torch.OutOfMemoryError as e:
            print(f"[mmdit_v1] remat {remat}, batch {bs}: out of memory "
                  f"after {len(trainer.steps)} steps: "
                  f"{str(e).splitlines()[0][:160]}", flush=True)
            trainer = None
    else:
        fail("mmdit_v1: no batch fits")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = per_block_launches(cfg)
    check_steps("mmdit_v1", trainer, expect)
    timed = [st["s"] for st in trainer.steps[1:]]
    step_s = statistics.median(timed)
    tokens = L * tc.batch_size
    mfu = training_flops_per_token(cfg, L) * tokens / step_s / \
        (H100_PEAK_TFLOPS * 1e12)
    print(f"[mmdit_v1] AVRFTTrainer {cfg.n_layers} layers x d {cfg.d_model}, "
          f"L {L}, batch {tc.batch_size}, opt {tc.opt}, remat "
          f"{bool(cfg.get('gradient_checkpointing'))}: s/step median "
          f"{step_s:.4f} (steps 2-{V1_STEPS}), {tokens / step_s:.0f} "
          f"tokens/s, MFU {100 * mfu:.2f}%, peak memory {peak_gb:.2f} GiB",
          flush=True)
    out = dict(sampler_ms_per_frame=1e3 * secs / kw["num_frames"],
               sampler_frames=kw["num_frames"], forward_vs_dense=errs,
               forward_k1_launches=k1, batch=tc.batch_size,
               remat=bool(cfg.get("gradient_checkpointing")), L=L,
               step_s=step_s, tokens_per_s=tokens / step_s, mfu=mfu,
               peak_gib=peak_gb, per_step=expect,
               totals={k: sum(st["counts"][k] for st in trainer.steps)
                       for k in expect})
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def splash_count() -> int:
    return kernel_counts()["frame_attention_fwd"]


def mmdit_v2_serve_phase(dev):
    """(4) configs/mmdit_v2.yml's cached serve on a seeded MMDiT core: the
    config's av_caching sampler refuses an AV core (as the JAX package's
    fails on one), so the cached AV serve runs through
    AVCachedStreamingPipeline with the sampler's settings (16 steps,
    noise_prev 0.2, fused write), graphed against eager, ms a frame; no
    port kernel (cached attention is dense over the ring)."""
    import numpy as np
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.sampling import get_sampler_cls

    conf = Config.from_yaml(os.path.join(ROOT, "configs", "mmdit_v2.yml"))
    cfg, tc = conf.model, conf.train
    kw = tc.sampler_kwargs.to_dict()
    core = make_core(cfg, dev, seed=17)
    x, a, m, b, gen = av_window(cfg, SERVE_CTX, dev, 52)
    try:
        get_sampler_cls(tc.sampler_id)(**kw)(core, x, m, b)
        fail("av_caching accepted an AV core")
    except TypeError as e:
        print(f"[serve15] {tc.sampler_id} on the MMDiT core raises, as the "
              f"JAX package's sampler fails on an AV core: {e}", flush=True)
    print(f"[serve15] AVCachedStreamingPipeline over the MMDiT "
          f"({cfg.n_layers} layers x d {cfg.d_model}, tpf "
          f"{cfg.tokens_per_frame}, local window {cfg.local_window}, global "
          f"{cfg.global_window}) with the sampler's n_steps {kw['n_steps']}, "
          f"noise_prev {kw['noise_prev']}, cfg_scale {kw['cfg_scale']}; cut: "
          f"num_frames {kw['num_frames']} -> {SERVE_TICKS_V2} ticks after "
          f"{SERVE_CTX} context frames, a {SERVE_RING}-frame ring, for time",
          flush=True)
    rs = np.random.RandomState(15)

    def pipe_of(graphed):
        pipe = AVCachedStreamingPipeline(
            core, cfg, window_frames=SERVE_RING, sampling_steps=kw["n_steps"],
            noise_prev=kw["noise_prev"], seed=19, fused_write=True,
            device=dev, graphed=graphed)
        pipe.prime(x, a, m, b)
        return pipe

    def controls():
        return (rs.randn(2).astype(np.float32),
                (rs.rand(cfg.n_buttons) > 0.5).astype(np.float32))

    reset_counts()
    graphed, eager = pipe_of(True), pipe_of(False)
    d, same = 0.0, True
    for _ in range(SERVE_COMPARE):
        ctrl = controls()
        (fg, ag, _), (fe, ae, _) = graphed(*ctrl), eager(*ctrl)
        d = max(d, max_abs(fg, fe), max_abs(ag, ae))
        same = same and torch.equal(fg, fe) and torch.equal(ag, ae)
    if not graphed.loop.graphs:
        fail("mmdit_v2 serve: no CUDA graph was captured")
    if d > CACHED_GRAPH_MAX_ABS:
        fail(f"mmdit_v2 serve: graphed tick disagrees with eager ({d:.3e})")
    ms = []
    for _ in range(SERVE_TICKS_V2 - SERVE_COMPARE):
        frame, audio, s = graphed(*controls())
        if not (torch.isfinite(frame.float()).all()
                and torch.isfinite(audio.float()).all()):
            fail("mmdit_v2 serve: a tick is not finite")
        ms.append(1e3 * s)
    e_ms = [1e3 * eager(*controls())[2] for _ in range(4)]
    check_no_port_kernels("the MMDiT's cached serve")
    tpf = cfg.tokens_per_frame
    print(f"[serve15] graph vs eager over {SERVE_COMPARE} ticks identical "
          f"{same}, max |diff| {d:.3e} (tolerance {CACHED_GRAPH_MAX_ABS}); "
          f"ms a frame median graphed {statistics.median(ms):.2f} (min "
          f"{min(ms):.2f} max {max(ms):.2f}), eager "
          f"{statistics.median(e_ms):.2f}; ring after {SERVE_TICKS_V2} ticks: "
          f"{int(graphed.cache.length) // tpf} frames of {SERVE_RING}, RoPE "
          f"offset {int(graphed.cache.rope_offset) // tpf} frames (the MMDiT "
          f"commits both frames of each fused forward, as the JAX package's "
          f"does); 0 port-kernel launches", flush=True)
    out = dict(ticks=SERVE_TICKS_V2, graph_identical=same, graph_max_abs=d,
               ms_per_frame=dict(graphed=statistics.median(ms),
                                 eager=statistics.median(e_ms)),
               rope_offset_frames=int(graphed.cache.rope_offset) // tpf,
               port_kernel_launches=0)
    del graphed, eager, core
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_grads(model, batch, gen_seed):
    """(loss, {name: f32 grad}) of one training step of ``model``."""
    gen = torch.Generator(device=batch[0].device).manual_seed(gen_seed)
    loss = model(*batch, generator=gen)
    loss = loss[0] if isinstance(loss, tuple) else loss
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in
                         model.named_parameters()}


def compare_steps(tag, a, b):
    """Phase 6's 4-layer step limits on two (loss, grads) results."""
    (la, ga), (lb, gb) = a, b
    loss_rel = abs(la - lb) / abs(lb)
    num = sum((ga[n] - gb[n]).pow(2).sum() for n in gb)
    den = sum(gb[n].pow(2).sum() for n in gb)
    total = (num / den).sqrt().item()
    per = {n: rel_l2(ga[n], gb[n]) for n in gb if gb[n].norm() > 0}
    worst = max(per, key=per.get)
    print(f"[knobs] {tag}: loss {la:.6f} vs {lb:.6f} (rel {loss_rel:.2e}, "
          f"tolerance {ROUTE_LOSS_REL}); gradient rel L2 {total:.3e} "
          f"(tolerance {ROUTE_GRAD_REL_L2}), worst {per[worst]:.3e} "
          f"({worst}; tolerance {ROUTE_PARAM_REL_L2})", flush=True)
    if loss_rel > ROUTE_LOSS_REL or total > ROUTE_GRAD_REL_L2 or \
            per[worst] > ROUTE_PARAM_REL_L2:
        fail(f"{tag}: the steps disagree")
    return dict(loss_rel=loss_rel, grad_rel_l2=total, worst_param=per[worst])


def uvit_knob_phase(dev):
    """(5) a GameRFTAudio step with backbone uvit at configs/av_v4_8x8.yml's
    widths, 4 layers (no config uses the UViT), K1 on every block, against
    dense attention; then configs/dit_v4_tpu_e2e.yml's 4-layer step with
    each memory knob against the same step without it."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.data import get_loader
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFT
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudio

    out = {}
    conf = Config.from_yaml(os.path.join(ROOT, "configs", "av_v4_8x8.yml"))
    cfg = conf.model
    print_cut("knobs", "av_v4_8x8.yml", cfg, "backbone", "uvit",
              "no config uses the UViT; the AV model's widths")
    print_cut("knobs", "av_v4_8x8.yml", cfg, "n_layers", KNOB_LAYERS,
              "phase 6's 4-layer step")
    x, a, m, b, _ = av_window(cfg, UVIT_FRAMES, dev, 53)
    batch = (x, a, m, b)
    results = {}
    for impl in ("auto", "dense"):
        c = cfg.copy()
        c.attn_impl = impl
        reset_counts()
        model = GameRFTAudio(c, dtype=torch.bfloat16, device=dev, seed=0)
        results[impl] = step_grads(model, batch, 5)
        counts = {k: n for k, n in kernel_counts().items() if n}
        if impl == "auto":
            uvit_counts = counts
        del model
    want = dict(frame_attention_fwd=KNOB_LAYERS,
                frame_attention_bwd_dq=KNOB_LAYERS,
                frame_attention_bwd_dkv=KNOB_LAYERS)
    if uvit_counts != want:
        fail(f"uvit: kernel launches {uvit_counts}, expected {want}")
    out["uvit"] = dict(compare_steps(
        f"UViT {KNOB_LAYERS} x d {cfg.d_model}, L "
        f"{UVIT_FRAMES * cfg.tokens_per_frame}, kernels {uvit_counts} vs "
        f"dense", results["auto"], results["dense"]), launches=uvit_counts)

    conf = Config.from_yaml(os.path.join(ROOT, "configs",
                                         "dit_v4_tpu_e2e.yml"))
    base = conf.model
    base.n_layers = KNOB_LAYERS
    dk = dict(conf.train.data_kwargs.items(), window_length=KNOB_FRAMES)
    vid, mouse, btn = [torch.from_numpy(t).to(dev) for t in next(iter(
        get_loader(conf.train.data_id, 1, **dk)))]
    batch = (vid.to(torch.bfloat16), mouse, btn)
    knobs = {"remat_sequenced": (dict(gradient_checkpointing=True,
                                      remat_granularity="group"),
                                 dict(remat_sequenced=True)),
             "fused_head_chunks": ({}, dict(splash_head_chunks=2,
                                            fused_head_chunks=True)),
             "mlp_chunks": ({}, dict(mlp_chunks=4))}
    for knob, (common, on) in knobs.items():
        steps = {}
        for tag, over in (("off", common), ("on", dict(common, **on))):
            c = base.copy()
            for k, v in over.items():
                c[k] = v
            reset_counts()
            model = GameRFT(c, dtype=torch.bfloat16, device=dev, seed=0)
            steps[tag] = step_grads(model, batch, 5)
            steps[tag + "_counts"] = {k: n for k, n in
                                      kernel_counts().items() if n}
            del model
        print(f"[knobs] dit_v4 {KNOB_LAYERS} layers, L "
              f"{KNOB_FRAMES * base.tokens_per_frame}, {knob} {on}: "
              f"launches on {steps['on_counts']}, off {steps['off_counts']}",
              flush=True)
        out[knob] = dict(compare_steps(f"{knob} on vs off", steps["on"],
                                       steps["off"]),
                         launches_on=steps["on_counts"],
                         launches_off=steps["off_counts"])
    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mmdit_phase(dev):
    """Phase 15: the MMDiT (mmdit_v2 trained from a cod table the phase
    writes, K1 at its geometry, mmdit_v1's sampler and trainer, mmdit_v2's
    cached serve), the UViT and the memory knobs."""
    import shutil
    from owl_audio_exps_tpu_torch.configs import Config

    t_phase = time.perf_counter()
    shutil.rmtree(MMDIT_DIR, ignore_errors=True)
    table = os.path.join(MMDIT_DIR, "table")
    cfg = Config.from_yaml(os.path.join(ROOT, "configs",
                                        "mmdit_v2.yml")).model
    t0 = time.perf_counter()
    lens = write_cod_table(table, cfg)
    print(f"[mmdit] wrote {len(lens)} documents of {min(lens)}-{max(lens)} "
          f"frames (float16 video {cfg.channels} x {cfg.sample_size} x "
          f"{cfg.sample_size}, audio {cfg.audio_channels}, mouse, buttons) "
          f"in {time.perf_counter() - t0:.1f} s to "
          f"{os.path.relpath(table, ROOT)}", flush=True)
    reset_counts()
    train = mmdit_v2_train_phase(dev, table)
    fwd_rows, grad_rows = mmdit_kernel_phase(dev)
    reset_counts()
    v1 = mmdit_v1_phase(dev)
    reset_counts()
    serve = mmdit_v2_serve_phase(dev)
    knobs = uvit_knob_phase(dev)
    shutil.rmtree(MMDIT_DIR, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    print(f"[mmdit] phase 15 took {secs:.1f} s; still allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    return dict(mmdit_v2_train=train, mmdit_v1=v1, mmdit_v2_serve=serve,
                uvit_knobs=knobs, seconds=secs, fwd_rows=fwd_rows,
                grad_rows=grad_rows)


# ---------------------------------------------------------------- phase 16
SHARD_DIR = os.path.join(ROOT, "build", "chip_smoke_shard")
# (a) the meshes the 5B's parameter tree is split over
SHARD_MESHES = {"fsdp4": dict(fsdp=4), "tensor4": dict(tensor=4),
                "fsdp2_tensor2": dict(fsdp=2, tensor=2)}
# (b), (c): a 256-frame packed window (L 16,384) of a small seeded table
SHARD_FRAMES, SHARD_DOCS, SHARD_DOC_FRAMES = 256, 8, (40, 200)
SHARD_T = 4
SHARD_BLOCKS = (0, 1)         # a global and a local (window 16) layer
# (c) K1 at the per-rank head counts of the 5B's meshes
SHARD_HEADS = (40, 10)
# (b) the split block against the whole one: phase 6's limits
SHARD_OUT_REL, SHARD_GRAD_REL = 5e-2, 3e-2


def mesh_views(sizes):
    """Every rank's Mesh of ``sizes`` ({axis: n}) as one process holds
    them: sizes and indices, no process groups (so the port's collectives
    are identities)."""
    from owl_audio_exps_tpu_torch.parallel.mesh import Mesh, mesh_coords
    shape = dict(dict(data=1, fsdp=1, tensor=1, seq=1), **sizes)
    n = shape["data"] * shape["fsdp"] * shape["tensor"] * shape["seq"]
    return [Mesh(**shape, **{f"{a}_index": i for a, i in
                             mesh_coords(shape, r).items()})
            for r in range(n)]


def shard_round_trip(core, meshes=SHARD_MESHES, tag="shard16"):
    """(a) ``core``'s parameters split by the port's rules (parallel/
    sharding.py) for every rank of each mesh and put together again,
    which must give the tree bit for bit; every rank's shard shapes are
    printed (the blocks alike, so block N stands for each)."""
    import re
    from owl_audio_exps_tpu_torch.parallel.sharding import (mesh_coords_of,
                                                            param_specs)
    out = {}
    for mname, sizes in meshes.items():
        views = mesh_views(sizes)
        specs = param_specs(core, views[0])
        shapes, equal, per_rank = {}, True, 0
        with torch.no_grad():
            for name, p in core.named_parameters():
                spec = specs[name]
                parts = [(mesh_coords_of(v), spec.shard(p, mesh_coords_of(v)))
                         for v in views]
                equal &= torch.equal(spec.assemble(parts), p)
                per_rank += parts[0][1].numel()
                key = re.sub(r"blocks\.\d+\.", "blocks.N.", name)
                shapes.setdefault(key, (spec.axes, [tuple(t.shape)
                                                    for _, t in parts]))
                del parts
        total = sum(p.numel() for p in core.parameters())
        print(f"[{tag}] (a) {mname}: {len(views)} ranks, {per_rank:,} of "
              f"{total:,} parameters a rank; the gathered tree bit-equal to "
              f"the full tree: {equal}", flush=True)
        for key, (axes, rank_shapes) in shapes.items():
            print(f"[{tag}]   {key} {list(axes)}: " + " ".join(
                f"r{r} {tuple(sh)}" for r, sh in enumerate(rank_shapes)),
                flush=True)
        if not equal:
            fail(f"{tag} (a) {mname}: the gathered parameters differ from "
                 "the tree")
        out[mname] = dict(ranks=len(views), params_per_rank=per_rank,
                          params=total, bit_equal=bool(equal))
    return out


def split_block_forward(blocks, x, cond, doc):
    """A DiT block whose rank copies ``blocks`` (rank r's slice kept by
    shard_params on its Mesh view) run in turn in one process: the
    replicated modules are rank 0's, each rank's attention and MLP run on
    its heads and hidden units, and their row-parallel partials are summed
    where the all-reduce would sum them (the other ranks' row-parallel
    biases were taken away, so the bias is added once)."""
    b0 = blocks[0]
    h = b0.adaln1(x, cond)
    attn = sum(blk.attn(h, None, True, doc) for blk in blocks)
    x = x + b0.gate1(attn, cond)
    h = b0.adaln2(x, cond)
    return x + b0.gate2(sum(blk.mlp(h) for blk in blocks), cond)


def split_blocks(block, T: int):
    """T copies of ``block`` sharded for the tensor ranks of {tensor T}."""
    import copy
    from owl_audio_exps_tpu_torch.parallel.sharding import shard_params
    ranks = []
    for r, view in enumerate(mesh_views(dict(tensor=T))):
        blk = shard_params(copy.deepcopy(block), view,
                           n_heads=block.config.n_heads)
        if r:
            blk.attn.out.bias = None
            blk.mlp.fc2.bias = None
        ranks.append(blk)
    return ranks


def split_block_errors(block, T, x, cond, doc, gen):
    """(b) ``block`` split T ways against itself whole, forward and
    backward: relative L2 of the output and of every gradient (each
    rank's slice against the same slice of the whole block's), and the
    K1 launches of the split run."""
    from owl_audio_exps_tpu_torch.parallel.sharding import (mesh_coords_of,
                                                            spec_of)
    ranks = split_blocks(block, T)
    g = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)

    def run(fn, params):
        xs = x.detach().requires_grad_()
        out = fn(xs)
        grads = torch.autograd.grad(out, [xs] + params, g)
        return out.detach().float(), [t.float() for t in grads]

    full_params = list(block.parameters())
    want, want_g = run(lambda t: block(t, cond, None, True, doc),
                       full_params)
    reset_counts()
    named = [(r, n, p) for r, blk in enumerate(ranks)
             for n, p in blk.named_parameters()
             if r == 0 or spec_of(p) is not None]
    got, got_g = run(lambda t: split_block_forward(ranks, t, cond, doc),
                     [p for _, _, p in named])
    counts = kernel_counts()
    full = dict(block.named_parameters())
    views = mesh_views(dict(tensor=T))
    errs = {"out": rel_l2(got, want), "dx": rel_l2(got_g[0], want_g[0])}
    grads = dict(zip([n for n in full], want_g[1:]))
    for (r, name, p), gr in zip(named, got_g[1:]):
        spec = spec_of(p)
        ref = grads[name] if spec is None else \
            spec.shard(grads[name], mesh_coords_of(views[r]))
        errs[f"r{r}.{name}"] = rel_l2(gr, ref)
    del ranks
    return errs, counts


def sharding_phase(dev):
    """Phase 16: the fsdp and tensor axes of configs/dit_v4_5B.yml as far
    as one card holds them (the 4-card run is mesh_smoke.py): (a) the
    full-width parameter tree split and put together again for {fsdp 4},
    {tensor 4} and {fsdp 2, tensor 2}; (b) a global and a local block of
    it split 4 ways over tensor, each rank's slice run in turn, forward
    and backward at L 16,384 with the documents of a packed window,
    against the whole block; (c) K1 at the per-rank head counts (H 40
    under fsdp, 10 at tensor 4) with those documents against its plain
    version at every head."""
    import shutil
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.data.latent_seq_packing import \
        PackedSequenceDataset
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore

    conf = Config.from_yaml(os.path.join(ROOT, "configs", "dit_v4_5B.yml"))
    cfg = conf.model
    out = {}
    t0 = time.perf_counter()
    core = GameRFTCore(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    total = sum(p.numel() for p in core.parameters())
    print(f"[shard16] configs/dit_v4_5B.yml core: {cfg.n_layers} layers x d "
          f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.d_model // cfg.n_heads}"
          f", {total:,} float32 parameters from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["round_trip"] = shard_round_trip(core)
    blocks = [core.transformer.blocks[i] for i in SHARD_BLOCKS]
    del core
    gc.collect()
    torch.cuda.empty_cache()

    # the documents of a packed window of a small seeded table
    os.makedirs(SHARD_DIR, exist_ok=True)
    table = os.path.join(SHARD_DIR, "table")
    shutil.rmtree(table, ignore_errors=True)
    lens = write_packed_table(table, cfg, SHARD_DOCS, SHARD_DOC_FRAMES)
    ds = PackedSequenceDataset(table, SHARD_FRAMES)
    ds.set_epoch(0)
    item = next(ds[i] for i in range(len(ds))
                if len(set(ds[i]["doc_id"].tolist())) > 1)
    doc = torch.from_numpy(item["doc_id"])[None].to(dev)
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    tpf, W = cfg.tokens_per_frame, cfg.local_window
    L = SHARD_FRAMES * tpf
    print(f"[shard16] a {SHARD_FRAMES}-frame window (L {L}) of a seeded "
          f"table of {SHARD_DOCS} documents {lens}: {len(doc_spans(doc[0]))}"
          f" document spans {doc_spans(doc[0])}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(16)
    d = cfg.d_model
    x = torch.randn(1, L, d, generator=gen, device=dev).to(torch.bfloat16)
    cond = torch.randn(1, SHARD_FRAMES, d, generator=gen,
                       device=dev).to(torch.bfloat16)
    block_rows, counts = {}, {}
    for i, block in zip(SHARD_BLOCKS, blocks):
        errs, c = split_block_errors(block, SHARD_T, x, cond, doc, gen)
        layer = "local (window 16)" if block.attn.local else "global"
        worst = max(v for k, v in errs.items() if k != "out")
        print(f"[shard16] (b) block {i} ({layer}) split over tensor "
              f"{SHARD_T}, {cfg.n_heads // SHARD_T} heads a rank, against "
              f"the whole block: out rel L2 {errs['out']:.3e} (limit "
              f"{SHARD_OUT_REL}), worst gradient {worst:.3e} (limit "
              f"{SHARD_GRAD_REL}) of {len(errs) - 1}; K1 launches of the "
              f"split run {c}", flush=True)
        for name in ("frame_attention_fwd", "frame_attention_bwd_dq",
                     "frame_attention_bwd_dkv"):
            if c[name] != SHARD_T:
                fail(f"shard16 (b) block {i}: {c[name]} {name} launches, "
                     f"{SHARD_T} expected (one a rank)")
        if any(v for k, v in c.items() if not k.startswith("frame")):
            fail(f"shard16 (b) block {i}: kernels other than K1 launched "
                 f"{c}")
        if errs["out"] > SHARD_OUT_REL or worst > SHARD_GRAD_REL:
            fail(f"shard16 (b) block {i}: the split block disagrees with "
                 f"the whole one")
        block_rows[f"block{i}"] = dict(out_rel_l2=errs["out"],
                                       worst_grad_rel_l2=worst,
                                       grads_checked=len(errs) - 1,
                                       launches=c)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    out["split_block"] = block_rows
    del blocks, x, cond
    torch.cuda.empty_cache()

    fwd_rows, grad_rows = {}, {}
    Dh = cfg.d_model // cfg.n_heads
    for H in SHARD_HEADS:
        for window in (None, W):
            name = f"L{L}_tpf{tpf}_packed_{mask_name(window)}_H{H}"
            fwd_rows[name] = fwd_case(dev, gen, name, L, tpf, True, window,
                                      doc, 1, H=H, Dh=Dh)
            grad_rows.update(grad_case(dev, gen, name, "frame", L, tpf,
                                       True, window, doc, None, 1, H=H,
                                       Dh=Dh))
    out["launches"] = counts
    return dict(out, fwd_rows=fwd_rows, grad_rows=grad_rows)


# --------------------------------------------------------------- phase 17
# (a) the pipe schedule in one process: dit_v4's full width (16 x d 1536,
# 4 groups) at L 16,384, split into K stages of whole groups, M
# micro-batches handed from stage to stage in memory
PIPE_SPLITS, PIPE_MICRO, PIPE_FRAMES = (2, 4), 2, 256
# (b) the AV model's attention at tpf 65 split 4 ways: configs/
# av_v5_8x8_weak.yml at 1,536 frames (L 99,840), a slice 24,960 tokens
AV_SP_FRAMES, AV_SP_SHARDS, AV_SP_TPF, AV_SP_WINDOW = 1536, 4, 65, 16
# (c) K4 at the AV slice, and the band over [halo | slice] (26,000 tokens,
# the route halo_band_route takes there: K5 at plan (520, 2))
AV_K4_CASES = [("L24960_tpf65_causal", True), ("L24960_tpf65_full", False)]
AV_HALO_BAND_CASES = [("L26000_tpf65_520x2_bound8", 26000, 65, 16, (520, 2),
                       8.0)]
# (a) and (b) against the unsplit computation: PERF.md section 2's limits
SPLIT_OUT_REL, SPLIT_GRAD_REL = 5e-2, 3e-2


class Cuts(list):
    """The cuts a smoke run makes to a config (mesh_smoke.py,
    sp_smoke.py), one line each."""

    def cut(self, node, key, value, why):
        self.append(f"{key} {node.get(key)!r} -> {value!r} ({why})")
        node[key] = value

    def no_checkpoint(self, tc, work, why="no checkpoint in this run",
                      **extra):
        """Log every step; write no checkpoint, export or (``extra``)
        eval."""
        for key, value in dict(log_interval=1, save_interval=10 ** 9,
                               **extra,
                               checkpoint_dir=os.path.join(work, "ckpt"),
                               output_path=None).items():
            self.cut(tc, key, value, why)

    def show(self, head: str):
        """Print every line after ``head`` on the first process only."""
        if int(os.environ.get("RANK", 0)) == 0:
            for line in self:
                print(f"{head}: {line}", flush=True)


# A multi-card copy's steps against one card's (mesh_smoke.py --case pipe
# and --case distill, sp_smoke.py --check_layers). Every parameter's first
# gradient (after the sums over ranks, before the optimizer) is held to
# 0.1 relative L2: the sound copies read about 1e-2 (bf16 sums over ranks
# in another order), a stage's or a rank's gradient lost, unsummed or
# scaled reads 0.5 or more. The whole model's update after the steps is
# held to 0.25: the sound copies read 9e-3 to 9.1e-2 (AdamW at eps 1e-15
# and Muon turn the signs of updates whose gradient is at rounding level),
# one stage's update lost of three ~0.58. Muon and AdamW are scale-blind,
# so only the gradient sees a factor.
PARITY_LOSS_REL, PARITY_GRAD_REL, PARITY_UPDATE_REL = 1e-2, 0.1, 0.25


def recording_grads(base):
    """A subclass of the trainer class ``base`` that keeps the first
    gradient it reduces for each list of parameters (``first``: {id of
    the list's first parameter: [whole gradient, ...]}), gathered over
    fsdp and tensor, float32 on the host. Every rank must record (the
    gather is a collective)."""
    from owl_audio_exps_tpu_torch.parallel.sharding import (gather_tensor,
                                                            spec_of)

    class RecordingGrads(base):
        def reduce_across_ranks(self, params, metrics):
            super().reduce_across_ranks(params, metrics)
            first = self.__dict__.setdefault("first", {})
            if params and id(params[0]) not in first:
                first[id(params[0])] = [
                    gather_tensor(p.grad if p.grad is not None
                                  else torch.zeros_like(p), spec_of(p),
                                  self.mesh).float().cpu() for p in params]

    return RecordingGrads


def first_grads(trainer, module):
    """{name: first gradient} of ``module``'s parameters from a
    ``recording_grads`` trainer; under the pipe axis every stage's merged
    on the first rank of the pipe group (None on the others; a collective
    over the pipe group)."""
    from owl_audio_exps_tpu_torch.parallel.sharding import collect_stage_list
    named = list(module.named_parameters())
    grads = dict(zip((n for n, _ in named), trainer.first[id(named[0][1])]))
    parts = collect_stage_list(grads, trainer.mesh)
    if parts is None:
        return None
    return {n: g for part in parts for n, g in part.items()}


def parity_verdict(loss_rel, got, ref, init, got_grads, ref_grads):
    """The parity of a multi-card run against one card: ``got`` / ``ref``
    / ``init`` {name: parameter} after and before the same steps,
    ``got_grads`` / ``ref_grads`` {name: first gradient}. Returns the
    readings and ``failures`` (the limits above): the worst parameter's
    gradient relative L2 with its name, the parameters skipped (one
    card's gradient exactly 0, no relative error; the other's norm
    given), the whole model's update and parameters relative L2 and the
    worst single parameter's (printed only)."""
    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def whole(a, b):
        num = sum((a[k].float() - b[k].float()).pow(2).sum() for k in b)
        return (num / sum(b[k].float().pow(2).sum() for k in b)).sqrt()

    failures = []
    if set(got) != set(ref) or set(got_grads) != set(ref_grads):
        failures.append("the parameters' names differ from one card's")
    grad = {k: rel(got_grads[k], g) for k, g in ref_grads.items()
            if g.norm() > 0 and k in got_grads}
    skipped = {k: got_grads[k].norm().item() for k, g in ref_grads.items()
               if g.norm() == 0 and k in got_grads}
    worst_grad = max(grad, key=grad.get)
    per = {k: rel(got[k], ref[k]) for k in ref if ref[k].norm() > 0}
    worst = max(per, key=per.get)
    moved = [k for k in ref if (ref[k] - init[k]).norm() > 0]
    upd = whole({k: got[k] - init[k] for k in moved},
                {k: ref[k] - init[k] for k in moved}).item()
    if loss_rel > PARITY_LOSS_REL:
        failures.append(f"losses rel {loss_rel:.3e} > {PARITY_LOSS_REL}")
    if grad[worst_grad] > PARITY_GRAD_REL:
        failures.append(f"gradient of {worst_grad} rel L2 "
                        f"{grad[worst_grad]:.3e} > {PARITY_GRAD_REL}")
    if upd > PARITY_UPDATE_REL:
        failures.append(f"the update rel L2 {upd:.3e} > {PARITY_UPDATE_REL}")
    return dict(loss_rel=loss_rel, grad_rel_l2=grad[worst_grad],
                worst_grad=worst_grad, grads_held=len(grad),
                grads_skipped=skipped, update_rel_l2=upd,
                param_rel_l2=whole(got, ref).item(), worst_param=worst,
                worst_param_rel_l2=per[worst], failures=failures)


def watch_verdict(got_steps, ref_steps, n_params: int):
    """``train.watch: full`` of a multi-card copy against one card's, step
    by step ({key: value} each, from ``counted_trainer``): the same keys,
    every norm within PARITY_GRAD_REL relative (the copies' gradient
    limit: the gradients differ by bf16 sums over ranks), and each
    histogram counting every one of the ``n_params`` elements (a value
    near a bin edge may change bins). Returns the readings and
    ``failures``."""
    failures, worst, key, keys = [], 0.0, None, 0
    for i, (got, ref) in enumerate(zip(got_steps, ref_steps)):
        got = {k: v for k, v in got.items() if k.startswith("watch")}
        ref = {k: v for k, v in ref.items() if k.startswith("watch")}
        keys = len(ref)
        if not ref or set(got) != set(ref):
            failures.append(f"step {i + 1}: watch keys {sorted(got)} against "
                            f"one card's {sorted(ref)}")
            continue
        for k, v in ref.items():
            if k.startswith("watch/"):
                r = abs(got[k] - v) / max(abs(v), 1e-30)
                if r > worst:
                    worst, key = r, k
            elif not k.endswith(("_lo", "_hi")) and not \
                    sum(got[k]) == sum(v) == n_params:
                failures.append(f"step {i + 1}: {k} counts {sum(got[k])}, "
                                f"one card {sum(v)}, of {n_params}")
    if worst > PARITY_GRAD_REL:
        failures.append(f"watch {key} rel {worst:.3e} > {PARITY_GRAD_REL}")
    return dict(watch_norm_rel=worst, watch_worst=key, watch_keys=keys,
                failures=failures)


def pipe_stage_run(dit, K: int, M: int, x, cond, remat: bool = True):
    """``dit``'s blocks split into K stages of whole groups (parallel/
    pipeline.py ``stage_blocks``), M micro-batches run in GPipe order in
    one process: micro-batch m's activation leaves stage s for stage
    s + 1 in memory. Returns the output and the launches of each
    (stage, micro-batch) forward. This holds the stage split and what
    each stage runs; parallel/pipeline.py's ``pipeline_apply`` (the
    transfers, the broadcast, the sums over pipe) needs several
    processes and is not run here."""
    from owl_audio_exps_tpu_torch.parallel.pipeline import stage_blocks
    cfg = dit.config
    bm = x.shape[0] // M
    outs, counts = [], {}
    for m in range(M):
        h, c = x[m * bm:(m + 1) * bm], cond[m * bm:(m + 1) * bm]
        for st in range(K):
            blocks = stage_blocks(cfg, K, st)
            reset_counts()
            h = dit._run_blocks(blocks.start, blocks.stop, h, c, None, None,
                                True, None, 0, remat)
            counts[(st, m)] = {k: v for k, v in kernel_counts().items()
                               if v}
        outs.append(h)
    return torch.cat(outs), counts


def stage_expect(cfg, K: int, st: int, L: int):
    """The kernels a stage's forward of one micro-batch launches: its
    global layers K1, its local layers the band route's kernel."""
    from owl_audio_exps_tpu_torch.nn.attn import (attention_route,
                                                  local_layer_flags)
    from owl_audio_exps_tpu_torch.parallel.pipeline import stage_blocks
    flags = local_layer_flags(cfg)
    out = {}
    for i in stage_blocks(cfg, K, st):
        name = ("frame_attention" if not flags[i] else
                attention_route(cfg, True, L)[0] + "_attention")
        out[f"{name}_fwd"] = out.get(f"{name}_fwd", 0) + 1
    return out


def grads_rel(got, want):
    return {n: rel_l2(got[n], want[n]) for n in want
            if want[n] is not None and want[n].float().norm() > 0}


def pipe_one_process_phase(dev, cfg=None, x=None, cond=None,
                           dtype=torch.bfloat16):
    """(a) configs/dit_v4_tpu_e2e.yml's DiT at full width, L 16,384, no
    documents, split into 2 and 4 stages with M 2: output and every
    gradient (the blocks', x's, cond's) against the unsplit stack, exact
    launches per stage and micro-batch, and the backward's."""
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.nn.attn import DiT
    if cfg is None:
        cfg = Config.from_yaml(os.path.join(
            ROOT, "configs", "dit_v4_tpu_e2e.yml")).model
    dit = DiT(cfg, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(170)
    with torch.no_grad():
        for p in dit.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    n_frames = PIPE_FRAMES if x is None else x.shape[1] // \
        cfg.tokens_per_frame
    L = n_frames * cfg.tokens_per_frame
    B = PIPE_MICRO
    if x is None:
        x = torch.randn(B, L, cfg.d_model, generator=gen, device=dev
                        ).to(torch.bfloat16)
        cond = torch.randn(B, n_frames, cfg.d_model, generator=gen,
                           device=dev).to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=x.device)

    def run(fn):
        dit.zero_grad(set_to_none=True)
        xl, cl = (t.detach().requires_grad_() for t in (x, cond))
        out = fn(xl, cl)
        (out.float() * g).sum().backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in dit.named_parameters()}
        grads["x"], grads["cond"] = xl.grad, cl.grad
        return out.detach(), grads

    reset_counts()
    want_out, want = run(lambda xl, cl: dit._run_blocks(
        0, cfg.n_layers, xl, cl, None, None, True, None, 0, True))
    reset_counts()
    out = {}
    for K in PIPE_SPLITS:
        fwd_counts = {}

        def split(xl, cl):
            y, c = pipe_stage_run(dit, K, PIPE_MICRO, xl, cl)
            fwd_counts.update(c)
            reset_counts()
            return y

        t0 = time.perf_counter()
        got_out, got = run(split)
        sync(dev)
        secs = time.perf_counter() - t0
        bwd = {k: v for k, v in kernel_counts().items() if v}
        reset_counts()
        for (st, m), c in fwd_counts.items():
            if c != stage_expect(cfg, K, st, L) and torch.device(dev).type == "cuda":
                fail(f"pipe K {K} stage {st} micro-batch {m}: launches {c}, "
                     f"expected {stage_expect(cfg, K, st, L)}")
        # the backward: each block's recompute (remat) and its backward,
        # every micro-batch
        exp_bwd = {}
        for st in range(K):
            for k, v in stage_expect(cfg, K, st, L).items():
                exp_bwd[k] = exp_bwd.get(k, 0) + v * PIPE_MICRO
                stem = k[:-len("_fwd")]
                if stem == "frame_attention":
                    for b in ("bwd_dq", "bwd_dkv"):
                        exp_bwd[f"{stem}_{b}"] = \
                            exp_bwd.get(f"{stem}_{b}", 0) + v * PIPE_MICRO
                else:
                    exp_bwd[f"{stem}_bwd"] = \
                        exp_bwd.get(f"{stem}_bwd", 0) + v * PIPE_MICRO
        if torch.device(dev).type == "cuda" and bwd != exp_bwd:
            fail(f"pipe K {K}: backward launches {bwd}, expected {exp_bwd}")
        out_rel = rel_l2(got_out, want_out)
        g_rel = grads_rel(got, want)
        worst = max(g_rel, key=g_rel.get)
        print(f"[pipe1] K {K} stages x M {PIPE_MICRO} micro-batches of "
              f"{cfg.n_layers} x d {cfg.d_model} at L {L}: {secs:.2f} s "
              f"(forward + backward); out rel L2 {out_rel:.3e} (limit "
              f"{SPLIT_OUT_REL}), worst of {len(g_rel)} gradients "
              f"{g_rel[worst]:.3e} ({worst}; limit {SPLIT_GRAD_REL}); "
              f"launches a stage and micro-batch "
              f"{ {f'{st}/{m}': c for (st, m), c in fwd_counts.items()} }, "
              f"backward {bwd}", flush=True)
        if out_rel > SPLIT_OUT_REL or g_rel[worst] > SPLIT_GRAD_REL:
            fail(f"pipe K {K}: the split stack disagrees with the whole")
        total = dict(bwd)
        for c in fwd_counts.values():
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        out[f"K{K}"] = dict(seconds=secs, out_rel_l2=out_rel,
                            worst_grad_rel_l2=g_rel[worst],
                            launches_per_stage_and_micro_batch={
                                f"{st}/{m}": c
                                for (st, m), c in fwd_counts.items()},
                            backward_launches=bwd, launches=total)
    del dit, want, got
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return out


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def av_split_phase(dev, L=None, n=AV_SP_SHARDS, tpf=AV_SP_TPF,
                   window=AV_SP_WINDOW, H=24, Dh=64, dtype=torch.bfloat16):
    """(b) one global and one local layer of the AV model at tpf 65 split
    n ways, every slice run in turn through parallel/context.py's ring
    and halo step functions (counted), against the unsplit layer: K1 for
    the global one, the band route (K5 at plan (520, 2)) for the local one
    (not counted). Forward and gradients within SPLIT_OUT_REL /
    SPLIT_GRAD_REL."""
    from owl_audio_exps_tpu_torch.nn.attn import attention_route
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.ops import band, band2, splash
    from owl_audio_exps_tpu_torch.parallel.context import halo_band_route
    L = L or AV_SP_FRAMES * tpf
    cfg = Config.from_dict({"model": dict(
        tokens_per_frame=tpf, local_window=window, global_window=None,
        causal=True)}).model
    bound = float(Dh) ** 0.5
    gen = torch.Generator(device=dev).manual_seed(171)
    q, k, v, g = (torch.randn(1, H, L, Dh, generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    q, k = rms_normed(q).to(dtype), rms_normed(k).to(dtype)
    route, plan = attention_route(cfg, True, L)
    C = window * tpf
    halo_route = halo_band_route(L // n + C, tpf, window)

    def whole_local(*t):
        if route == "band2":
            return band2.band2_attention(*t, tpf, window, *plan,
                                         logit_bound=bound)
        if route == "band":
            return band.band_attention(*t, tpf, window, logit_bound=bound)
        return splash.splash_attention(*t, tpf, window, True)

    paths = {
        "ring": (lambda *t: ring_one_process(*t, tpf, n),
                 lambda *t: splash.splash_attention(*t, tpf, None, True)),
        "halo": (lambda *t: halo_one_process(*t, tpf, window, n, bound),
                 whole_local)}
    got, secs = {}, {}
    reset_counts()
    for name, (fn, _) in paths.items():
        t0 = time.perf_counter()
        got[name] = grads_of(fn, q, k, v, g)
        sync(dev)
        secs[name] = time.perf_counter() - t0
    counts = kernel_counts()
    reset_counts()
    band = f"{halo_route[0]}_attention"
    expect = dict.fromkeys(counts, 0)
    expect.update(ring_partial_fwd=n * n + n * (n - 1),
                  ring_partial_bwd_dq=n * n, ring_partial_bwd_dkv=n * n)
    expect[f"{band}_fwd"], expect[f"{band}_bwd"] = n, n
    print(f"[av-split] {n} slices x {L // n} tokens of L {L} (tpf {tpf}, "
          f"H {H}, local window {window}: halo C {C}, the halo band "
          f"{halo_route} over {L // n + C} tokens, the unsplit local layer "
          f"{(route, plan)}) in one process: ring {secs['ring']:.2f} s, "
          f"halo {secs['halo']:.2f} s (forward + backward); launches "
          f"{ {k: c for k, c in counts.items() if c} }", flush=True)
    if torch.device(dev).type == "cuda" and counts != expect:
        fail(f"av split: launches {counts}, expected {expect}")
    errs = {}
    for name, (_, full) in paths.items():
        want = grads_of(full, q, k, v, g)
        e = {t: rel_l2(a, b) for t, a, b in
             zip(("out", "dq", "dk", "dv"), got[name], want)}
        errs[name] = e
        print(f"[av-split] {name} vs the unsplit "
              f"{'K1' if name == 'ring' else route}: relative L2 "
              + " ".join(f"{t} {x:.3e}" for t, x in e.items())
              + f" (limits out {SPLIT_OUT_REL}, gradients {SPLIT_GRAD_REL})",
              flush=True)
        if e["out"] > SPLIT_OUT_REL or max(e["dq"], e["dk"], e["dv"]) > \
                SPLIT_GRAD_REL:
            fail(f"av split: the {name} disagrees with the unsplit layer")
        del want
    reset_counts()
    del got, q, k, v, g
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return dict(counts={k: c for k, c in counts.items() if c},
                rel_l2=errs, seconds=secs, halo_route=list(halo_route),
                unsplit_local_route=[route, plan])


def distill_triple_phase(dev, student_cfg=None, teacher_cfg=None,
                         meshes=None):
    """(d) configs/dit_v4_dmd.yml's student, critic (a copy of the
    student) and teacher (configs/dit_v4.yml), seeded, split by the rules
    for {fsdp 2, tensor 2} and put together again, bit for bit."""
    import copy
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.models.gamerft import GameRFTCore
    meshes = meshes or {"fsdp2_tensor2": dict(fsdp=2, tensor=2)}
    if student_cfg is None:
        dmd = Config.from_yaml(os.path.join(ROOT, "configs",
                                            "dit_v4_dmd.yml"))
        student_cfg = dmd.model
        teacher_cfg = Config.from_yaml(os.path.join(
            ROOT, dmd.train.teacher_cfg)).model
    student = GameRFTCore(student_cfg, dtype=torch.bfloat16, device=dev,
                          seed=0)
    out = {}
    for name, core in (("student", student),
                       ("critic", copy.deepcopy(student)),
                       ("teacher", GameRFTCore(teacher_cfg,
                                               dtype=torch.bfloat16,
                                               device=dev, seed=1))):
        out[name] = shard_round_trip(core, meshes, tag=f"distill-{name}")
        if not all(r["bit_equal"] for r in out[name].values()):
            fail(f"distill triple: the {name} is not bit-equal after the "
                 "round trip")
        del core
    del student
    gc.collect()
    return out


def slice14_phase(dev):
    """Phase 17: the pipe schedule in one process (a), the AV attention at
    tpf 65 split 4 ways (b), K4 at tpf 65 and the halo band against their
    plain versions with times, bounds and SDPA's (c), the distillation
    triple split and gathered for {fsdp 2, tensor 2} (d)."""
    out = {"pipe": pipe_one_process_phase(dev)}
    out["av_split"] = av_split_phase(dev)
    grad_rows = dict(k4_phase(dev, L=AV_SP_FRAMES * AV_SP_TPF // AV_SP_SHARDS,
                              tpf=AV_SP_TPF, cases=AV_K4_CASES, tag="k4-av"))
    grad_rows.update(band2_phase(dev, AV_HALO_BAND_CASES))
    out["distill_triple"] = distill_triple_phase(dev)
    launches = dict.fromkeys(kernel_counts(), 0)
    for row in out["pipe"].values():
        for k, v in row["launches"].items():
            launches[k] += v
    for k, v in out["av_split"]["counts"].items():
        launches[k] += v
    out["launches"] = launches
    out["grad_rows"] = grad_rows
    return out


# ---------------------------------------------------------------- phase 18
SLICE15_DIR = os.path.join(ROOT, "build", "chip_smoke_slice15")
CACHE_SAMPLES, CACHE_TICKS, CACHE_DOC_FRAMES = 4, 3, (72, 96)
CLI_AV_FRAMES, CLI_DIT_FRAMES = 2, 8
# phase 18 (c), (d): the traced steps (profile_start 1: steps 1 to 4) and
# the watch runs' steps
TRACE_START, TRACE_STEPS, WATCH_STEPS = 1, 6, 3
# each kernel's name in the trace (the band's backward launch runs its dq
# kernel, then its dkv kernel: counted by the dq kernel)
TRACE_KERNELS = {"frame_attention_fwd": "frame_attn_fwd_kernel",
                 "frame_attention_bwd_dq": "frame_attn_bwd_dq_kernel",
                 "frame_attention_bwd_dkv": "frame_attn_bwd_dkv_kernel",
                 "band_attention_fwd": "band_attn_fwd_kernel",
                 "band_attention_bwd": "band_attn_bwd_dq_kernel"}


def write_av_table(path: str, cfg, docs: int, frames, seed: int = 18):
    """A cod AV table of ``docs`` seeded documents of ``frames`` (lo, hi)
    frames at the model's shapes (float16 video, float32 audio, mouse,
    buttons), written with the port's NpyTable; returns the lengths."""
    import numpy as np
    from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(frames[0], frames[1] + 1, docs)]
    table = NpyTable(path, columns=[
        "video", "audio", "mouse", "buttons", "tarball", "pt_idx",
        "missing", "truncated", "seq_len"],
        array_columns=["video", "audio", "mouse", "buttons"])
    p = cfg.sample_size
    for i, n in enumerate(lens):
        table.append(
            video=rng.standard_normal((n, cfg.channels, p, p),
                                      dtype=np.float32).astype(np.float16),
            audio=rng.standard_normal((n, cfg.audio_channels),
                                      dtype=np.float32),
            mouse=rng.standard_normal((n, 2), dtype=np.float32),
            buttons=(rng.random((n, cfg.n_buttons)) > 0.5).astype(
                np.float32),
            tarball=f"doc{i}", pt_idx=i, missing=False, truncated=False,
            seq_len=n)
    return lens


def warm_cache_phase(dev):
    """Phase 18 (a): inference/build_cache.py writes CACHE_SAMPLES buffers
    from a cod table at configs/av_v4_8x8.yml's shapes; CausvidPipeline at
    full width warm-starts from each and runs CACHE_TICKS ticks."""
    import numpy as np
    import yaml
    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.inference import build_cache
    from owl_audio_exps_tpu_torch.inference.pipeline import CausvidPipeline
    from owl_audio_exps_tpu_torch.models.gamerft_audio import GameRFTAudioCore

    work = os.path.join(SLICE15_DIR, "cache")
    conf = Config.from_yaml(os.path.join(ROOT, "configs", "av_v4_8x8.yml"))
    tc = conf.train
    W, steps = 60, 2
    table = os.path.join(work, "table")
    lens = write_av_table(table, conf.model, CACHE_SAMPLES, CACHE_DOC_FRAMES)
    for key, value, why in (
            ("data_id", "cod", "no S3 bucket: the phase's cod table"),
            ("data_kwargs", dict(dataset_path=table, window_length=W,
                                 batch_columns=["video", "audio", "mouse",
                                                "buttons"]),
             f"the table ({len(lens)} documents of {min(lens)}-{max(lens)} "
             f"frames), the window pipeline's W {W}, the S3 loader's "
             "[video, audio, mouse, buttons]")):
        print_cut("cache", "av_v4_8x8.yml", tc, key, value, why)
    path = os.path.join(work, "av_v4_8x8_cod.yml")
    with open(path, "w") as f:
        yaml.safe_dump(conf.to_dict(), f)
    out_dir = os.path.join(work, "data_cache")
    t0 = time.perf_counter()
    build_cache.main(["--config_path", path, "--out_dir", out_dir,
                      "--n_samples", str(CACHE_SAMPLES)])
    build_s = time.perf_counter() - t0

    cfg = serve_config()
    core = GameRFTAudioCore(cfg, dtype=torch.bfloat16, device=dev,
                            seed=0).to(torch.bfloat16).eval()
    pipe = CausvidPipeline(core, cfg, window_length=W, sampling_steps=steps,
                           seed=0, device=dev, image_scale=tc.vae_scale,
                           audio_scale=tc.audio_vae_scale)
    ticks, launches = [], 0
    for i in range(CACHE_SAMPLES):
        pipe.load_cache(out_dir, cache_idx=i)
        data = np.load(os.path.join(out_dir, f"buffers_{i}.npz"))
        want = dict(history=data["history"] / pipe.image_scale,
                    audio=data["audio"] / pipe.audio_scale,
                    mouse=data["mouse"], button=data["button"])
        for name, arr in want.items():
            got = getattr(pipe.buffers, name)
            ref = torch.from_numpy(np.asarray(arr)).to(dev, torch.bfloat16)
            if got.shape != ref.shape or not torch.equal(got, ref):
                fail(f"cache {i}: buffer {name} differs from the npz")
        for j in range(CACHE_TICKS):
            reset_counts()
            frame, audio, dt = pipe([0.1 * j, -0.05 * j],
                                    np.ones(cfg.n_buttons, np.float32))
            counts = kernel_counts()
            want_counts = dict.fromkeys(counts, 0)
            want_counts["frame_attention_fwd"] = steps * cfg.n_layers
            if counts != want_counts:
                fail(f"cache {i} tick {j}: launches {counts}, expected "
                     f"{want_counts}")
            if not (torch.isfinite(frame).all() and
                    torch.isfinite(audio).all()):
                fail(f"cache {i} tick {j}: non-finite output")
            ticks.append(1e3 * dt)
            launches += counts["frame_attention_fwd"]
    print(f"[cache] build_cache wrote {CACHE_SAMPLES} buffers of {W} frames "
          f"in {build_s:.2f} s; CausvidPipeline W={W} warm-started from "
          f"each (buffers bit-equal to the npz), {CACHE_TICKS} ticks each: "
          f"ms/tick median {statistics.median(ticks):.2f}, K1 fwd "
          f"{launches} ({steps * cfg.n_layers} a tick)", flush=True)
    del pipe, core
    torch.cuda.empty_cache()
    return dict(build_s=build_s, tick_ms=statistics.median(ticks),
                ticks=len(ticks), launches=launches,
                per_tick=steps * cfg.n_layers)


def sampling_cli(config: str, frames: int, tag: str):
    """``python -m owl_audio_exps_tpu_torch.inference.test_sampling`` as a
    subprocess: (frames/s, latents' shape, its port kernel launches)."""
    import ast
    import re
    cmd = [sys.executable, "-m",
           "owl_audio_exps_tpu_torch.inference.test_sampling",
           "--config_path", os.path.join("configs", config),
           "--num_frames", str(frames)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    print(f"[{tag}] $ {' '.join(cmd[1:])} (exit {run.returncode}, "
          f"{wall:.1f} s)", flush=True)
    for line in run.stdout.strip().splitlines():
        print(f"[{tag}]   {line}", flush=True)
    if run.returncode != 0:
        print(run.stderr[-4000:], flush=True)
        fail(f"the sampling CLI failed on configs/{config}")
    m = re.search(r"sampled latents (\([0-9, ]+\)).* \(([0-9.]+) frames/s\)",
                  run.stdout)
    k = re.search(r"port kernel launches (\{.*\})", run.stdout)
    if not (m and k):
        fail(f"the sampling CLI printed no result on configs/{config}")
    return (float(m.group(2)), ast.literal_eval(m.group(1)),
            ast.literal_eval(k.group(1)), wall)


def sampling_cli_phase():
    """Phase 18 (b): the sampling CLI on configs/av_v4_8x8.yml
    (av_window: K1 on every forward) and configs/dit_v4_tpu_e2e.yml
    (av_caching: no port kernel)."""
    from owl_audio_exps_tpu_torch.configs import Config
    conf = Config.from_yaml(os.path.join(ROOT, "configs", "av_v4_8x8.yml"))
    skw = conf.train.sampler_kwargs
    out = {}
    for config, frames, expect in (
            ("av_v4_8x8.yml", CLI_AV_FRAMES,
             CLI_AV_FRAMES * skw.n_steps * 2 * conf.model.n_layers),
            ("dit_v4_tpu_e2e.yml", CLI_DIT_FRAMES, 0)):
        fps, shape, counts, wall = sampling_cli(config, frames, "cli")
        if counts.get("frame_attention_fwd") != expect or any(
                v for k, v in counts.items() if k != "frame_attention_fwd"):
            fail(f"the sampling CLI on configs/{config} launched {counts}, "
                 f"expected K1 fwd {expect} and nothing else")
        out[config] = dict(frames_per_s=fps, frames=frames, shape=shape,
                           launches=counts, wall_s=wall)
    k1 = out["av_v4_8x8.yml"]["launches"]["frame_attention_fwd"]
    print(f"[cli] av_window {out['av_v4_8x8.yml']['frames_per_s']:.2f} "
          f"frames/s (K1 fwd {k1}, {skw.n_steps} steps x CFG x "
          f"{conf.model.n_layers} layers a frame); av_caching "
          f"{out['dit_v4_tpu_e2e.yml']['frames_per_s']:.2f} frames/s "
          "(no port kernel)", flush=True)
    return out


def slice15_train_config(tag, **cuts):
    """configs/dit_v4_tpu_e2e.yml with no checkpoint and ``cuts``, every
    one printed."""
    from owl_audio_exps_tpu_torch.configs import Config
    conf = Config.from_yaml(os.path.join(ROOT, "configs",
                                         "dit_v4_tpu_e2e.yml"))
    tc = conf.train
    base = dict(checkpoint_dir=os.path.join(SLICE15_DIR, tag, "ckpt"),
                output_path=None, save_interval=10 ** 9, log_interval=1)
    for key, value in dict(base, **cuts).items():
        print_cut(tag, "dit_v4_tpu_e2e.yml", tc, key, value,
                  "phase 18: no checkpoint written"
                  if key in base else "phase 18")
    return conf


def trace_kernel_counts(path: str):
    """Each TRACE_KERNELS kernel's events in a Chrome trace, and the
    trace's device events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return ({k: sum(name in n for n in kernels)
             for k, name in TRACE_KERNELS.items()}, len(kernels))


def trace_phase(dev, step_s: float):
    """Phase 18 (c): RFTTrainer with train.profile_dir and profile_start
    1: the trace of steps 1 to 4 holds exactly 4 steps' launches."""
    import glob
    import shutil
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import RFTTrainer
    trace_dir = os.path.join(SLICE15_DIR, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    conf = slice15_train_config("trace", profile_dir=trace_dir,
                                profile_start=TRACE_START,
                                max_steps=TRACE_STEPS)
    L = conf.train.data_kwargs.window_length * conf.model.tokens_per_frame
    per_step = expected_counts(conf.model, L)
    trainer = counted_trainer(RFTTrainer)(conf, device=dev)
    trainer.train(max_steps=TRACE_STEPS)
    for i, st in enumerate(trainer.steps):
        if st["counts"] != per_step or not math.isfinite(st["loss"]):
            fail(f"trace step {i}: launches {st['counts']} (expected "
                 f"{per_step}), loss {st['loss']}")
    paths = glob.glob(os.path.join(trace_dir, "rank0_*.pt.trace.json"))
    if len(paths) != 1:
        fail(f"the profiler wrote {paths}, expected one trace")
    counts, n_kernels = trace_kernel_counts(paths[0])
    traced = TRACE_STEPS - 1 - TRACE_START      # steps 1 to 4
    want = {k: traced * per_step[k] for k in TRACE_KERNELS}
    size = os.path.getsize(paths[0])
    times = [st["s"] for st in trainer.steps]
    with_prof = statistics.median(times[TRACE_START + 1:
                                        TRACE_START + traced])
    print(f"[trace] {TRACE_STEPS} steps with profile_start {TRACE_START}: "
          f"{os.path.relpath(paths[0], ROOT)} ({size / 2 ** 20:.1f} MiB, "
          f"{n_kernels} kernels); kernels in the trace {counts}, expected "
          f"{traced} steps x PERF.md's launches a step = {want}", flush=True)
    if counts != want:
        fail(f"the trace holds {counts}, expected {want}")
    print(f"[trace] step s " + " ".join(f"{t:.3f}" for t in times)
          + f": traced steps {TRACE_START + 1}-{TRACE_START + traced - 1} "
          f"median {with_prof:.4f} s against {step_s:.4f} s untraced (phase "
          f"5): {100 * (with_prof / step_s - 1):+.1f}%", flush=True)
    shutil.rmtree(trace_dir, ignore_errors=True)
    launches = {k: sum(st["counts"][k] for st in trainer.steps)
                for k in per_step}
    del trainer
    torch.cuda.empty_cache()
    return dict(trace_kernels=counts, expected=want, trace_mib=size / 2 ** 20,
                steps_s=times, traced_step_s=with_prof, untraced_step_s=step_s,
                launches=launches)


def watch_phase(dev, step_s: float):
    """Phase 18 (d): the same trainer with train.watch norms and full:
    every group present and finite, the histograms counting every
    parameter and gradient; the step time against watch off."""
    from owl_audio_exps_tpu_torch.trainers.rft_trainer import RFTTrainer
    from owl_audio_exps_tpu_torch.utils.telemetry import group_key
    out, launches = {}, dict.fromkeys(kernel_counts(), 0)
    for mode in ("norms", "full"):
        conf = slice15_train_config(f"watch_{mode}", watch=mode,
                                    max_steps=WATCH_STEPS)
        trainer = counted_trainer(RFTTrainer)(conf, device=dev)
        state = trainer.train(max_steps=WATCH_STEPS)
        groups = sorted({group_key(n) for n, _ in
                         state.model.named_parameters()})
        n_params = sum(p.numel() for p in state.model.parameters())
        bins = int(conf.train.get("watch_bins") or 64)
        for i, st in enumerate(trainer.steps):
            m = st["metrics"]
            for g in groups:
                for what in ("param_norm", "grad_norm"):
                    v = m.get(f"watch/{what}/{g}")
                    if v is None or not math.isfinite(v):
                        fail(f"watch {mode} step {i}: {what} of {g} is {v}")
            if mode == "full":
                for tree in ("params", "grads"):
                    counts = m[f"watch_hist/{tree}"]
                    if len(counts) != bins or sum(counts) != n_params:
                        fail(f"watch full step {i}: the {tree} histogram "
                             f"counts {sum(counts)} of {n_params}")
            for k, v in st["counts"].items():
                launches[k] += v
        t = statistics.median(st["s"] for st in trainer.steps[1:])
        out[mode] = dict(step_s=t, groups=len(groups),
                         steps_s=[st["s"] for st in trainer.steps],
                         overhead=t / step_s - 1)
        print(f"[watch] {mode}: {len(groups)} groups "
              f"({', '.join(groups)}) finite every step; step s median "
              f"{t:.4f} against {step_s:.4f} watch off (phase 5): "
              f"{100 * (t / step_s - 1):+.1f}%", flush=True)
        del trainer, state
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def slice15_phase(dev, step_s: float):
    """Phase 18: the warm-cache writer and the window pipeline warm-started
    from it (a), the sampling CLI (b), trace capture in the trainer (c)
    and train.watch's cost (d)."""
    import shutil
    shutil.rmtree(SLICE15_DIR, ignore_errors=True)
    out = {}
    for name, fn, args in (("warm_cache", warm_cache_phase, (dev,)),
                           ("sampling_cli", sampling_cli_phase, ()),
                           ("trace", trace_phase, (dev, step_s)),
                           ("watch", watch_phase, (dev, step_s))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"[env] phase 18 {name} took {out[name]['seconds']:.1f} s",
              flush=True)
    shutil.rmtree(SLICE15_DIR, ignore_errors=True)
    k1 = "frame_attention_fwd"
    out["launches_by_path"] = {
        "warm_cache_serve": {k1: out["warm_cache"]["launches"]},
        "sampling_cli_av_window": {k1: out["sampling_cli"][
            "av_v4_8x8.yml"]["launches"][k1]},
        "traced_train": out["trace"].pop("launches"),
        "watched_train": out["watch"].pop("launches")}
    return out


def grads_of(fn, q, k, v, g):
    """(out, dq, dk, dv) of fn under the cotangent g; where fn returns a
    tuple (K4's out and lse), g is a tuple too and the list starts with
    every output."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    outs, gs = (out, g) if isinstance(out, tuple) else ((out,), (g,))
    torch.autograd.backward(outs, gs)
    return [o.detach() for o in outs] + [t.grad for t in leaves]


KERNELS = {
    "frame_attention_fwd": ("frame_attention.cu", "ops/splash.py:237"),
    "frame_attention_bwd_dq": ("frame_attention.cu", "ops/splash.py:220"),
    "frame_attention_bwd_dkv": ("frame_attention.cu", "ops/splash.py:220"),
    "band_attention_fwd": ("band_attention.cu", "ops/band.py:422"),
    "band_attention_bwd": ("band_attention.cu", "ops/band.py:599"),
    "ring_partial_fwd": ("frame_attention.cu", "ops/splash.py:312"),
    "ring_partial_bwd_dq": ("frame_attention.cu", "ops/splash.py:358"),
    "ring_partial_bwd_dkv": ("frame_attention.cu", "ops/splash.py:358"),
    "band2_attention_fwd": ("band_attention.cu", "ops/band2.py:348"),
    "band2_attention_bwd": ("band_attention.cu", "ops/band2.py:552"),
}
MAIN_CASE = {  # the training path's geometry of each kernel
    "frame_attention_fwd": "L16384_tpf64_causal_global",
    "frame_attention_bwd_dq": "L16384_tpf64_causal_global",
    "frame_attention_bwd_dkv": "L16384_tpf64_causal_global",
    "band_attention_fwd": "L16384_tpf64_w16_bound8",
    "band_attention_bwd": "L16384_tpf64_w16_bound8",
    # 3 of the 4 partials of a rank's ring are unmasked
    "ring_partial_fwd": "L24576_full",
    "ring_partial_bwd_dq": "L24576_full",
    "ring_partial_bwd_dkv": "L24576_full",
    # the AV training step's local layers: plan (520, 2), fixed shift
    "band2_attention_fwd": "L24960_tpf65_520x2_bound8",
    "band2_attention_bwd": "L24960_tpf65_520x2_bound8",
}


# the document summary's main-path geometry: the packed training window
DOC_SUMMARY_CASE = "L98304_tpf64_packed_global"


def kernel_record(fwd_rows, grad_rows, launches, extra):
    out = []
    for name, (src, replaces) in KERNELS.items():
        if name == "frame_attention_fwd":
            cases = fwd_rows
        else:
            cases = {case: row for (k, case), row in grad_rows.items()
                     if k == name}
        main = cases[MAIN_CASE[name]]
        out.append(dict(
            name=name, route="cuda",
            source=f"owl_audio_exps_tpu_torch/csrc/{src}",
            replaces=f"owl_audio_exps_tpu/{replaces}",
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in cases.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"],
            case=f"B=1 H=24 Dh=64 {MAIN_CASE[name]}", cases=cases,
            **extra.get(name, {})))
    # the helper kernel K1's document path launches before its forward
    main = DOC_SUMMARY_ROWS[DOC_SUMMARY_CASE]
    out.append(dict(
        name="doc_tiles", route="cuda",
        source="owl_audio_exps_tpu_torch/csrc/frame_attention.cu",
        replaces="owl_audio_exps_tpu/ops/splash.py:279",
        launches=launches["doc_tiles"],
        max_abs_err=max(r["max_abs_err"] for r in DOC_SUMMARY_ROWS.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        case=f"B=1 {DOC_SUMMARY_CASE}", cases=dict(DOC_SUMMARY_ROWS),
        **extra.get("doc_tiles", {})))
    return out


# the entry kernels of each library (csrc/<stem>.cu), all on the Hopper
# bodies of csrc/hopper_attention.cuh: (name, mangled template arguments)
# for both head dims, and the band kernels (K2/K3 and K5) for both softmax
# forms
HOPPER_KERNELS = {
    # K1 with and without documents (the kDoc bodies), K4
    "frame_attention": [(f"{k}_kernel", f"ILi{dh}ELb{doc}E") for k in (
        "frame_attn_fwd", "frame_attn_bwd_dq", "frame_attn_bwd_dkv")
        for dh in (64, 128) for doc in (0, 1)] + [
        (f"{k}_kernel", f"ILi{dh}E") for k in (
            "ring_attn_fwd", "ring_attn_bwd_dq", "ring_attn_bwd_dkv")
        for dh in (64, 128)],
    "band_attention": [(f"band_attn_{k}_kernel", f"ILi{dh}ELb{fixed}E")
                       for k in ("fwd", "bwd_dq", "bwd_dkv")
                       for dh in (64, 128) for fixed in (0, 1)],
}


# ---------------------------------------------------- the decode kernel
# the cached AV serve's attention calls (perfbench av_v5.serve.cached1: a
# 120-frame ring of 65 tokens a frame with its 16-frame shadow, 8,840
# slots, full; 24 heads of 64): the steady forward's 130 queries over
# [ring | 130 new] (global layers, and local ones under their window mask
# over the whole ring), the decoding forward's 65 over [ring | 65 new] and
# its local layers' gathered 975-token window; the steady global call of
# 8 sessions on one ring (phase 11's 8-session tick); and the prime's
# 7,735 queries (119 frames) over the empty ring, in 49 query tiles of
# one split each
DECODE_CASES = [
    # name, sessions, queries, mask, write_len, ring full (else empty)
    ("global_steady", 1, 130, "global", 65, True),
    ("local_steady", 1, 130, "local", 65, True),
    ("global_decode", 1, 65, "global", None, True),
    ("local_decode", 1, 65, "gathered", None, True),
    ("global_steady_b8", 8, 130, "global", 65, True),
    ("global_prime", 1, 7735, "global", None, False),
    ("local_prime", 1, 7735, "local", None, False),
]
# kernel vs plain version on the same bf16 operands: both round P to bf16
# after sums in another order, and the output to bf16, so a few elements
# differ by a bf16 step. Read on an H100 at these rows: largest 2.4e-4 to
# 4.9e-4 at the tick's shapes and 8 sessions, 1.95e-3 at the prime (a
# step at 0.25-0.5: its first frames see 65 keys); mean 1.1e-7 to 1.8e-7.
# The largest may reach one step at 0.5-1 (3.9e-3); a mask bit wrong for
# one key a row moves the mean by ~1e-4
DECODE_MAX_ABS, DECODE_MEAN_ABS = 4e-3, 2e-6
# the decode kernel's launches in one steady tick of the cached AV serve
# (24 layers; fused write, 2 steps): 48 calls of 4 launches (the plan,
# pass 1, pass 2, the splits' sum)
DECODE_TICK_LAUNCHES = 48 * 4


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms a call of ``fn`` takes inside a CUDA graph of ``calls``
    calls (as the serve replays its tick): the median of ``reps`` replays,
    after one warm call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def decode_phase(dev):
    """The decode kernel (ops/decode_attention.py) at the serve's shapes
    (``DECODE_CASES``): its device ms a call inside a graph (plan, pass 1,
    pass 2, the splits' sum), against its bound (K and V of the visible
    64-key tiles at 3.35 TB/s; 4 Dh FLOPs a visible pair at 989 TFLOP/s),
    the plain version's ms, and at one session's tick shapes the port's
    former dense path's ms (dot_attention over the concatenated ring) and
    one SDPA call with the same mask (the library's yardstick; the port
    never calls it). Checks every row's output against the plain version
    and the launches."""
    from torch.nn import functional as F

    from owl_audio_exps_tpu_torch.configs import Config
    from owl_audio_exps_tpu_torch.nn.attn import build_masks
    from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
    from owl_audio_exps_tpu_torch.ops import decode_attention as da
    from owl_audio_exps_tpu_torch.ops.attention import dot_attention

    with open(os.path.join(ROOT, "perfbench", "configs", "av_v5.json")) as f:
        conf = json.load(f)
    cfg = Config.from_dict({"model": conf["model"],
                            "train": conf["train"]}).model
    H, Dh, tpf = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.tokens_per_frame
    gen = torch.Generator(device=dev).manual_seed(20)
    # the serve's ring geometry (capacity and shadow; meta: no memory)
    spec = KVCache.from_config(cfg, 1, capacity_frames=120, device="meta")
    capacity, shadow = spec.capacity, spec.shadow

    def draw(*shape):
        x = torch.randn(*shape, generator=gen, device=dev)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(
            torch.bfloat16)

    def ring(sessions, filled):
        """A one-layer ring of the serve's geometry, every slot drawn: full
        from slot 1,235, or empty."""
        c = KVCache.create(1, sessions, capacity, H, Dh, tpf, shadow=shadow,
                           device=dev)
        for buf in (c.k, c.v):
            buf.copy_(draw(*buf.shape))
        if filled:
            c.start.fill_(1235)
            c.length.fill_(c.capacity)
            c.rope_offset.fill_(c.capacity)
        return c

    rows, faults = {}, []
    for name, B, lq, kind, wl, filled in DECODE_CASES:
        cache = ring(B, filled)
        q, nk, nv = (draw(B, H, lq, Dh) for _ in range(3))
        if kind == "gathered":
            n = cfg.local_window * tpf - lq
            ck, cv, valid = cache.gather_trailing(0, n, local=True)
            mask = torch.cat([valid, torch.ones(lq, dtype=torch.bool,
                                                device=dev)])[None, :]
        else:
            local, glob = build_masks(cfg, lq, None, kv_cache=cache,
                                      write_len=wl)
            mask = local if kind == "local" else glob
            ck, cv = cache.read_layer(0)
        S = ck.shape[2]
        m2 = mask.expand(lq, S + lq)
        rows_q, nq = da.query_tiling(lq)
        n_tiles = da.key_tiles(S, lq)[1]
        ns = da.split_count(B * H * nq, n_tiles, da._sms(dev.index or 0))
        cols = [da.tile_columns(j, S, lq) for j in range(n_tiles)]
        # K and V of each query tile's visible tiles, every session
        keys = sum(c1 - c0 for qt in range(nq) for c0, c1 in cols
                   if bool(m2[qt * rows_q:(qt + 1) * rows_q, c0:c1].any()))
        pairs = int(m2.sum())
        nbytes = B * 2 * keys * H * Dh * 2
        flops = B * 4 * Dh * pairs * H
        bound = bound_row(flops, nbytes)
        before = da.launches
        out = da.decode_attention(q, ck, cv, nk, nv, mask)
        torch.cuda.synchronize()
        launched = da.launches - before
        if launched != 3 + (ns > 1):
            faults.append(f"{name}: {launched} launches, expected "
                          f"{3 + (ns > 1)}")
        plain = da.decode_attention_plain(q, ck, cv, nk, nv, mask)
        err = (out.float() - plain.float()).abs()
        max_abs, mean_abs = err.max().item(), err.mean().item()
        if not (max_abs < DECODE_MAX_ABS and mean_abs < DECODE_MEAN_ABS):
            faults.append(f"{name}: max {max_abs:.3g} mean {mean_abs:.3g} "
                          f"against the plain version")
        ms = graph_ms(lambda: da.decode_attention(q, ck, cv, nk, nv, mask))
        plain_ms = cuda_ms(
            lambda: da.decode_attention_plain(q, ck, cv, nk, nv, mask), 3, 1)
        dense_ms = lib = None
        if B == 1 and lq <= 130:
            kf, vf = torch.cat([ck, nk], 2), torch.cat([cv, nv], 2)
            dense_ms = cuda_ms(lambda: dot_attention(q, kf, vf, mask), 10)
            lib = library_ms(lambda: F.scaled_dot_product_attention(
                q, kf, vf, attn_mask=m2[None, None]), 20)
        rows[name] = dict(
            shape=f"{B} x {lq} x ({S} + {lq})", splits=ns, query_tiles=nq,
            visible_keys=keys, visible_pairs=pairs, ms=ms, **bound,
            gbytes=nbytes / 1e9, share_of_bound=bound["bound_ms"] / ms,
            plain_ms=plain_ms, dense_ms=dense_ms, library_ms=lib,
            launches_a_call=launched, max_abs=max_abs, mean_abs=mean_abs)
        print(f"[decode] {name} {rows[name]['shape']}: {ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), plain "
              f"{plain_ms:.3f}, dense {dense_ms}, sdpa {lib}, {nq} query "
              f"tiles, {ns} splits, launches {launched}, max {max_abs:.3g} "
              f"mean {mean_abs:.3g}", flush=True)
        del cache, q, nk, nv, ck, cv, out, plain, err
        torch.cuda.empty_cache()
    if faults:
        fail(f"decode kernel against its plain version (limits "
             f"{DECODE_MAX_ABS}, {DECODE_MEAN_ABS}): {faults}")
    rows["serve_tick"] = decode_tick_check(dev)
    return rows


def decode_tick_check(dev):
    """The cached AV serve at configs/causvid.yml's width (phase 11's
    pipeline, 1 session): every attention call of the steady tick takes
    the decode kernel, eager and in the captured graph: no dense call,
    ``DECODE_TICK_LAUNCHES`` launches a tick, as many at each warm-up
    step and at the capture, none at a replay."""
    import numpy as np

    from owl_audio_exps_tpu_torch.inference.pipeline import (
        AVCachedStreamingPipeline)
    from owl_audio_exps_tpu_torch.nn import attn
    from owl_audio_exps_tpu_torch.ops import decode_attention as da
    from owl_audio_exps_tpu_torch.sampling.common import WARMUP_STEPS

    cfg = pipeline_config()
    core = make_core(cfg, dev, seed=7)
    gen = torch.Generator(device=dev).manual_seed(43)
    p = cfg.sample_size
    ctx = (torch.randn(1, PIPE_PRIME, cfg.channels, p, p, generator=gen,
                       device=dev),
           torch.randn(1, PIPE_PRIME, cfg.audio_channels, generator=gen,
                       device=dev),
           torch.zeros(1, PIPE_PRIME, 2, device=dev),
           torch.zeros(1, PIPE_PRIME, cfg.n_buttons, device=dev))
    rs = np.random.RandomState(6)
    counts = {}
    for graphed in (False, True):
        pipe = AVCachedStreamingPipeline(
            core, cfg, window_frames=PIPE_WINDOW, sampling_steps=PIPE_STEPS,
            seed=9, n_sessions=1, fused_write=True, device=dev,
            graphed=graphed)
        pipe.prime(*ctx)
        got = []
        for _ in range(WARMUP_STEPS + 2):
            d0, l0 = attn.dense_calls, da.launches
            pipe(rs.randn(1, 2).astype(np.float32),
                 (rs.rand(1, cfg.n_buttons) > 0.5).astype(np.float32))
            got.append((attn.dense_calls - d0, da.launches - l0))
        counts["graphed" if graphed else "eager"] = got
        del pipe
    # the graphed pipeline's first WARMUP_STEPS ticks run eagerly, the
    # next one captures its step (and replays it), later ones replay only
    want = dict(eager=[(0, DECODE_TICK_LAUNCHES)] * (WARMUP_STEPS + 2),
                graphed=[(0, DECODE_TICK_LAUNCHES)] * (WARMUP_STEPS + 1)
                + [(0, 0)])
    print(f"[decode] the serve's steady tick, (dense calls, decode launches) "
          f"a tick: {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"decode kernel launches in the serve's tick {counts}, "
             f"expected {want}")
    del core
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches_per_steady_tick=DECODE_TICK_LAUNCHES,
                dense_calls_per_tick=0, counts=counts)


def sass_check(libs):
    """cuobjdump -sass of every built library: each of its entry kernels
    (HOPPER_KERNELS) must multiply with HGMMA (wgmma), load with UTMALDG
    (TMA) and hold no HMMA (mma.sync)."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for stem, kernels in HOPPER_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(libs[stem])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = [0, 0, 0]
            elif fn is not None:
                counts[fn][0] += "HGMMA" in line
                counts[fn][1] += "UTMALDG" in line
                counts[fn][2] += "HMMA" in line and "HGMMA" not in line
        for name, args in kernels:
            tag = f"{len(name)}{name}{args}"   # the mangled name
            found = [c for f, c in counts.items() if tag in f]
            if len(found) != 1:
                fail(f"sass: no single {name}{args} in {libs[stem]}")
            hgmma, utmaldg, hmma = found[0]
            print(f"[env] sass {stem} {name}{args}: HGMMA {hgmma} UTMALDG "
                  f"{utmaldg} HMMA {hmma}", flush=True)
            if not hgmma or not utmaldg or hmma:
                fail(f"sass: {name}{args} is not on wgmma + TMA")


def main():
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device; this smoke run needs one GPU",
              flush=True)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    try:
        from owl_audio_exps_tpu_torch.ops import _build
    except ImportError as e:
        print(f"FAILED: the port package is not beside this script ({e})",
              flush=True)
        sys.exit(3)

    # references in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[env] {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    print(f"[env] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.build_dir()}", flush=True)
    sass_check(libs)
    if sys.argv[1:] == ["--packed-fit"]:
        print(json.dumps({"packed_fit": packed_fit_phase(dev)}), flush=True)
        return
    if sys.argv[1:] == ["--mmdit-fit"]:
        print(json.dumps({"mmdit_fit": mmdit_fit_phase(dev)}), flush=True)
        return
    if sys.argv[1:] == ["--decode"]:
        print(json.dumps({"decode": decode_phase(dev)}), flush=True)
        print(f"[env] {card_line()}", flush=True)
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}; usage: chip_smoke.py "
             f"[--packed-fit | --mmdit-fit | --decode]")

    seconds = {}

    def timed(name, fn, *args):
        """fn(*args), its wall seconds kept under ``name`` and printed."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[env] {name} took {seconds[name]:.1f} s", flush=True)
        return out

    fwd_rows = timed("kernel_phase", kernel_phase, dev)
    decode = timed("decode_phase", decode_phase, dev)
    grad_rows = timed("grad_kernel_phase", grad_kernel_phase, dev)
    reset_counts()
    serve_launches, tick_ms, breakdown = timed(
        "pipeline_phase", pipeline_phase, dev, SERVE_TICKS)
    reset_counts()
    sampler_launches = timed("sampler_phase", sampler_phase, dev)
    audio = timed("audio_serve_phase", audio_serve_phase, dev)
    cached = timed("cached_serve_phase", cached_serve_phase, dev, tick_ms)
    train = timed("train_phase", train_phase, dev)
    route = timed("route_phase", route_phase, dev)
    grad_rows.update(timed("k4_phase", k4_phase, dev))
    context = timed("context_phase", context_phase, dev)
    grad_rows.update(timed("band2_phase", band2_phase, dev))
    av = timed("av_train_phase", av_train_phase, dev)
    distill = timed("distill_phase", distill_phase, dev)
    vae = timed("vae_phase", vae_phase, dev)
    packed = timed("packed_phase", packed_phase, dev)
    fwd_rows.update(packed.pop("fwd_rows"))
    grad_rows.update(packed.pop("grad_rows"))
    mmdit = timed("mmdit_phase", mmdit_phase, dev)
    fwd_rows.update(mmdit.pop("fwd_rows"))
    grad_rows.update(mmdit.pop("grad_rows"))
    shard = timed("sharding_phase", sharding_phase, dev)
    fwd_rows.update(shard.pop("fwd_rows"))
    grad_rows.update(shard.pop("grad_rows"))
    s14 = timed("slice14_phase", slice14_phase, dev)
    grad_rows.update(s14.pop("grad_rows"))
    s15 = timed("slice15_phase", slice15_phase, dev, train["step_s"])

    launches = dict(train["totals"])
    launches["frame_attention_fwd"] += serve_launches + sampler_launches
    for name, count in context["counts"].items():
        launches[name] += count
    for row in av.values():
        for name, count in row["totals"].items():
            launches[name] += count
    extra = {"frame_attention_fwd": dict(
        launches_by_path=dict(serve=serve_launches, sampler=sampler_launches,
                              train=train["totals"]["frame_attention_fwd"]),
        serve_tick_ms=tick_ms, serve_tick_device_ms=breakdown)}
    for name in train["per_step"]:
        extra.setdefault(name, {})["launches_per_train_step"] = \
            train["per_step"][name]
        # phases 11 and 13 fail unless every kernel launched 0 times there
        extra[name]["launches_cached_serve"] = cached["port_kernel_launches"]
        extra[name]["launches_vae_phase"] = vae["port_kernel_launches"]
    for name in ("band_attention_fwd", "band_attention_bwd"):
        extra[name]["launches_by_path"] = dict(
            train=train["totals"][name], context=context["counts"][name])
    for name, n in av["AVRFTTrainer"]["per_step"].items():
        if n:
            extra.setdefault(name, {})["launches_per_av_train_step"] = n
    launches["doc_tiles"] = packed["train"]["doc_tile_totals"]
    extra["doc_tiles"] = dict(
        launches_per_packed_train_step=packed["train"]["per_step"][
            "frame_attention_fwd"],
        note="one launch per K1 forward with documents; replaces no TPU "
             "kernel (the splash kernel compares the SegmentIds made at "
             "ops/splash.py:279-295 per element)")
    for name, count in packed["train"]["totals"].items():
        launches[name] += count
        if count:
            extra[name].setdefault("launches_by_path", {})[
                "packed_train"] = count
            extra[name]["launches_per_packed_train_step"] = \
                packed["train"]["per_step"][name]
        # phase 14's MeanFlow steps fail unless every kernel launched 0
        # times there
        extra[name]["launches_meanflow"] = \
            packed["meanflow"]["port_kernel_launches"]
    # phase 15: the MMDiT's training steps and the UViT's step
    for path, row in (("mmdit_v2_train", mmdit["mmdit_v2_train"]),
                      ("mmdit_v1_train", mmdit["mmdit_v1"])):
        for name, count in row["totals"].items():
            launches[name] += count
            if count:
                extra[name].setdefault("launches_by_path", {})[path] = count
                extra[name][f"launches_per_{path}_step"] = \
                    row["per_step"][name]
    for name, count in mmdit["uvit_knobs"]["uvit"]["launches"].items():
        launches[name] += count
        extra[name].setdefault("launches_by_path", {})["uvit_step"] = count
    for name in kernel_counts():
        # phase 15's serves fail unless every kernel launched 0 times
        extra[name]["launches_mmdit_serves"] = 0
    # phase 16: the 5B blocks split over tensor 4, one K1 launch of each
    # kind a rank and layer (checked)
    for name, count in shard["launches"].items():
        launches[name] += count
        if count:
            extra[name].setdefault("launches_by_path", {})[
                "sharded_blocks"] = count
            extra[name]["launches_per_rank_and_layer_sharded_block"] = 1
    # phase 17: the pipe stages in one process (K1, the band) and the AV
    # split at tpf 65 (K4, K5), each launch checked
    s14_launches = s14.pop("launches")
    for name, count in s14_launches.items():
        launches[name] += count
    for path, counts in (
            [(f"pipe_one_process_{k}", row["launches"])
             for k, row in s14["pipe"].items()]
            + [("av_split_tpf65", s14["av_split"]["counts"])]):
        for name, count in counts.items():
            if count:
                extra[name].setdefault("launches_by_path", {})[path] = count
    # phase 18: the warm-started window pipeline and the av_window CLI
    # (K1 forward), the traced and the watched trainers (K1, the band)
    for path, counts in s15.pop("launches_by_path").items():
        for name, count in counts.items():
            launches[name] += count
            if count:
                extra[name].setdefault("launches_by_path", {})[path] = count
    for trainer in ("CausVidTrainer", "SelfForceTrainer",
                    "DistillODETrainer"):
        for name, count in distill[trainer]["totals"].items():
            launches[name] += count
        for kind, counts in distill[trainer]["launches_per_step"].items():
            for name, n in counts.items():
                extra[name].setdefault("launches_per_distill_step", {}) \
                    .setdefault(trainer, {})[kind] = n
    record = {"kernels": kernel_record(fwd_rows, grad_rows, launches, extra),
              "train": {k: v for k, v in train.items()
                        if k not in ("totals", "per_step")},
              "route": route, "context": context, "audio_serve": audio,
              "cached_serve": cached,
              "av_train": {trainer: {k: v for k, v in row.items()
                                     if k not in ("totals", "per_step")}
                           for trainer, row in av.items()},
              "distill": {k: ({n: v for n, v in row.items()
                               if n not in ("totals", "launches_per_step")}
                              if k.endswith("Trainer") else row)
                          for k, row in distill.items()},
              "vae": vae,
              "packed": {k: ({n: v for n, v in row.items()
                              if n not in ("totals", "per_step")}
                             if k == "train" else row)
                         for k, row in packed.items()},
              "phase_seconds": seconds,
              "mmdit": {k: ({n: v for n, v in row.items()
                             if n not in ("totals", "per_step")}
                            if isinstance(row, dict) else row)
                        for k, row in mmdit.items()},
              "sharding": shard, "slice14": s14, "slice15": s15,
              "decode": decode}
    print(json.dumps(record), flush=True)
    print(f"[env] {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
