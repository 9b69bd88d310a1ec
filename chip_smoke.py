#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, one line each (any failure raises and exits non-zero):
  device         the card's name and power limit (nvidia-smi)
  build          nvcc of the hand-written kernels from this checkout
  kernel ...     each CUDA kernel against its plain PyTorch version on the
                 card, with timings and the card's least time for the work
  serve_bf16     Llama-3-8B layer shape at 32 layers, bf16, seeded weights:
                 8 prompts of 16-1024 tokens through the continuous-batching
                 scheduler, 32 new tokens each; launch counts; per-step logits
                 of one request against a no-cache full-forward recompute
  serve_int8     the same engine with an int8 KV pool: two runs over 3 of
                 the 8 prompts (1024, 16 and 209 tokens), 32 new tokens each,
                 equal ids
  telemetry_ab   the host cost of telemetry, request traces and the incident
                 timeline on serve_bf16's path, off and on in turns (A B B A):
                 the decode profile's host step and the scheduler's step
  fleet_parity   the tiny f32 Llama's replica fleet on the card and on the CPU,
                 deterministic algorithms on, one injected clock: a FaultPlan
                 replica kill mid-decode, a hot swap mid-replay, a tiered fleet
                 (int8 decode tier) with migration faults; routing, outcomes,
                 evacuations, migrations and greedy ids equal
  fleet_bf16     bench.py's _build_fleet traffic on serve_bf16's 32-layer model
                 (engines: max_seq 512, block 16, batch 4): 32 Poisson requests
                 replayed on fleets of 1 and 4 replicas, the widest taking a
                 hot swap to a copy of the weights at 30% and a replica kill at
                 60%; then the shared-prefix burst on 2 replicas, untiered
                 against 1 prefill + 1 int8 decode replica, and the tiered run
                 again with migration faults and the decode replica killed;
                 zero lost, only injected failures (each on the timeline),
                 no real error in a replica step or a migration, no migration
                 failure, exact launches, the unswapped replicas' tensors
                 mid-rollout, migrated int8 pages byte-equal to quantize-on-
                 write, ids equal a single engine's but at near-ties (a logit
                 gap within the largest per-logit error a fleet engine shows,
                 twice; a planted wrong token must fail that rule); first, B1
                 and B4 against their plain versions at the fleet's shapes
  qos_bf16       the 2-replica fleet at the same width under one QoSPolicy
                 (two tenants 3:1 with token buckets, bounded queues, the
                 brownout ladder): a burst sheds and climbs the ladder, a tail
                 unwinds it; then create_predictor with llm_replicas=2 and QoS
                 at predictor_f32's size against the single-replica predictor
  predictor_f32  save_llm -> Config -> create_predictor().run() at full width,
                 1 layer, f32: ids equal the no-cache greedy oracle
  train_parity   two tiny Llamas (head_dim 16: the CUDA-core flash kernels;
                 head_dim 64: the tensor-core forward, dq and dk/dv), each
                 built twice from one set of weights, on the card (kernels)
                 and on the CPU (plain versions): 2 AMP-O1 AdamW steps with
                 FLAGS_fused_optimizer and a bf16 moment2 under the same
                 stochastic-rounding seeds;
                 losses, step-1 grads and the params after step 2 agree
  train_bf16     Llama-3-8B layer width at 4 layers, seq 4096, batch 1, AMP
                 O1 bf16, fused AdamW with a bf16 moment2: 5 steps on one
                 batch; losses finite and falling, exact launches per step,
                 ms/step, tokens/s, peak memory, and a profiled 2-step split
  train_recompute bench.py's Llama step as written (_build_llama_at) with
                 recompute=True and micro=2 at 4 layers, seq 4096, train_bf16's
                 optimizer: exact launches a step (the flash forward twice a
                 layer per micro-batch), ms/step, tokens/s, the forward+backward
                 and the optimizer-step peaks beside train_bf16's
  train_fp16_scaler AMP O1 float16 at 4 layers, seq 4096, a GradScaler (2**15,
                 incr every 2, decr every 1), two param groups and an lr scale
                 (three fused AdamW buckets), 8 steps with an inf injected by a
                 grad hook in step 6: skipped steps leave every tensor and
                 @step bit-identical, the scale follows the update rule, the
                 flash kernels run float16 (the wgmma variant)
  train_o2_resume amp.decorate O2 bf16 at 1 layer, seq 4096, LinearWarmup over
                 CosineAnnealingDecay, a GradScaler: 3 steps, paddle.save,
                 everything built anew, paddle.load, 2 steps, against two
                 uninterrupted 5-step runs (their distance is the limit)
  amp_parity     the head_dim-64 tiny Llama on the card and on the CPU, 2 steps
                 each: O1 float16 with a GradScaler, O2 bf16 (decorate), and
                 recompute with 2 micro-batches in O1 bf16
  rms_norm_entry incubate fused_rms_norm, forward and backward, at 4096 x 4096
                 bf16 with an f32 weight: one kernel launch; output and grads
                 against the plain version through autograd
  ernie_parity   two tiny ERNIEs (hidden 256, 4 heads of 64: the tensor-core
                 flash kernels, non-causal) from one set of weights, on the
                 card and on the CPU: 2 AMP-O1 fused-AdamW steps each through
                 to_static on a batch holding the padding id 0; train_parity's
                 limits, the pooler (outside the MLM loss) unmoved
  ernie_seq128   bench.py's headline: ERNIE-3.0-base (vocab 40000, hidden 768,
                 12 layers, ffn 3072) MLM, B64 S128, 12 heads, AMP O1 bf16,
                 fused AdamW with a bf16 moment2, through to_static: 5 steps
                 on one batch; losses, exact launches per step, ms/step,
                 tokens/s, the bench's MFU, peak memory, a profiled split
  ernie_seq4096  the same at bench.py's long shape: B3 (B2 if B3 runs out of
                 memory) S4096, 6 heads of 128, attention dropout 0.1
  resnet_parity  resnet18 (10 classes) built once from one set of weights, on
                 the card and on the CPU, f32 and AMP O1 bf16: 2 Momentum
                 steps (L2Decay, a PiecewiseDecay stepped each step) through
                 to_static on B4 3x64x64; losses, step-1 grads, params and BN
                 buffers, f32 tightly, O1 within the CPU's own bf16 noise
  resnet50_train bench.py's ResNet-50 step (build_resnet_step): batch 64,
                 3x224x224, 1000 classes, 50 layers, Momentum 0.1 wd 1e-4,
                 AMP O1 bf16, through to_static: 2 + 10 timed steps and 4
                 without to_static; losses finite and falling, no hand-written
                 kernel launched (none lies on this path), ms/step, images/s,
                 MFU, peak memory, a profiled split
  ocr_parity     OCRSystem's tiny DBNet(8, 32) and CRNN(11, 32) from one state
                 on the card and on the CPU, f32: DBNet's train maps, db_loss
                 and grads, its eval prob map (the batch norms' buffers);
                 CRNN's logits, CTC loss and grads; the port's CTC gradient
                 against torch's ctc_loss on the card; db_postprocess and
                 ctc_greedy_decode of one numpy input given as a card tensor
  ppocr_e2e      bench.py's PP-OCR (_build_ppocr) on the port: OCRSystem() at
                 its defaults, a 640x640 page and 3 crops of 3x32x100, det and
                 rec through to_static timed by the bench's slope over 8
                 images; device busy and idle share a call by op kind (cuDNN
                 conv, transposed conv, LSTM steps) and the host postprocess;
                 OCRSystem.forward end to end (host crop and resize included)
  ocr_train      DBNet with db_loss at B8 640x640 and CRNN with CTC at B128
                 3x32x100, default widths, 5 Adam steps each: ms/step,
                 images/s, peak memory; every loss and every grad finite
  ppyoloe        the tiny PPYOLOE(4, 8, 32) card against CPU (loss, outputs,
                 grads, decode, infer); PPYOLOE() (80 classes) at B1 640x640:
                 forward, decode and nms ms, nms's n and sweeps, its indices
                 equal to the CPU port's on the same boxes; B8 640x640
                 training with ppyoloe_loss, 5 Adam steps
  op_surface     every row of tests/torch_op_table.py (the CPU tests' parity
                 table: 423 paddle ops and the inplace family) on the card
                 against the port on the CPU, f32 and bf16, gradients for the
                 float rows; random ops' determinism and moments on the card;
                 the widened Tensor methods' torch forms against torch's, and
                 the host microseconds a widened call adds
  ernie_cls_parity a tiny ErnieForSequenceClassification on the card and on
                 the CPU from one state: 2 fine-tune steps on padded batches
                 (mask: the plain attention chain), AMP O1, fused AdamW under
                 LinearWarmup through to_static, then the op-surface eval;
                 ernie_parity's limits
  ernie_finetune BASELINE configs[1]: ErnieForSequenceClassification(
                 ernie_3_0_base(), 2 classes), dropout 0.1, B32 S128 padded
                 batches with an attention_mask, AdamW 2e-5 under LinearWarmup,
                 fused (B5), AMP O1 through to_static: 20 steps over 4 batches,
                 an eval of 4 held-out batches through the op surface; ms/step,
                 tokens/s, MFU, peak memory, a profiled split, exact launches;
                 then 5 unpadded steps without a mask (B1-B3)
  nn_surface     every row of tests/torch_nn_table.py (the nn functionals:
                 activations, common, losses, norms, pools, attention) on the
                 card against the port on the CPU, f32 and bf16, gradients for
                 the float rows; the random layers and functionals drawn again
                 equal after seed() on the card, with their moments
  transformer_parity a tiny nn.Transformer seq2seq (d_model 32, 4 heads, 2+2
                 layers, FFN 64, dropout 0; tests/torch_seq2seq.py) from one
                 set of weights on the card and on the CPU: 2 fused-Adam steps
                 of the label-smoothed loss in AMP O1 bf16 (ernie_parity's
                 limits; each grad also within 1.5x the CPU's own O1-vs-f32
                 distance), then greedy and beam-4 decoding in f32: ids equal
  transformer_base Transformer-base (Vaswani et al. 2017, Table 3 "base": d_model
                 512, 8 heads, 6+6 layers, FFN 2048, dropout 0.1, post-LN) with
                 one 37000 x 512 embedding shared by source, target and the
                 output projection (~63M params), PaddleNLP's recipe: label
                 smoothing 0.1, Adam(0.9, 0.98, 1e-9) under NoamDecay(512,
                 4000, 2.0), fused (B5), AMP O1 bf16; B64, source and target 64,
                 a copy task from seed 0: 10 steps, the eval loss before and
                 after; ms/step, target tokens/s, MFU, peak memory, a profiled
                 split; then beam-4 decoding of 8 sources for up to 114 steps
                 with the decoder's caches (B1 at Sq 1 against the cache);
                 launches of B1-B3 and B5 split into training and decoding,
                 and B1 at the decode shapes against its plain version
  static_llama_capture bench.py's _measure_passes at full width: jit.capture_program
                 of serve_bf16's model (32 layers, bf16, seed 0) over ids [4, 512],
                 the default pass pipeline (pipeline_ms, best of 3), Executor.run
                 with FLAGS_program_passes on and off: bit-identical, the logits
                 against the eager forward within LOGIT_REL_BOUND, fuse_attention
                 32 matches and fuse_norm_matmul 1, B1 exactly 32 launches a run;
                 replay against eager ms, capture and replay peaks
  static_parity  the tiny f32 Llama's capture and 3 static fused-AdamW steps on
                 the card and on the CPU: matches per pass equal, logits and
                 losses within train_parity's limits; the unfused attention
                 chain in f32 at B2 H12 S512 D64, its fuse_attention rewrite
                 (one B1 launch) against the chain under TOL["f32"]
  static_ernie_train ernie_seq128 as a static Program (program_guard, static.data,
                 the MLM loss under auto_cast O1 bf16, AdamW.minimize with
                 FLAGS_fused_optimizer) from build_ernie's weights and batch: 5
                 Executor.run steps against 5 eager to_static steps from the same
                 state, each loss within 1e-3; B1-B3 12 launches a step and B5
                 one; ms/step, tokens/s, MFU, peak memory and idle share beside
                 the eager step's
  deploy_ernie   BASELINE configs[1] deployed as PaddleNLP deploys it: the
                 ernie_finetune classifier (116.76 M) in bf16, eval; jit.save
                 with two [-1, -1] int64 InputSpecs, create_predictor, runs at
                 B32 S128 and B4 S512 (no mask: B1 12 a run), logits against
                 the eager forward; an artifact saved on the CPU run by the
                 Predictor on the card (B1 12 a run); jit.load's TranslatedLayer
                 and a clone once; save/load s, artifact bytes, run ms, peak;
                 the registered flash op's host dispatch cost against the
                 ctypes call, in turns
  deploy_llama_static static_llama_capture's model at 4 layers (the weights
                 travel inside the artifact) captured over ids [-1, 512]:
                 save_inference_model -> load_inference_model -> Executor.run
                 at batch 4 and 2, create_predictor over the same files; B1 4 a
                 run, the graph's B1 nodes equal to fuse_attention's matches,
                 logits against the eager forward within LOGIT_REL_BOUND
  deploy_parity  the tiny f32 Llama (save_inference_model) and ERNIE
                 classifier (jit.save) exported on the card and on the CPU from
                 one set of weights: outputs within TOL["f32"], equal op lists
  static_nn_parity every case of tests/torch_static_nn_table.py (each static.nn
                 builder, the sequence ops, control flow, jit.cond both ways,
                 gradients under capture, Print, the metrics, nce) captured on
                 the CPU and on the card from one set of parameters: floats
                 within TOL["f32"], integers and lengths exact; an EMA too
  static_resnet50_train resnet50_train's step (B64 3x224x224, Momentum 0.1 wd
                 1e-4, O1 bf16) as PaddleClas's static Program: ResNet-50 from
                 static.nn builders (tests/torch_static_resnet.py) with the
                 seed-0 resnet50's weights, CompiledProgram(BuildStrategy()),
                 the loss and accuracy top-1/5 fetched, EMA 0.9999 updated a
                 step: 16 steps (2 warm-up, 5 timed) against the eager
                 model's from the same weights (losses 1e-3 and falling,
                 buffers TOL["bf16"], no hand-written kernel); the eval clone under ema.apply() against eager
                 eval(); ms/step, images/s, MFU, peak, idle share, EMA and
                 eval ms
  guarded_train_bf16 train_bf16's configuration (4 layers at the Llama-3-8B
                 width, S4096, O1 bf16, fused AdamW, bf16 moment2) under
                 FLAGS_check_nan_inf and TrainingGuardian(policy="rollback"),
                 LKG every 2 steps in a ring of 2: 10 steps inside a Profiler
                 record window (export_chrome_tracing) and benchmark(), a
                 FaultPlan NaN in a grad after the first snapshot: the step
                 rolls back, the state equals the snapshot bit for bit (the
                 ported digest, card against CPU too), exact launches (no B5
                 for the rolled-back step), the trace holds B1-B3 and B5,
                 perf_report validates, the counted FLOPs within 10% of the
                 analytic count; plain against guarded step ms in turns, the
                 check's ms beside its byte bound, snapshot, rollback and
                 census ms, the profiler's overhead, MFU, peak
  cold_start     three processes on one compile-cache directory, each from an
                 empty kernel build directory, building serve_bf16's engine
                 (32 layers) and serving one prompt for 4 tokens: cold (nvcc,
                 persist), warm (restore, no nvcc), then one payload byte
                 flipped (a counted CRC rejection, that library rebuilt);
                 equal ids, restored libraries byte-equal to the built ones,
                 each run's `compile_cache report` components summing to its
                 engine-load -> first-token wall within 5%
  vision_parity  MobileNetV1 (x0.25), V2 (x0.35) and V3-Small (x0.5), each
                 built once from seed 5, one train-mode forward and backward
                 at B4 3x96x96 in f32 on the card and on the CPU (the card's
                 relu/relu6/hardswish/hardsigmoid decisions given to the CPU)
                 and on the CPU in f64: logits, loss and every grad within
                 resnet_parity's limits or twice the CPU run's own f32 noise
  input_stream   bench.py's _build_input_stream as written with the port as
                 paddle (4096 samples, B64, 1024 features, MLP 2048, reader
                 work 100,000, 24 steps, seed 7): StreamingLoader prefetch 2
                 (donated) against 0, ms a step, waits, explained fraction,
                 overlap efficiency, verdict, final losses equal; a mid-epoch
                 state_dict restored byte-equal to an unbroken run, every
                 streamed batch byte-equal to its host batch, the donation
                 bound on torch.cuda.memory_allocated
  mobilenetv3_fit PaddleClas's MobileNetV3-Large x1.0 (1000 classes, seed 0)
                 through hapi: Model.prepare(Momentum 0.9 under LinearWarmup
                 over CosineAnnealingDecay, L2Decay, CrossEntropyLoss,
                 Accuracy top-1/5, amp O1).fit for 2 epochs on the DataLoader
                 (1280 synthetic 256x256 images, B64, RandomResizedCrop 224,
                 flip, Normalize, Transpose in 7 spawned persistent workers),
                 evaluate, predict; ms a step, images/s, input wait (mean,
                 p99, share), perf_report's input_pipeline verdict, the
                 device step from memory, idle share, peak, paddle.flops and
                 MFU; Model.save(training=False) + jit.load against the live
                 model; losses finite and falling, no worker initialised CUDA
  (static_ernie_train also runs its 5 steps again with FLAGS_check_nan_inf
  and a compile-cache directory set: losses bit-equal, one ledger miss then
  hits, and a NaN loss scale fed makes the Executor raise GuardianAnomaly
  with a flight-recorder dump)
Kernel checks (phase kernels): flash forward (timed at the Llama shapes and
ERNIE's two), paged attention (decode, extend, int8 and f32 pages, frontiers
on the planned split boundaries, a long single row; every case launched twice
for equal bits; timed as device time through CUDA graphs over a rotation of
pools that exceeds the L2, so the pages are read cold, as the engine's layer
pools are), the flash backward (dq and dk/dv, through autograd of the wrapper,
against the plain backward and against autograd through the plain forward;
every flash case logs the kernel variant it ran, ops.attention.kernel_variant),
the fused AdamW (64M-element buckets; the Llama training bucket and ERNIE's
two, at max positions 512 and 4096, slice by slice; the slices of a bucket past 2^31 elements) and RMSNorm, each
against its plain version; float16 cases of B1-B3 (the Llama S4096 and ERNIE
S128 shapes, dropout, ragged tiles, the CUDA-core head dim) under TOL["fp16"],
timed beside torch's sdpa in float16, and bf16-P (O2) cases of the fused AdamW.
Then a {"kernels": [...]} line (with a row for each float16 flash kernel) and, last, the device line the checker reads.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense: bf16 and fp16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

LLAMA3_8B = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336)
# Depth cut to 4 of 32 (1.135e9 params), as the training slice was set:
# at 32 layers the f32 params, grads and moment1 with a bf16 moment2 alone
# (7.24e9 params x 14 B = 101 GB) exceed one card. The measured peak at 4
# layers (25.03 GB on an H100 80GB) is 22 B a param, the optimizer step's
# flat copies of P and G included: about 14 layers would fit.
TRAIN_LAYERS, TRAIN_SEQ = 4, 4096
TINY_LLAMA = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=176)
# head_dim 64: the bf16 flash forward, dq and dk/dv take their tensor-core
# variants (head_dim 16 above takes the CUDA-core ones)
TINY_LLAMA_D64 = dict(TINY_LLAMA, hidden_size=256, intermediate_size=704)

# Tolerances of kernel vs plain version on the same inputs, per output row
# (one query and head: D values w of the plain version, g of the kernel):
#   each element  |g - w| <= rtol * |w| + atol_rms * rms(w)
#   the row       ||g - w|| <= row * ||w||
# An absolute tolerance scaled by the row's RMS fits attention: p is rounded
# at other points in the two versions, and those errors scale with the
# row's size, not with each element's (an element near 0 by cancellation
# keeps the error of its terms). Set at 1.5-4x the worst error measured on
# an H100 over the cases below (bf16: 0.034 rms and 0.0052 row; int8:
# 0.016 rms and 0.0014 row; f32: 1.2e-5 rms and 1.7e-6 row).
TOL = {
    "f32": dict(rtol=1e-5, atol_rms=5e-5, row=1e-5),
    "bf16": dict(rtol=2e-2, atol_rms=5e-2, row=1e-2),  # rtol: the bf16 output's last bit
    "int8": dict(rtol=1e-2, atol_rms=2.5e-2, row=3e-3),  # int8 pages: p stays f32 on both sides
    # flash backward against the plain backward on the same saved tensors,
    # rows of dq, dk and dv. A gradient row's rounding error scales with its
    # terms, not its sum: the first query of a causal row sees one key and
    # its dq is ~0 by cancellation in both versions. So each row's scale is
    # at least `floor` x the whole tensor's RMS. Worst measured on an H100
    # over the cases below (own-row scale): f32 2.0e-2 of (1e-4, 1e-4) per
    # element and 9.2e-7 per row; bf16 0.20 of the bf16 limits per element
    # and 0.0043 per row.
    "f32_grad": dict(rtol=1e-5, atol_rms=2e-5, row=4e-6, floor=0.1),
    "bf16_grad": dict(rtol=2e-2, atol_rms=5e-2, row=1e-2, floor=0.1),
    # float16 (B1-B3; 3 more mantissa bits than bf16, so p and ds round
    # finer on both sides). Worst measured on an H100 over the fp16 cases:
    # forward elements at 0.185 of (5e-3, 1e-2) and rows 8.0e-4; grads
    # (own-row scale) elements at 0.233 of fp16_grad's and rows 7.8e-4
    "fp16": dict(rtol=4e-3, atol_rms=8e-3, row=2e-3),
    "fp16_grad": dict(rtol=4e-3, atol_rms=5e-3, row=2e-3, floor=0.1),
}


def tol_key(dtype, grad=False) -> str:
    """The TOL entry of a kernel's storage type."""
    key = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    return key + "_grad" if grad else key
# p, m and an f32 v of the fused AdamW against its plain version: one f32
# ulp relative. Both round every operation once in the same order; the
# measured difference on an H100 is 0 (and bf16 moment2 bits 100% equal).
ADAMW_F32_RTOL = 2.0 ** -22
# Flash backward against autograd through the plain forward, as a relative
# Frobenius error per gradient tensor. The kernels (as the JAX kernels)
# take delta = rowsum(dO * O) from the stored O, which in bf16 is rounded:
# that shifts every ds of a row by ~2^-9 |dO||O| whatever the row's size,
# so a row-by-row bound does not fit; autograd rounds neither O nor ds.
# Worst measured on an H100: f32 6.6e-7, bf16 3.7e-3, fp16 5.0e-4.
GRAD_VS_AUTOGRAD_REL = {torch.float32: 3e-6, torch.bfloat16: 1e-2, torch.float16: 2e-3}
LOGIT_REL_BOUND = 5e-2  # ||cached - recomputed|| / ||recomputed|| per step, bf16 over 32 layers


def _kernel_name(mangled: str) -> str:
    """`flash_fwd_tc_kernel<128>` from an Itanium-mangled kernel symbol."""
    # a length prefix may follow other digits (a hash in the namespace)
    for m, cut in ((m, c) for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled)
                   for c in range(m.start(), m.end())):
        n = int(mangled[cut:m.end()])
        name = mangled[m.end():m.end() + n]
        if not name.endswith("_kernel"):
            continue
        rest, args, i = mangled[m.end() + n:], [], 1
        while rest.startswith("I") and i < len(rest) and rest[i] != "E":
            if rest[i] == "L":  # a literal: L<type><value>E
                j = rest.index("E", i)
                args.append(rest[i + 2:j])
                i = j + 1
            elif rest[i].isdigit():  # a named type
                k = re.match(r"\d+", rest[i:]).group()
                t = rest[i + len(k):i + len(k) + int(k)]
                args.append({"__nv_bfloat16": "bf16"}.get(t, t))
                i += len(k) + int(k)
            else:  # a builtin type
                args.append({"f": "float"}.get(rest[i], rest[i]))
                i += 1
        return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_summary(nvcc_log: str) -> list:
    """One line per kernel of `nvcc -Xptxas -v` output (its name and
    template arguments, registers, spills), and ptxas's warnings."""
    out, name, spill = [], "?", "?"
    for ln in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
        elif "(C7" in ln:  # ptxas performance warnings, e.g. serialized wgmma
            fn = re.search(r"function '(\w+)'", ln)
            out.append((f"{_kernel_name(fn.group(1))}: " if fn else "")
                       + ln.split(":", 1)[1].strip()[:120])
    return out


_T0 = time.perf_counter()


_LOGGED = []  # (phase, elapsed_s) of every line: the closing phase_seconds line


def log(phase: str, **fields) -> None:
    """One line a phase; `elapsed_s` is the script's wall time at the line."""
    fields["elapsed_s"] = round(time.perf_counter() - _T0, 1)
    _LOGGED.append((phase.split(" ")[0], fields["elapsed_s"]))
    print(f"{phase}: " + json.dumps(fields, default=float), flush=True)


def phase_seconds() -> dict:
    """Seconds between each phase's lines and the previous phase's, by phase
    (the kernel checks' lines count under `kernel`)."""
    out, prev = {}, 0.0
    for name, t in _LOGGED:
        out[name] = round(out.get(name, 0.0) + t - prev, 1)
        prev = t
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph, replayed `iters` times. For calls of tens of microseconds, whose
    eager time is the host's Python and launch overhead, not the card's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, iters=iters, warmup=1) / reps
    del graph
    return ms


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> dict:
    """Hold `got` to `want` under `tol` (see TOL); raise on a miss."""
    d = want.shape[-1]
    got, want = got.float().reshape(-1, d), want.float().reshape(-1, d)
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rms = rms.clamp_min(tol.get("floor", 0.0) * want.pow(2).mean().sqrt().item())
    elem = (err / (tol["rtol"] * want.abs() + tol["atol_rms"] * rms).clamp_min(1e-30)).max().item()
    row = (err.norm(dim=-1) / (rms.squeeze(-1) * math.sqrt(d)).clamp_min(1e-30)).max().item()
    rec = dict(max_abs_err=err.max().item(), worst_elem_ratio=elem, worst_row_rel_err=row, tol=tol)
    if not (elem <= 1.0 and row <= tol["row"]):
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {rec}")
    return rec


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(ta, gen, name, b, sq, sk, h, hkv, d, dtype, causal, dropout_p=0.0, timed=False):
    """The wrapper the main path calls (flash_attention_bshd_lse, default
    scale, integer seed) against the plain version on the same inputs."""
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d)
    before = ta.LAUNCHES["flash_fwd"]
    got, lse = ta.flash_attention_bshd_lse(q, k, v, causal=causal, dropout_p=dropout_p,
                                           dropout_seed=1234)
    if ta.LAUNCHES["flash_fwd"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the flash kernel exactly once")
    scale = 1.0 / math.sqrt(d)
    want, lse_w = ta._flash_plain(q, k, v, causal, scale, dropout_p, 1234)
    torch.cuda.synchronize()
    rec = dict(case=name, variant=ta.kernel_variant("flash_fwd", dtype, d),
               **compare(name, got, want, TOL[tol_key(dtype)]))
    rec["lse_err"] = (lse - lse_w).abs().max().item()
    if not rec["lse_err"] <= 1e-4:
        raise AssertionError(f"{name}: lse disagrees with the plain version: {rec}")
    if timed:
        # the kernel and its plain version with the case's dropout; the
        # library call (torch's sdpa) without: its dropout is another function
        off = sk - sq
        pairs = b * h * (sum(min(sk, i + 1 + off) for i in range(sq)) if causal else sq * sk)
        flops = 4.0 * pairs * d
        bnd, by = bound_ms(flops, nbytes(q, k, v, got, lse), dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kern = lambda: ta.flash_attention_bshd(q, k, v, causal=causal, dropout_p=dropout_p,
                                               dropout_seed=1234)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                       enable_gqa=True)
        # ms, library_ms: eager calls from Python; *graph_ms: device time
        # through a CUDA graph (a short call's eager time is the host's)
        rec.update(ms=time_ms(kern), graph_ms=time_graph_ms(kern),
                   plain_ms=time_ms(lambda: ta._flash_plain(q, k, v, causal, scale, dropout_p, 1234),
                                    iters=5),
                   library_ms=time_ms(lib), library_graph_ms=time_graph_ms(lib),
                   library_dropout=False, bound_ms=bnd, bound_by=by)
    log("kernel flash_fwd", **rec)
    return rec


def paged_pool(gen, n_pages, bs, hkv, d, dtype):
    rn = lambda: torch.randn(n_pages, bs, hkv, d, generator=gen, device="cuda")
    kp, vp = rn(), rn()
    if dtype == torch.int8:
        from paddle_tpu_torch.quantization.observers import absmax_scale, quantize_absmax

        ks, vs = absmax_scale(kp, dim=-1), absmax_scale(vp, dim=-1)
        return (quantize_absmax(kp, ks[..., None]), quantize_absmax(vp, vs[..., None]),
                dict(k_scales=ks, v_scales=vs))
    return kp.to(dtype), vp.to(dtype), {}


# per-row cache lengths of the paged checks (B = 8): frontiers inside
# pages, a short row, a full row, and last a padded row as the engine pads
# an idle decode slot (one position, a table of the reserved page 0)
PAGED_CTX = [2041, 1500, 777, 17, 2048, 1023, 300, 1]
# the decode profile's shape (profile_decode: B = 8 rows at ~1000 tokens)
PAGED_CTX_UNIFORM = [1000] * 8


def boundary_ctx(ta, kv_dtype=torch.bfloat16) -> list:
    """B = 8 cache lengths whose frontiers (ctx - 1) fall on the split
    boundaries the wrapper plans for pages of `kv_dtype` at the serving
    shape (B 8, H 32/8, D 128, a 128-page table): the last slot of a split,
    the first of the next, and rows that end 1-2 slots past one."""
    plan = ta.paged_split_plan(8, 1, 32, 8, 128, 128, kv_dtype=kv_dtype,
                               sms=ta._sm_count(torch.cuda.current_device()))
    ss = plan["split_pages"] * 16
    return [ss, ss + 1, 2 * ss + 1, 2 * ss, 2048, ss + 2, 1, 2 * ss + 2]


PAGED_L2_BYTES = 50e6  # the H100's L2: a timing that fits in it is warm


def paged_inputs(gen, qn, kv_dtype, qdt=torch.bfloat16, ctx=PAGED_CTX, max_seq=2048):
    """q [B, qn, 32, 128], one pool (k, v, scales) of 16-slot pages, a
    shuffled block table of the engine's width (max_seq / 16 pages: 128 for
    serve_bf16's engine) padded with page 0, and each row's frontiers ending
    at its ctx - 1."""
    h, hkv, d, bs = 32, 8, 128, 16
    b, m = len(ctx), max_seq // bs
    pool = paged_pool(gen, 1 + b * m, bs, hkv, d, qdt if kv_dtype is None else kv_dtype)
    q = torch.randn(b, qn, h, d, generator=gen, device="cuda").to(qdt)
    pages = (torch.randperm(b * m, generator=gen, device="cuda") + 1).reshape(b, m).int()
    ctx_t = torch.tensor(ctx, device="cuda")
    used = (torch.arange(m, device="cuda")[None] * bs < ctx_t[:, None]) & (ctx_t[:, None] > 1)
    bt = torch.where(used, pages, 0).int()  # unused entries padded with page 0
    qpos = (ctx_t[:, None] - qn + torch.arange(qn, device="cuda")[None]).clamp_min(0).int()
    return q, pool, bt, qpos


def paged_kv_bytes(pool, qpos) -> int:
    """K/V bytes a call must read: each row's slots up to its last query's
    position, with their scales for int8 pages."""
    kp, _, sc = pool
    hkv, d = kp.shape[2], kp.shape[3]
    slots = int((qpos.max(dim=1).values + 1).sum())
    return 2 * slots * hkv * d * kp.element_size() + (2 * slots * hkv * 4 if sc else 0)


def cold_pools(gen, pool, qpos) -> list:
    """`pool` and enough more of its shape that the K/V a call touches, over
    the rotation, exceed the L2 twice: each call then reads from HBM, as
    the engine's 32 layer pools are read in turn."""
    kp = pool[0]
    n = max(4, math.ceil(2 * PAGED_L2_BYTES / paged_kv_bytes(pool, qpos)))
    return [pool] + [paged_pool(gen, *kp.shape, kp.dtype) for _ in range(n - 1)]


def rotated(call, pools):
    """A function of no argument that runs call(pool) on the next pool."""
    turn = [0]

    def fn():
        call(pools[turn[0] % len(pools)])
        turn[0] += 1
    return fn


def check_paged(ta, gen, name, qn, kv_dtype, qdt=torch.bfloat16, timed=False, ctx=PAGED_CTX,
                max_seq=2048):
    """The wrapper against the plain version on a shuffled pool, then a
    second launch on the same inputs, which must give the same bits.

    Timed: `ms` is device time through a CUDA graph over a rotation of
    pools with the same tables (cold_pools), so every call reads its pages
    from HBM; `eager_ms` is one call from Python on one pool, its host time
    included."""
    q, pool, bt, qpos = paged_inputs(gen, qn, kv_dtype, qdt, ctx, max_seq)
    kp, vp, sc = pool
    b, _, h, d = q.shape
    plan = ta.paged_split_plan(b, qn, h, kp.shape[2], d, bt.shape[1], kv_dtype=kp.dtype,
                               sms=ta._sm_count(torch.cuda.current_device()))
    before = ta.LAUNCHES["paged_attn"]
    got = ta.flash_decode_paged_multi(q, kp, vp, bt, qpos, **sc)
    if ta.LAUNCHES["paged_attn"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the paged kernel exactly once")
    again = ta.flash_decode_paged_multi(q, kp, vp, bt, qpos, **sc)
    want = ta.paged_extend_reference(q, kp, vp, bt, qpos, **sc)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    tol = TOL["int8" if kv_dtype == torch.int8 else "f32" if qdt == torch.float32 else "bf16"]
    rec = dict(case=name, variant="mma" if ta.paged_uses_mma(kp.dtype, d) else "cuda_core",
               **compare(name, got, want, tol), bit_identical_relaunch=True,
               plan={k: plan[k] for k in ("split_pages", "splits", "rows_per_cta", "row_tiles", "ctas")})
    if timed:
        # each query scores every position up to its own
        kv_bytes = paged_kv_bytes(pool, qpos)
        flops = 4.0 * h * d * float((qpos.long() + 1).sum())
        bnd, by = bound_ms(flops, kv_bytes + nbytes(q, got, bt, qpos), qdt)
        pools = cold_pools(gen, pool, qpos)
        call = lambda pl: ta.flash_decode_paged_multi(q, pl[0], pl[1], bt, qpos, **pl[2])
        rec.update(ms=time_graph_ms(rotated(call, pools), reps=4 * len(pools)),
                   eager_ms=time_ms(lambda: call(pool)),
                   plain_ms=time_ms(lambda: ta.paged_extend_reference(q, kp, vp, bt, qpos, **sc),
                                    iters=5),
                   library_ms=None, bound_ms=bnd, bound_by=by, pools_rotated=len(pools),
                   touched_mb_per_call=kv_bytes / 1e6)
        if rec["ms"] < bnd:
            raise AssertionError(f"{name}: {rec['ms']} ms is under the {bnd} ms bound: a warm timing")
        del pools
    log("kernel paged_attn", **rec)
    return rec


def paged_checks(ta, gen) -> dict:
    """Every paged case; returns the record of the kernels line (the
    decode case at PAGED_CTX, with the timed decode cases by shape)."""
    ctx = "B8 ctx " + "/".join(map(str, PAGED_CTX)) + " bs16"
    edge = {kv: boundary_ctx(ta, kv) for kv in (torch.bfloat16, torch.int8, torch.float32)}
    ectx = {kv: "B8 ctx " + "/".join(map(str, c)) + " bs16 (split boundaries)" for kv, c in edge.items()}
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    paged = [check_paged(ta, gen, f"decode Q1 {ctx} bf16", 1, None, timed=True),
             check_paged(ta, gen, "decode Q1 B8 ctx 1000 bs16 bf16 (the decode profile's shape)",
                         1, None, timed=True, ctx=PAGED_CTX_UNIFORM),
             check_paged(ta, gen, f"decode Q1 {ctx} int8 pages", 1, torch.int8, timed=True),
             check_paged(ta, gen, f"extend Q4 {ctx} bf16", 4, None, timed=True),
             # 160 rows in 10 row tiles of 16: each tile streams its kv head's
             # whole context, so the call reads K/V up to 10 times
             check_paged(ta, gen, f"extend Q40 {ctx} bf16 (rows over CTAs; one split: no merge)",
                         40, None, timed=True)]
    rec = dict(paged[0], by_shape=[
        {k: r[k] for k in ("case", "variant", "ms", "eager_ms", "plain_ms", "bound_ms", "max_abs_err",
                           "plan")}
        for r in paged])
    check_paged(ta, gen, f"decode Q1 {ctx} f32 (predictor)", 1, None, qdt=torch.float32)
    check_paged(ta, gen, f"decode Q1 {ectx[bf]} bf16", 1, None, ctx=edge[bf])
    check_paged(ta, gen, f"extend Q4 {ectx[bf]} bf16 (queries straddle a boundary)", 4, None,
                ctx=edge[bf])
    check_paged(ta, gen, f"extend Q4 {ectx[i8]} int8 pages", 4, i8, ctx=edge[i8])
    check_paged(ta, gen, f"decode Q1 {ectx[f32]} f32", 1, None, qdt=f32, ctx=edge[f32])
    check_paged(ta, gen, "decode Q1 B1 ctx 2048 bs16 bf16 (one long row)", 1, None, ctx=[2048])
    return rec


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_prompts(n=8, seed=0):
    rng = np.random.RandomState(seed)
    # the longest first: it takes the bucketed prefill, the rest stream in
    lens = [1024, 16] + sorted(rng.randint(17, 1024, n - 2).tolist(), reverse=True)
    return [rng.randint(0, LLAMA3_8B["vocab_size"], L).tolist() for L in lens]


def step_logits_error(engine, model, prompt, steps=32):
    """Prefill + (steps-1) decodes of one request through the engine,
    against one no-cache forward of the final sequence: each step's
    ||cached - recomputed|| / ||recomputed||, the steps' argmax agreement,
    and the largest |cached - recomputed| of any one logit."""
    pool = engine.pool
    pool.reset()
    pages = pool.alloc(pool.blocks_for_tokens(len(prompt) + steps))
    rows = [engine.prefill(prompt, pages)]
    seq = list(prompt)
    for _ in range(steps - 1):
        seq.append(int(np.argmax(rows[-1])))
        p = len(seq) - 1
        rows.append(engine.decode([seq[-1]], [p], [p + 1], [pages])[0])
    pool.reset()
    with torch.inference_mode():
        ref = model(torch.tensor([seq], device=engine.device))[0, len(prompt) - 1:].float().cpu().numpy()
    got = np.stack(rows)
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    agree = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
    return [round(float(x), 5) for x in rel], agree, float(np.abs(got - ref).max())


def profile_decode(engine, ctx=1000, steps=8):
    """Where a decode step's time goes: B=8 rows at ~`ctx` tokens of
    context, timed on the host clock without the profiler, then the
    device time of each kernel under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    pool = engine.pool
    pool.reset()
    rows = [pool.alloc(pool.blocks_for_tokens(ctx + 2 * steps + 2)) for _ in range(8)]
    step = lambda p: engine.decode([1] * 8, [p] * 8, [p + 1] * 8, rows)
    step(ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(ctx + 1 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(ctx + 1 + steps + i)
        torch.cuda.synchronize()
    calls = widened_calls(lambda: step(ctx + 1 + 2 * steps))
    pool.reset()
    kind = lambda n: ("paged_attn" if "paged_attn" in n else
                      "matmul" if any(t in n for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
                      else "other")
    by_kind, busy = device_ms_by_kind(prof, kind, steps)
    return dict(context=ctx, batch=8, step_ms=step_ms,
                device_ms_per_step={k: round(v, 4) for k, v in sorted(by_kind.items())},
                device_busy_ms=busy if by_kind else None,
                device_idle_share=(1.0 - busy / step_ms) if by_kind else None,
                widened_calls_per_step=calls)


def _union_us(spans) -> float:
    """Microseconds covered by a list of (start, end) intervals."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (0.0 if hi is None else hi - lo)


def device_ms_by_kind(prof, kind, steps) -> tuple:
    """Device ms a step of each kind of kernel (`kind` maps a lowercase
    kernel name to it) and of all together, as the union of the kernels'
    intervals in the trace: the paged merge kernel is launched as a
    programmatic dependent and overlaps the split kernel it waits for, so
    a sum of durations would count that overlap twice."""
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.setdefault(kind(e.name.lower()), []).append((e.time_range.start, e.time_range.end))
    by_kind = {k: _union_us(v) / 1e3 / steps for k, v in spans.items()}
    return by_kind, _union_us([x for v in spans.values() for x in v]) / 1e3 / steps


def serve_bf16(ptt, ta, state):
    from paddle_tpu_torch.inference import ContinuousBatchingScheduler, InferenceEngine, Request
    from paddle_tpu_torch.inference.scheduler import replay
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(**LLAMA3_8B, device="cuda", dtype="bfloat16").eval()
    engine = InferenceEngine(model, max_seq_len=2048, block_size=16, max_batch=8)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts()
    engine.generate([prompts[1]], max_new_tokens=2)  # warm-up: cuBLAS handles, kernel loads
    engine.pool.reset()

    ta.reset_launch_counts()
    engine.step_counts = dict.fromkeys(engine.step_counts, 0)
    sched = ContinuousBatchingScheduler(engine)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=32) for i, p in enumerate(prompts)]
    stats = replay(sched, reqs)
    torch.cuda.synchronize()
    launches, steps = dict(ta.LAUNCHES), dict(engine.step_counts)
    L = LLAMA3_8B["num_hidden_layers"]
    if not (launches["flash_fwd"] == L * steps["prefill"] > 0
            and launches["paged_attn"] == L * (steps["decode"] + steps["extend"]) > 0):
        raise AssertionError(f"launch counts {launches} do not match steps {steps}")
    ids = [r.prompt[r.prompt_len:] + r.generated for r in reqs]
    if any(len(x) != 32 for x in ids):
        raise AssertionError("a request did not generate 32 tokens")
    engine.pool.reset()
    if engine.generate(prompts, max_new_tokens=32) != ids:
        raise AssertionError("generate() ids differ from the replayed run's")
    rels, agree, elem = step_logits_error(engine, model, prompts[2])
    if not max(rels) <= LOGIT_REL_BOUND:
        raise AssertionError(f"cached vs recomputed logits rel err {max(rels)} > {LOGIT_REL_BOUND}")
    prof = profile_decode(engine)
    state["launches"] = launches
    state["bf16_ids"] = ids
    state["logit_elem_err"] = elem
    log("serve_bf16", layers=L, weights_gb=sum(nbytes(p) for p in model.parameters()) / 1e9,
        init_s=init_s, prompt_lens=[len(p) for p in prompts], tokens_per_sec=stats["tokens_per_sec"],
        wall_s=stats["wall_s"], p50_ttft_ms=stats["p50_ttft_ms"], p99_ttft_ms=stats["p99_ttft_ms"],
        p50_tpot_ms=stats["p50_tpot_ms"], p99_tpot_ms=stats["p99_tpot_ms"], steps=steps,
        launches=launches, step_logits_rel_err=rels, rel_err_bound=LOGIT_REL_BOUND,
        step_logits_max_abs_err=elem, step_argmax_agreement=agree, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("serve_bf16 decode profile", **prof)
    return model


# the int8 runs serve 3 of serve_bf16's 8 prompts (cut for the script's time
# limit): the 1024-token one (the bucketed prefill), the 16- and the
# 209-token ones (streamed in); the other prompts only lengthen the streaming
# (~850 host-bound steps a run against ~240). Each run is held as before:
# equal ids, paged launches, agreement with serve_bf16's ids
SERVE_INT8_PROMPTS = (0, 1, 7)


def serve_int8(ta, model, state):
    from paddle_tpu_torch.inference import InferenceEngine

    engine = InferenceEngine(model, max_seq_len=2048, block_size=16, max_batch=8, kv_dtype="int8")
    prompts = [serve_prompts()[i] for i in SERVE_INT8_PROMPTS]
    ta.reset_launch_counts()
    t0 = time.perf_counter()
    first = engine.generate(prompts, max_new_tokens=32)
    wall = time.perf_counter() - t0
    paged = ta.LAUNCHES["paged_attn"]
    engine.pool.reset()
    second = engine.generate(prompts, max_new_tokens=32)
    if first != second:
        raise AssertionError("int8 KV serving is not deterministic across two runs")
    if paged <= 0:
        raise AssertionError("int8 serving launched no paged kernel")
    bf16 = [state["bf16_ids"][i] for i in SERVE_INT8_PROMPTS]
    same = np.mean([a == b for x, y in zip(first, bf16) for a, b in zip(x, y)])
    log("serve_int8", prompt_lens=[len(p) for p in prompts], identical_runs=True, wall_s=wall,
        paged_launches=paged,
        pool_gb=engine.pool.pool_bytes() / 1e9, token_agreement_with_bf16=float(same))


def predictor_f32(ptt):
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.seed(1)
    cfg = dict(LLAMA3_8B, num_hidden_layers=1)
    model = LlamaForCausalLM(**cfg, device="cuda", dtype="float32").eval()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        prefix = inf.save_llm(model, os.path.join(tmp, "llama3_8b_1layer"))
        config = inf.Config(prefix)
        config.enable_llm_engine(max_new_tokens=8, max_seq_len=256, block_size=16, max_batch=4)
        pred = inf.create_predictor(config)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rng = np.random.RandomState(2)
    lens = [5, 17, 33, 64]
    ids = np.zeros((4, max(lens)), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, cfg["vocab_size"], n)
    pred.get_input_handle("input_ids").copy_from_cpu(ids)
    pred.get_input_handle("seq_lens").copy_from_cpu(np.asarray(lens))
    pred.run()
    got = pred.get_output_handle("generated_ids").copy_to_cpu()
    for i, n in enumerate(lens):
        cur = ids[i, :n].tolist()
        for _ in range(8):  # the saved weights are exactly `model`'s (f32 round trip)
            with torch.inference_mode():
                cur.append(int(model(torch.tensor([cur], device="cuda"))[0, -1].argmax()))
        if got[i].tolist() != cur[n:]:
            raise AssertionError(f"predictor ids {got[i].tolist()} != oracle {cur[n:]}")
    log("predictor_f32", prompts=len(lens), new_tokens=8, ids_equal_oracle=True)


# ---------------------------------------------------------------------------
# serving fleet: telemetry, fault injection, QoS, replicas, prefill/decode tiers
# ---------------------------------------------------------------------------

FLEET_ENGINE = dict(max_seq_len=512, block_size=16, max_batch=4, decode_batch_buckets=(4,))
FLEET_SLO = dict(slo_ttft_ms=1000.0, slo_tpot_ms=200.0)  # bench.py's BENCH_FLEET_SLO_* defaults


def fleet_traffic(vocab, n=32, seed=13, gap_s=0.002, max_seq=512):
    """bench.py's _build_fleet traffic: seeded Poisson arrivals, prompts of
    4 to max_seq/4 - 1 tokens, max_new from {4, 8, 16, max_seq/4}."""
    from paddle_tpu_torch.inference import Request

    rng = np.random.RandomState(seed)
    max_prompt, gen_mix = max(8, max_seq // 4), [4, 8, 16, max(24, max_seq // 4)]
    reqs, t = [], 0.0
    for i in range(n):
        t += rng.exponential(gap_s)
        reqs.append(Request(
            rid=i, prompt=rng.randint(0, vocab, (int(rng.randint(4, max_prompt)),)).tolist(),
            max_new_tokens=int(rng.choice(gen_mix, p=[0.25, 0.3, 0.25, 0.2])), arrival_time=t))
    return reqs


def burst_traffic(vocab, n=16, seed=14, gap_s=0.0005, prefix_pages=2, block=16):
    """bench.py's burst A/B traffic: a shared prefix of `prefix_pages` full
    pages plus 2-5 tokens each, max_new from {4, 8, 12}."""
    from paddle_tpu_torch.inference import Request

    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, (prefix_pages * block,)).tolist()
    reqs, t = [], 0.0
    for i in range(n):
        t += rng.exponential(gap_s)
        reqs.append(Request(rid=i, prompt=shared + rng.randint(0, vocab, (int(rng.randint(2, 6)),)).tolist(),
                            max_new_tokens=int(rng.choice([4, 8, 12])), arrival_time=t))
    return reqs


def hit_rate(fleet) -> float:
    """bench.py's hit rate: the fraction of completed requests' prompt tokens
    served from shared pages (capped at each prompt)."""
    done = [r for r in fleet.finished if r.outcome == "completed"]
    return round(sum(min(r.cached_tokens, r.prompt_len) for r in done)
                 / max(1, sum(r.prompt_len for r in done)), 4)


def spy_real_errors(fleet) -> list:
    """Record every real exception the fleet would otherwise absorb: one a
    replica's scheduler step raises before the breaker counts it as a
    replica failure (injected step faults raise at the step's fault point,
    outside the scheduler), and one a KV migration raises before the fleet
    falls back to recompute (an injected migration fault is a FaultInjected;
    anything else, a card error in export, convert or import included, is
    real)."""
    from paddle_tpu_torch.distributed.resilience.fault_injection import FaultInjected

    errors = []

    def spied(orig, **where):
        def call(*a, **k):
            try:
                return orig(*a, **k)
            except Exception as e:
                if not isinstance(e, FaultInjected):
                    import traceback

                    errors.append(dict(where, error=type(e).__name__,
                                       trace=traceback.format_exc()[-1500:]))
                raise
        return call
    for rep in fleet.replicas:
        rep.sched.step = spied(rep.sched.step, replica=rep.idx)
    fleet._migrate_request = spied(fleet._migrate_request, migration=True)
    return errors


def injected_faults(tl, prefix) -> list:
    return [r["labels"]["site"] for r in tl.recorder().records()
            if r["kind"] == "fault.injected" and r["labels"]["site"].startswith(prefix)]


def hold_fleet_run(name, stats, fleet, tl, errors) -> dict:
    """The checks every fleet run takes: no request lost or duplicated, no
    real error in a replica step or a migration, no replica failure and no
    migration fallback but the injected ones, no migration failure, every
    injection observed on the timeline, no timeline event evicted, every
    completed request at its full budget. Returns the run's fault
    accounting."""
    step_faults = injected_faults(tl, "fleet.replica_step.")
    migrate_faults = injected_faults(tl, "fleet.kv_migrate.")
    failures = [r for r in tl.recorder().records() if r["kind"] == "replica.failure"]
    cov = tl.chaos_coverage()
    bad = []
    if errors:
        bad.append(f"real errors in replica steps or migrations: {errors}")
    if stats["lost"] or stats["duplicated"]:
        bad.append(f"lost {stats['lost']} duplicated {stats['duplicated']}")
    if stats["replica_failures"] != len(step_faults) or len(failures) != len(step_faults):
        bad.append(f"replica_failures {stats['replica_failures']} != injected step faults "
                   f"{len(step_faults)}")
    if fleet.migration_failures or fleet.migration_fallbacks != len(migrate_faults):
        bad.append(f"migration failures {fleet.migration_failures}, fallbacks "
                   f"{fleet.migration_fallbacks} != injected migration faults {len(migrate_faults)}")
    if cov["unobserved_faults"] or tl.dropped():
        bad.append(f"unobserved faults {cov['unobserved_faults']}, dropped {tl.dropped()}")
    for r in fleet.finished:  # a capped request's budget is its cap
        got = len(r.prompt) - r.prompt_len + len(r.generated)
        if r.outcome == "completed" and got != r.max_new_tokens:
            bad.append(f"request {r.rid} generated {got} of {r.max_new_tokens}")
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    return dict(injected=cov["injected"], step_faults=len(step_faults),
                migrate_faults=len(migrate_faults))


def fleet_ids(fleet) -> dict:
    return {r.rid: r.prompt[r.prompt_len:] + list(r.generated)
            for r in fleet.finished if r.outcome == "completed"}


def parting(model, prompts: dict, got: dict, want: dict, device, bound: float) -> list:
    """Requests whose ids part from the oracle's: at the first step where they
    part, the gap between the two tokens' logits in a no-cache forward of the
    common prefix. A tie when the gap is at most `bound` (near_tie_rule):
    where both runs' logits lie within E of that forward's, each run's
    choice puts the gap within 2E, so batch makeup can flip it."""
    out = []
    for rid, g in got.items():
        w = want[rid]
        if g == w[:len(g)]:
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        with torch.inference_mode():
            ref = model(torch.tensor([prompts[rid] + g[:j]], device=device))[0, -1].float()
        gap = abs(float(ref[g[j]] - ref[w[j]]))
        norm = float(ref.norm())
        out.append(dict(rid=rid, step=j, gap=gap, gap_over_rms=gap / (norm / math.sqrt(ref.numel())),
                        tie=gap <= bound))
    return out


def near_tie_rule(model, state) -> dict:
    """The parting rule's bounds. E is the largest |cached - recomputed| of
    any one logit over 32 steps of one request: measured on a bf16 fleet
    engine (decode bucket 4), on an int8-KV one, on the oracle's engine
    (decode bucket 8) and by serve_bf16 (decode bucket 1); E_bf16 is the
    largest of the bf16 ones. The oracle runs bf16, so a run whose requests
    decode on bf16 pages is held to 2 E_bf16 and one with an int8 decode
    tier to E_int8 + E_bf16 (at least 2 E_bf16). Then a planted wrong token (seeded,
    at the first generated step) must fail the wider bound: a rule that no
    wrong token fails checks nothing."""
    from paddle_tpu_torch.inference import InferenceEngine

    if "tie_rule" in state:
        return state["tie_rule"]
    vocab, dev = model.config["vocab_size"], next(model.parameters()).device
    prompt = max((r.prompt for r in fleet_traffic(vocab)), key=len)
    errs, rel = {}, {}
    for name, kw in (("bfloat16", FLEET_ENGINE), ("int8", dict(FLEET_ENGINE, kv_dtype="int8")),
                     ("oracle", dict(FLEET_ENGINE, max_batch=8, decode_batch_buckets=(8,)))):
        eng = InferenceEngine(model, **kw)
        rels, _, errs[name] = step_logits_error(eng, model, prompt)
        rel[name] = max(rels)
        del eng
    if max(rel["bfloat16"], rel["oracle"]) > LOGIT_REL_BOUND:
        raise AssertionError(f"fleet engines: cached vs recomputed logits rel err {rel} > "
                             f"{LOGIT_REL_BOUND}")
    e_bf16 = max(errs["bfloat16"], errs["oracle"], state.get("logit_elem_err", 0.0))
    bound = dict(bf16=2.0 * e_bf16, int8=max(2.0 * e_bf16, errs["int8"] + e_bf16))
    with torch.inference_mode():
        want = int(model(torch.tensor([prompt], device=dev))[0, -1].argmax())
    rng = np.random.RandomState(31)
    bad = int(rng.randint(0, vocab))
    while bad == want:
        bad = int(rng.randint(0, vocab))
    (planted,) = parting(model, {0: prompt}, {0: [bad]}, {0: [want]}, dev, bound["int8"])
    if planted["tie"]:
        raise AssertionError(f"the near-tie rule passes a planted wrong token: {planted}, "
                             f"bounds {bound}")
    state["tie_rule"] = dict(bound=bound, max_abs_logit_err=dict(
        errs, serve_bf16=state.get("logit_elem_err")), engine_rel_err=rel, planted=planted)
    return state["tie_rule"]


def fleet_kernel_checks(ta) -> list:
    """B1 and B4 against their plain versions at the shapes the fleet path
    gives them: every prefill bucket of FLEET_ENGINE (B1 H32/8 D128 bf16
    causal), and a decode step of the 4-row bucket over a 32-page table (a
    full 512-token row, two partial rows, an idle slot) on bf16 and int8
    pages. These launches are not counted: every fleet run sets the counts
    to 0 before it."""
    from paddle_tpu_torch.inference.engine import _default_prefill_buckets

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf, seq, bs = torch.bfloat16, FLEET_ENGINE["max_seq_len"], FLEET_ENGINE["block_size"]
    recs = [check_flash(ta, gen, f"bf16 causal B1 S{s} H32/8 D128 (fleet prefill bucket)", 1, s, s,
                        32, 8, 128, bf, True)
            for s in _default_prefill_buckets(seq, bs)]
    ctx = [seq, 300, 17, 1]
    for kv, note in ((None, "bf16"), (torch.int8, "int8 pages")):
        recs.append(check_paged(ta, gen, f"decode Q1 B4 ctx {'/'.join(map(str, ctx))} bs{bs} "
                                f"{note} (fleet decode)", 1, kv, ctx=ctx, max_seq=seq))
    return [{k: r[k] for k in ("case", "max_abs_err")} for r in recs]


def counted_run(ta, engines, run):
    """Drive `run()` with every launch and step count at 0 first; return its
    result, the launches and the steps summed over `engines`, and check the
    launches are exact: the flash kernel once a layer a prefill, the paged
    kernel once a layer a decode or extend step."""
    ta.reset_launch_counts()
    for e in engines:
        e.step_counts = dict.fromkeys(e.step_counts, 0)
    out = run()
    torch.cuda.synchronize()
    launches = dict(ta.LAUNCHES)
    steps = {k: sum(e.step_counts[k] for e in engines) for k in engines[0].step_counts}
    L = engines[0].num_layers
    if not (launches["flash_fwd"] == L * steps["prefill"]
            and launches["paged_attn"] == L * (steps["decode"] + steps["extend"])):
        raise AssertionError(f"fleet launches {launches} do not match steps {steps} x {L} layers")
    return out, launches, steps


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        if v:
            total[k] = total.get(k, 0) + v


def fleet_parity_runs(ptt, model, clock_step=0.0005):
    """The three fleet scenarios on `model` (on `dev`): a replica kill mid-
    decode, a hot swap mid-replay and a tiered fleet (int8 decode tier) with
    a migration fault, each on an injected clock. Returns per scenario the
    decisions, ids, migration CRCs and the engines."""
    from paddle_tpu_torch.distributed.resilience import fault_injection as fi
    from paddle_tpu_torch.inference import InferenceEngine, ReplicaFleet, Request, fleet_replay
    from paddle_tpu_torch.inference import kv_cache as kvc

    vocab = model.config["vocab_size"]
    engine = dict(max_seq_len=64, block_size=8, max_batch=4, decode_batch_buckets=(4,))

    def clock():
        t = [0.0]

        def tick():
            t[0] += clock_step
            return t[0]
        return tick

    def reqs():
        rng = np.random.RandomState(21)
        out, t = [], 0.0
        for i in range(12):
            t += rng.exponential(0.002)
            out.append(Request(rid=i, prompt=rng.randint(0, vocab, (int(rng.randint(3, 20)),)).tolist(),
                               max_new_tokens=int(rng.choice([3, 8, 16])), arrival_time=t))
        return out

    crcs = []
    real_crcs = kvc.payload_page_crcs

    def recording_crcs(payload):
        out = real_crcs(payload)
        crcs.append(out)
        return out

    def record(fleet):
        return dict(
            requests=[(r.rid, r.outcome, r.preemptions, r.cached_tokens, r.first_token_time,
                       r.finish_time) for r in fleet.finished],
            ids=fleet_ids(fleet), evacuated=fleet.evacuated_total, failures=fleet.failures_total,
            swaps=fleet.swaps_completed, migrations=fleet.migrations_total,
            fallbacks=fleet.migration_fallbacks, crc_rejects=fleet.migration_crc_rejects,
            mode=fleet.mode(), status=[r.status for r in fleet.replicas],
            versions=[r.engine.weights_version for r in fleet.replicas],
            routes=sorted((s["labels"]["reason"], s["value"]) for s in ptt.telemetry.default_registry().collect()
                          if s["name"] == "paddle_tpu_fleet_routed_total"))

    swap_state = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    kvc.payload_page_crcs = recording_crcs
    try:
        for name in ("kill_mid_decode", "swap_mid_replay", "tiered_migration_fault"):
            ptt.telemetry.default_registry().unregister("paddle_tpu_fleet_routed_total")
            crcs.clear()
            fi.clear_plan()
            if name == "tiered_migration_fault":
                engines = [InferenceEngine(model, **engine),
                           InferenceEngine(model, kv_dtype="int8", **engine)]
                fleet = ReplicaFleet(engines, clock=clock(), tiers=("prefill", "decode"))
                fi.install_plan(fi.FaultPlan().add("fleet.kv_migrate.*", "fail", times=2))
                events = []
            else:
                engines = [InferenceEngine(model, **engine) for _ in range(2)]
                fleet = ReplicaFleet(engines, clock=clock())
                if name == "kill_mid_decode":
                    events = [(3, lambda: fi.install_plan(
                        fi.FaultPlan().add("fleet.replica_step.1", "fail", times=2)))]
                else:
                    events = [(3, lambda f=fleet: f.request_swap(swap_state))]
            try:
                fleet_replay(fleet, reqs(), events=events)
            finally:
                fi.clear_plan()
            out[name] = dict(record(fleet), crcs=list(crcs), engines=engines)
    finally:
        kvc.payload_page_crcs = real_crcs
    return out


def fleet_parity(ptt, ta, state, card="cuda"):
    """The tiny f32 Llama's fleet on the card (kernels) and on the CPU
    (plain versions), deterministic algorithms on, the same clock and
    FaultPlans: decisions and greedy ids equal."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.filterwarnings("ignore", message=".*deterministic.*")
    try:
        ptt.seed(3)
        cpu = LlamaForCausalLM(**TINY_LLAMA, device="cpu", dtype="float32").eval()
        model = LlamaForCausalLM(**TINY_LLAMA, device="meta", dtype="float32")
        model.load_state_dict({k: v.to(card) for k, v in cpu.state_dict().items()}, assign=True)
        model.eval()
        ta.reset_launch_counts()
        got = fleet_parity_runs(ptt, model)
        torch.cuda.synchronize()
        launches = dict(ta.LAUNCHES)
        want = fleet_parity_runs(ptt, cpu)
    finally:
        torch.use_deterministic_algorithms(det)
    steps = {}
    for rec in got.values():
        for e in rec["engines"]:
            for k, v in e.step_counts.items():
                steps[k] = steps.get(k, 0) + v
    L = TINY_LLAMA["num_hidden_layers"]
    if not (launches["flash_fwd"] == L * steps["prefill"] > 0
            and launches["paged_attn"] == L * (steps["decode"] + steps["extend"]) > 0):
        raise AssertionError(f"fleet_parity: launches {launches} do not match steps {steps}")
    keys = ("requests", "ids", "evacuated", "failures", "swaps", "migrations", "fallbacks",
            "crc_rejects", "mode", "status", "versions", "routes")
    summary = {}
    for name, g in got.items():
        w = want[name]
        diff = [k for k in keys if g[k] != w[k]]
        if diff:
            raise AssertionError(f"fleet_parity {name}: card and CPU differ in {diff}: "
                                 f"{ {k: (g[k], w[k]) for k in diff} }")
        # every migration's sender CRCs equal its readback's on each device
        for dev, rec in (("card", g), ("cpu", w)):
            pairs = list(zip(rec["crcs"][0::2], rec["crcs"][1::2]))
            if any(a != b for a, b in pairs):
                raise AssertionError(f"fleet_parity {name}: a {dev} migration's readback CRC differs")
        page_crcs = [c for pair in g["crcs"][0::2] for c in pair]
        cpu_crcs = [c for pair in w["crcs"][0::2] for c in pair]
        summary[name] = dict(
            evacuated=g["evacuated"], failures=g["failures"], swaps=g["swaps"],
            migrations=g["migrations"], fallbacks=g["fallbacks"], mode=g["mode"],
            routes=g["routes"], migrated_pages=len(page_crcs),
            page_crcs_equal_to_cpu=sum(a == b for a, b in zip(page_crcs, cpu_crcs)),
            tokens=sum(len(v) for v in g["ids"].values()))
    if got["kill_mid_decode"]["evacuated"] == 0 or got["tiered_migration_fault"]["fallbacks"] != 2 \
            or got["swap_mid_replay"]["swaps"] != 1:
        raise AssertionError(f"fleet_parity: a scenario missed its path: {summary}")
    state["fleet_parity_launches"] = launches
    log("fleet_parity", layers=L, head_dim=TINY_LLAMA["hidden_size"] // TINY_LLAMA["num_attention_heads"],
        decisions_and_ids_equal=True, launches=launches, steps=steps, scenarios=summary)


def fleet_bf16(ptt, ta, model, state, widths=(1, 4)):
    """bench.py's _build_fleet at Llama-3-8B width on the card (see the
    module docstring)."""
    from paddle_tpu_torch.distributed.resilience import fault_injection as fi
    from paddle_tpu_torch.inference import InferenceEngine, ReplicaFleet, fleet_replay
    from paddle_tpu_torch.inference import kv_cache as kvc
    from paddle_tpu_torch.telemetry import request_trace as rt
    from paddle_tpu_torch.telemetry import timeline as tl

    vocab, dev = model.config["vocab_size"], next(model.parameters()).device

    def fresh_engine(kv_dtype=None):
        eng = InferenceEngine(model, kv_dtype=kv_dtype, **FLEET_ENGINE)
        eng.prewarm()  # every bucket once: cuBLAS handles and kernel loads off the replay
        return eng

    kernel_cases = fleet_kernel_checks(ta)
    tie = near_tie_rule(model, state)
    ptt.set_flags({"FLAGS_incident_timeline": True})
    total_launches, per_width, slo, runs = {}, {}, {}, {}
    captured = MigrationCapture()
    try:
        # the single-engine oracle of every prompt (no fleet)
        oracle_eng = InferenceEngine(model, **dict(FLEET_ENGINE, max_batch=8,
                                                   decode_batch_buckets=(8,)))
        traffic = {r.rid: r for r in fleet_traffic(vocab)}
        oracle = dict(zip(traffic, oracle_eng.generate(
            [r.prompt for r in traffic.values()], [r.max_new_tokens for r in traffic.values()])))
        del oracle_eng
        widest = max(widths)
        model_sum = weights_checksum(model.state_dict(keep_vars=True))
        for n in widths:
            tl.reset()
            engines = [fresh_engine() for _ in range(n)]
            fleet = ReplicaFleet(engines)
            errors = spy_real_errors(fleet)
            events, split = [], {}
            chaos = n == widest
            if chaos:
                copy = {k: v.detach().clone() for k, v in model.state_dict().items()}
                events.append((max(1, int(0.3 * 32)), lambda f=fleet: f.request_swap(copy)))
                if n > 1:
                    events.append((max(2, int(0.6 * 32)), lambda idx=n - 1: fi.install_plan(
                        fi.FaultPlan().add(f"fleet.replica_step.{idx}", "fail", times=2))))
                ptt.telemetry.default_registry().unregister("paddle_tpu_fleet_weights_version")
                watch_rollout(fleet, model, model_sum, split)
                rt.reset()
                ptt.set_flags({"FLAGS_request_trace": True})
            gc.collect()
            try:
                stats, launches, steps = counted_run(
                    ta, engines, lambda: fleet_replay(fleet, fleet_traffic(vocab), events=events))
            finally:
                fi.clear_plan()
                if chaos:
                    ptt.set_flags({"FLAGS_request_trace": False})
            faults = hold_fleet_run(f"fleet_bf16 width {n}", stats, fleet, tl, errors)
            add_launches(total_launches, launches)
            ids = fleet_ids(fleet)
            parts = parting(model, {k: r.prompt for k, r in traffic.items()}, ids, oracle, dev,
                            tie["bound"]["bf16"])
            if not all(p["tie"] for p in parts):
                raise AssertionError(f"fleet_bf16 width {n}: ids part from the oracle off a tie: "
                                     f"{[p for p in parts if not p['tie']]}")
            if chaos:
                slo[f"width_{n}"] = rt.slo_breakdown(**FLEET_SLO)
                if stats["swaps_completed"] != 1 or (n > 1 and not split):
                    raise AssertionError(f"fleet_bf16: the rollout did not run as asked "
                                         f"({stats['swaps_completed']} swaps, split {split})")
            events = copy = None  # the swap's weight copy goes with the run
            per_width[str(n)] = dict(
                {k: stats.get(k) for k in ("tokens_per_sec", "p50_ttft_ms", "p99_ttft_ms",
                                            "p50_tpot_ms", "p99_tpot_ms", "completed", "evacuated",
                                            "replica_failures", "preempted", "swaps_completed",
                                            "p99_tpot_swap_ms", "wall_s", "generated_tokens")},
                steps=steps, steps_by_replica=[sum(e.step_counts.values()) for e in engines],
                launches=launches, injected_step_faults=faults["step_faults"],
                parted=len(parts), parting=parts[:4], rollout_split=split or None)
            del fleet, engines
        # ---- the burst A/B: untiered 2 replicas against 1 prefill + 1 int8 decode ----
        burst = {r.rid: r for r in burst_traffic(vocab)}
        oracle_eng = InferenceEngine(model, **dict(FLEET_ENGINE, max_batch=8,
                                                   decode_batch_buckets=(8,)))
        burst_oracle = dict(zip(burst, oracle_eng.generate(
            [r.prompt for r in burst.values()], [r.max_new_tokens for r in burst.values()])))
        del oracle_eng
        for name in ("untiered", "tiered", "tiered_chaos"):
            tl.reset()
            if name == "untiered":
                engines = [fresh_engine(), fresh_engine()]
                fleet = ReplicaFleet(engines, prefix_owner_cache_size=1)
            else:
                engines = [fresh_engine(), fresh_engine("int8")]
                fleet = ReplicaFleet(engines, tiers=("prefill", "decode"))
                fleet.prewarm()
                captured.attach(fleet, on=(name == "tiered"))
            errors = spy_real_errors(fleet)
            events = []
            if name == "tiered_chaos":
                events = [(max(1, int(0.25 * 16)), lambda: fi.install_plan(
                              fi.FaultPlan().add("fleet.kv_migrate.*", "fail", times=2))),
                          (max(2, int(0.6 * 16)), lambda: fi.install_plan(
                              fi.FaultPlan().add("fleet.replica_step.1", "fail", times=2)))]
                rt.reset()
                ptt.set_flags({"FLAGS_request_trace": True})
            gc.collect()
            try:
                stats, launches, steps = counted_run(
                    ta, engines, lambda: fleet_replay(fleet, burst_traffic(vocab), events=events))
            finally:
                fi.clear_plan()
                if name == "tiered_chaos":
                    ptt.set_flags({"FLAGS_request_trace": False})
            faults = hold_fleet_run(f"fleet_bf16 burst {name}", stats, fleet, tl, errors)
            add_launches(total_launches, launches)
            ids = fleet_ids(fleet)
            parts = parting(model, {k: r.prompt for k, r in burst.items()}, ids, burst_oracle, dev,
                            tie["bound"]["bf16" if name == "untiered" else "int8"])
            if not all(p["tie"] for p in parts):
                raise AssertionError(f"fleet_bf16 burst {name}: ids part from the oracle off a "
                                     f"tie: {[p for p in parts if not p['tie']]}")
            if name == "tiered_chaos":
                slo["burst_tiered_chaos"] = rt.slo_breakdown(**FLEET_SLO)
            runs[name] = dict(
                {k: stats.get(k) for k in ("p50_ttft_ms", "p99_ttft_ms", "p50_tpot_ms",
                                            "p99_tpot_ms", "tokens_per_sec", "completed",
                                            "migrations", "migration_fallbacks",
                                            "migration_failures", "migration_deferred",
                                            "crc_rejects", "prefix_routed", "evacuated",
                                            "replica_failures", "wall_s")},
                hit_rate=hit_rate(fleet), mode=fleet.mode(), steps=steps, launches=launches,
                injected_faults=faults["injected"], parted=len(parts), parting=parts[:4],
                migration_ms_per_page=(fleet.migration_wall_s * 1e3 / fleet.migrated_pages_total
                                       if fleet.migrated_pages_total else None),
                migrated_pages=fleet.migrated_pages_total)
            if name == "tiered":
                check_int8_migration(model, burst, captured)
                runs[name]["int8_pages_equal_quantize_on_write"] = captured.checked
            del fleet, engines
    finally:
        captured.detach()
        ptt.set_flags({"FLAGS_incident_timeline": False})
        gc.collect()
        torch.cuda.empty_cache()
    t = runs["tiered"]
    if t["migration_failures"] or t["hit_rate"] < runs["untiered"]["hit_rate"]:
        raise AssertionError(f"fleet_bf16: the clean tiered run failed migrations or lost hits: "
                             f"{t}, untiered hit rate {runs['untiered']['hit_rate']}")
    if runs["tiered_chaos"]["migration_fallbacks"] < 1 or runs["tiered_chaos"]["mode"] != "monolithic":
        raise AssertionError(f"fleet_bf16: the chaos run missed its faults: {runs['tiered_chaos']}")
    state["fleet_launches"] = total_launches
    log("fleet_bf16", layers=model.config["num_hidden_layers"], engine=FLEET_ENGINE,
        widths=per_width, note="the replicas share one card and step one after another: a "
        "wider fleet interleaves host work, it adds no device", launches=total_launches,
        near_tie_rule=tie, kernels_at_fleet_shapes=kernel_cases)
    log("fleet_bf16 burst", **runs)
    log("fleet_bf16 slo_breakdown", **slo)


def weights_checksum(params: dict) -> float:
    """One number over every tensor (float64 sum of per-tensor f32 sums)."""
    with torch.no_grad():
        return float(torch.stack([p.detach().float().sum() for p in params.values()]).double().sum())


def watch_rollout(fleet, model, model_sum, split: dict) -> None:
    """Wrap fleet.step: at the first tick where the replicas hold two weight
    versions, check that every replica not yet swapped still runs on the
    model's own tensors (the same storage and checksum) and record the
    paddle_tpu_fleet_weights_version gauge there."""
    import paddle_tpu_torch as ptt

    step = fleet.step
    own = dict(model.state_dict(keep_vars=True))

    def watched():
        out = step()
        live = [r for r in fleet.replicas if r.status != "down"]
        versions = [r.engine.weights_version for r in fleet.replicas]
        if not split and len({r.engine.weights_version for r in live}) > 1:
            old = [r for r in live if r.engine.weights_version == 0]
            same = all(r.engine.params[k] is v and r.engine.params[k].data_ptr() == v.data_ptr()
                       for r in old for k, v in own.items())
            sums = [weights_checksum(r.engine.params) for r in old]
            gauge = {s["labels"]["replica"]: s["value"] for s in ptt.telemetry.default_registry().collect()
                     if s["name"] == "paddle_tpu_fleet_weights_version"}
            if not same or any(s != model_sum for s in sums) or \
                    any(gauge.get(str(r.idx)) != 1 for r in live if r.engine.weights_version == 1):
                raise AssertionError(f"fleet_bf16: mid-rollout an unswapped replica lost its "
                                     f"weights, or the gauge does not show the split: same {same}, "
                                     f"sums {sums} vs {model_sum}, gauge {gauge}")
            split.update(versions=versions, gauge=gauge, unswapped_same_storage=same,
                         unswapped_checksum_equal=True)
        return out
    fleet.step = watched


class MigrationCapture:
    """Keep the converted payload of every migration of one fleet (the
    decode tier's int8 pages) beside the request it moved."""

    def __init__(self):
        from paddle_tpu_torch.inference import kv_cache as kvc

        self.kvc, self.real = kvc, kvc.import_pages
        self.payloads, self.rid, self.on, self.checked = {}, None, False, None

        def importing(pool, pages, payload):
            if self.on and self.rid is not None and self.rid not in self.payloads:
                self.payloads[self.rid] = payload
            return self.real(pool, pages, payload)
        kvc.import_pages = importing

    def attach(self, fleet, on):
        self.on = on
        migrate = fleet._migrate_request

        def tagged(src, dst, req):
            self.rid = req.rid
            try:
                return migrate(src, dst, req)
            finally:
                self.rid = None
        fleet._migrate_request = tagged

    def detach(self):
        self.kvc.import_pages = self.real


def check_int8_migration(model, burst: dict, captured) -> None:
    """The int8 pages a migration wrote equal, byte for byte, what an int8
    engine writes when it prefills the same prompt itself, over every slot a
    bucketed prefill wrote: request 0's whole prompt (it arrived at an idle
    fleet) and the shared prefix's pages of every later request (served from
    request 0's pages)."""
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.inference import kv_cache as kvc

    if 0 not in captured.payloads:
        raise AssertionError("fleet_bf16: request 0 did not migrate in the clean tiered run")
    prompt0 = burst[0].prompt
    eng = InferenceEngine(model, kv_dtype="int8", **FLEET_ENGINE)
    pages = eng.pool.alloc(eng.pool.blocks_for_tokens(len(prompt0)))
    eng.prefill(prompt0, pages)
    want = kvc.export_pages(eng.pool, pages)
    bs = FLEET_ENGINE["block_size"]
    slots = 0
    for rid, payload in captured.payloads.items():
        n = len(prompt0) if rid == 0 else 2 * bs  # the shared prefix is 2 pages
        for key in ("k", "v", "k_scale", "v_scale"):
            for got, ref in zip(payload[key], want[key]):
                g = got.reshape(-1, *got.shape[2:])[:n]
                w = ref.reshape(-1, *ref.shape[2:])[:n]
                if g.tobytes() != w.tobytes():
                    raise AssertionError(f"fleet_bf16: request {rid}'s migrated {key} pages differ "
                                         f"from an int8 engine's own prefill")
        slots += n
    captured.checked = dict(requests=len(captured.payloads), slots=slots)


def qos_traffic(vocab, seed=17, n=36, gap_s=0.04):
    """Two warm-up requests (one a replica, so both measure a step before the
    burst), then `n` requests over two tenants and three classes, arriving
    faster than two replicas serve them for ~1.5 s: the waiting lines stay
    full, which holds the pressure up and the token buckets overrun."""
    from paddle_tpu_torch.inference import Request

    rng = np.random.RandomState(seed)
    reqs = [Request(rid=i, prompt=rng.randint(0, vocab, (16,)).tolist(), max_new_tokens=4,
                    tenant="gold", priority=0) for i in range(2)]
    t = 0.3
    for i in range(2, 2 + n):
        t += rng.exponential(gap_s)
        tenant = "gold" if i % 2 == 0 else "bronze"
        prio = (0 if i % 4 == 0 else 1) if tenant == "gold" else 2
        reqs.append(Request(rid=i, prompt=rng.randint(0, vocab, (int(rng.randint(48, 96)),)).tolist(),
                            max_new_tokens=int(rng.choice([16, 24, 32])), arrival_time=t,
                            tenant=tenant, priority=prio))
    return reqs


def qos_tail(vocab, seed=18):
    """Four priority-0 requests submitted once the burst has ended: their
    steps read the falling pressure that unwinds the ladder."""
    from paddle_tpu_torch.inference import Request

    rng = np.random.RandomState(seed)
    return [Request(rid=100 + i, prompt=rng.randint(0, vocab, (24,)).tolist(), max_new_tokens=40,
                    tenant="gold", priority=0) for i in range(4)]


def qos_bf16(ptt, ta, model, state):
    """The 2-replica fleet at Llama-3-8B width with one shared QoSPolicy
    (see the module docstring)."""
    from paddle_tpu_torch.inference import (BrownoutConfig, InferenceEngine, QoSConfig,
                                            QoSPolicy, ReplicaFleet, TenantConfig, fleet_replay)
    from paddle_tpu_torch.inference.qos import tenant_report
    from paddle_tpu_torch.telemetry import timeline as tl

    vocab, dev = model.config["vocab_size"], next(model.parameters()).device
    cfg = QoSConfig(
        tenants={"gold": TenantConfig(weight=3.0, rate_tokens_per_s=600.0, burst_tokens=600.0),
                 "bronze": TenantConfig(weight=1.0, rate_tokens_per_s=300.0, burst_tokens=300.0)},
        max_waiting=4,
        brownout=BrownoutConfig(enter_pressure=0.8, exit_pressure=0.5, cooldown_s=0.15,
                                capped_max_new=8, low_priority=2))
    engine = dict(FLEET_ENGINE, num_blocks=36)  # 35 pages: 4 running requests fill 80% of it

    def fleet_of(qos):
        engines = [InferenceEngine(model, **engine) for _ in range(2)]
        for e in engines:
            e.prewarm()
        return engines, ReplicaFleet(engines, qos=qos)

    pol = QoSPolicy(cfg)
    engines, fleet = fleet_of(pol)
    qos_s = [0.0]

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                qos_s[0] += time.perf_counter() - t0
        return run
    sched_steps = [0]
    for rep in fleet.replicas:
        s = rep.sched
        for name in ("_qos_pre_step", "_qos_submit_gate", "_qos_on_admit", "_qos_priority_preempt"):
            setattr(s, name, timed(getattr(s, name)))
        step = s.step

        def counted(step=step):
            sched_steps[0] += 1
            return step()
        s.step = counted
    pol.select, pol.charge = timed(pol.select), timed(pol.charge)
    errors = spy_real_errors(fleet)
    tail = qos_tail(vocab)
    burst = qos_traffic(vocab)
    ptt.set_flags({"FLAGS_incident_timeline": True})
    tl.reset()
    try:
        # the tail is submitted once every burst request has ended
        stats, launches, steps = counted_run(ta, engines, lambda: fleet_replay(
            fleet, burst, events=[(len(burst), lambda: [fleet.submit(r) for r in tail])]))
        hold_fleet_run("qos_bf16", stats, fleet, tl, errors)
        rungs = sorted({r["payload"]["step"] for r in tl.recorder().records() if r["kind"] == "brownout"})
    finally:
        ptt.set_flags({"FLAGS_incident_timeline": False})
    # every request ends completed or shed, a shed one with a reason and a hint
    bad = [(r.rid, r.outcome, r.shed_reason, r.retry_after_s) for r in fleet.finished
           if r.outcome not in ("completed", "shed")
           or (r.outcome == "shed" and (r.shed_reason is None or r.retry_after_s is None))]
    if bad or len(fleet.finished) != len(burst) + len(tail):
        raise AssertionError(f"qos_bf16: requests ended otherwise: {bad}")
    if pol.brownout.step != 0 or max(rungs, default=0) < 2:
        raise AssertionError(f"qos_bf16: the ladder visited {rungs} and ended at "
                             f"{pol.brownout.step}, not back at 0 after reaching 2")
    # the oracle of the ids: the same requests without QoS (uncapped), one engine
    every = {r.rid: r for r in qos_traffic(vocab) + qos_tail(vocab)}
    done = {r.rid: r for r in fleet.finished if r.outcome == "completed"}
    p0 = {rid: fleet_ids(fleet)[rid] for rid, r in done.items() if r.priority == 0}
    capped = {rid: fleet_ids(fleet)[rid] for rid, r in done.items() if r.qos_orig_max_new is not None}
    held = sorted({**p0, **capped})
    oracle = InferenceEngine(model, **dict(FLEET_ENGINE, max_batch=8, decode_batch_buckets=(8,)))
    uncapped = dict(zip(held, oracle.generate([every[rid].prompt for rid in held],
                                              [every[rid].max_new_tokens for rid in held])))
    del oracle
    parts = parting(model, {rid: r.prompt for rid, r in every.items()}, {**p0, **capped},
                    uncapped, dev, near_tie_rule(model, state)["bound"]["bf16"])
    if not all(p["tie"] for p in parts):
        raise AssertionError(f"qos_bf16: ids part from the no-QoS run off a tie: {parts}")
    report = tenant_report(fleet.finished, cfg)
    state["qos_launches"] = launches
    log("qos_bf16", replicas=2, engine=engine, requests=len(fleet.finished),
        completed=len(done), shed_by_reason=dict(pol.shed_counts), rungs_visited=rungs,
        transitions=pol.brownout.transitions, capped=len(capped), priority0_completed=len(p0),
        parted=len(parts), parting=parts[:4], fairness_index=report["fairness_index"],
        tenants={t: {k: v for k, v in d.items()} for t, d in report["tenants"].items()},
        qos_host_us_per_step=qos_s[0] * 1e6 / max(1, sched_steps[0]), scheduler_steps=sched_steps[0],
        p99_ttft_ms=stats["p99_ttft_ms"], p99_tpot_ms=stats["p99_tpot_ms"],
        launches=launches, steps=steps)


def qos_predictor(ptt, dev="cuda"):
    """create_predictor with enable_llm_engine(llm_replicas=2, qos=QoSConfig)
    at predictor_f32's 1-layer f32 size: ids equal the single-replica
    predictor's."""
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.seed(1)
    model = LlamaForCausalLM(**dict(LLAMA3_8B, num_hidden_layers=1), device=dev,
                             dtype="float32").eval()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    rng = np.random.RandomState(2)
    lens = np.asarray([5, 17, 33, 64])
    ids = np.zeros((4, int(lens.max())), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, LLAMA3_8B["vocab_size"], n)
    outs = []
    try:
        prefix = inf.save_llm(model, os.path.join(tmp, "llama3_8b_1layer"))
        for replicas, qos in ((1, None), (2, inf.QoSConfig(max_waiting=8))):
            config = inf.Config(prefix)
            if dev == "cpu":
                config.disable_gpu()
            config.enable_llm_engine(max_new_tokens=8, max_seq_len=256, block_size=16, max_batch=4,
                                     llm_replicas=replicas, qos=qos)
            pred = inf.create_predictor(config)
            outs.append((pred.run([ids, lens])[0], pred))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (single, _), (fleet_out, pred) = outs
    if not np.array_equal(single, fleet_out) or len(pred.fleet().replicas) != 2 or pred.qos() is None:
        raise AssertionError(f"qos_bf16 predictor: fleet-backed ids {fleet_out.tolist()} != "
                             f"single-replica {single.tolist()}")
    log("qos_bf16 predictor", replicas=2, qos=True, ids_equal_single_replica=True,
        steps_by_replica=[dict(r.engine.step_counts) for r in pred.fleet().replicas])


def telemetry_ab(ptt, model, steps=48):
    """The host cost of telemetry, request traces and the incident timeline
    on serve_bf16's path, measured in pairs so the host's drift between
    windows cancels: (1) the engine's decode step (8 rows at ~1000 tokens of
    context) with the flags on and off in alternate steps; (2) two identical
    schedulers over one engine (8 requests each, prompts of equal lengths,
    distinct tokens), one with everything on (its requests traced), one with
    everything off, stepped in turns; twice, each side first once."""
    from paddle_tpu_torch.inference import ContinuousBatchingScheduler, InferenceEngine, Request

    engine = InferenceEngine(model, max_seq_len=2048, block_size=16, max_batch=8)
    prompts = [p[:64] for p in serve_prompts()[2:]]
    vocab = model.config["vocab_size"]
    flags = ("PADDLE_TPU_TELEMETRY", "FLAGS_request_trace", "FLAGS_incident_timeline")
    mode = lambda on: ptt.set_flags({f: on for f in flags})  # noqa: E731

    def paired(times):
        d = [a - b for a, b in zip(times[True], times[False])]
        return dict(on_ms=float(np.median(times[True])), off_ms=float(np.median(times[False])),
                    on_minus_off_median_ms=float(np.median(d)),
                    on_minus_off_iqr_ms=[float(np.percentile(d, 25)), float(np.percentile(d, 75))],
                    pairs=len(d))

    out = {}
    try:
        pool = engine.pool
        pool.reset()
        rows = [pool.alloc(pool.blocks_for_tokens(1000 + 2 * steps + 2)) for _ in range(8)]
        times = {True: [], False: []}
        for i in range(2 * steps + 2):
            on = i % 2 == 0
            mode(on)
            t0 = time.perf_counter()
            engine.decode([1] * 8, [1000 + i] * 8, [1001 + i] * 8, rows)  # ends in a host read
            if i >= 2:
                times[on].append((time.perf_counter() - t0) * 1e3)
        out["decode_step"] = paired(times)
        for first_on in (True, False):
            pool.reset()
            scheds, times = {}, {True: [], False: []}
            for on in (True, False):
                mode(on)  # the on side's requests are traced from submit
                scheds[on] = ContinuousBatchingScheduler(engine)
                for i, p in enumerate(prompts * 2):
                    toks = p if on else [(t + 1) % vocab for t in p]
                    scheds[on].submit(Request(rid=i, prompt=toks, max_new_tokens=40))
            while not all(s.idle() for s in scheds.values()):
                for on in (first_on, not first_on):
                    if scheds[on].idle():
                        continue
                    mode(on)
                    t0 = time.perf_counter()
                    scheds[on].step()
                    times[on].append((time.perf_counter() - t0) * 1e3)
            n = min(len(times[True]), len(times[False]))
            out[f"scheduler_step_{'on' if first_on else 'off'}_first"] = paired(
                {k: v[:n] for k, v in times.items()})
    finally:
        ptt.set_flags({"PADDLE_TPU_TELEMETRY": True, "FLAGS_request_trace": False,
                       "FLAGS_incident_timeline": False})
        engine.pool.reset()
    log("telemetry_ab", **out)


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

FP16_KEYS = ("case", "variant", "ms", "graph_ms", "plain_ms", "library_ms", "bound_ms",
             "max_abs_err")


def fp16_flash_checks(ta, gen) -> dict:
    """float16 cases of B1 (the Llama S4096 and ERNIE S128 shapes, causal and
    not, with dropout) and of B2/B3 through autograd, against their plain
    versions under TOL["fp16"]; the S4096 and S128 cases timed beside torch's
    sdpa in float16. Returns the records of the kernels line's float16 rows."""
    f16 = torch.float16
    fwd = [check_flash(ta, gen, "fp16 causal B1 S4096 H32/8 D128 (train)", 1, 4096, 4096, 32, 8,
                       128, f16, True, timed=True),
           check_flash(ta, gen, "fp16 non-causal B64 S128 H12 D64 (ERNIE seq128)", 64, 128, 128,
                       12, 12, 64, f16, False, timed=True)]
    check_flash(ta, gen, "fp16 causal dropout p=0.1 S2048 H32/8 D128", 1, 2048, 2048, 32, 8, 128,
                f16, True, dropout_p=0.1)
    check_flash(ta, gen, "fp16 non-causal dropout p=0.1 B64 S128 H12 D64", 64, 128, 128, 12, 12,
                64, f16, False, dropout_p=0.1)
    check_flash(ta, gen, "fp16 causal B2 Sq300 Sk777 H32/8 D128 (ragged tiles)", 2, 300, 777, 32,
                8, 128, f16, True)
    check_flash(ta, gen, "fp16 causal S256 H8/2 D96 (the CUDA-core variant)", 1, 256, 256, 8, 2,
                96, f16, True)
    bwd = [check_flash_bwd(ta, gen, "fp16 causal B1 S4096 H32/8 D128 (train)", 1, 4096, 4096, 32,
                           8, 128, f16, True, timed=True),
           check_flash_bwd(ta, gen, "fp16 non-causal B64 S128 H12 D64 (ERNIE seq128)", 64, 128,
                           128, 12, 12, 64, f16, False, timed=True)]
    check_flash_bwd(ta, gen, "fp16 dropout p=0.1 S256 H8/2 D128 causal", 1, 256, 256, 8, 2, 128,
                    f16, True, dropout_p=0.1)
    check_flash_bwd(ta, gen, "fp16 non-causal dropout p=0.1 B2 S512 H12 D64", 2, 512, 512, 12, 12,
                    64, f16, False, dropout_p=0.1)
    check_flash_bwd(ta, gen, "fp16 causal B1 Sq301 Sk777 H32/8 D128 (ragged tiles)", 1, 301, 777,
                    32, 8, 128, f16, True)
    check_flash_bwd(ta, gen, "fp16 causal S256 H8/2 D128, loss on out and lse", 1, 256, 256, 8, 2,
                    128, f16, True, use_lse=True)
    check_flash_bwd(ta, gen, "fp16 causal S256 H8/2 D96 (the CUDA-core variant)", 1, 256, 256, 8,
                    2, 96, f16, True)
    if any(r["variant"] != "wgmma" for r in fwd) or any(
            r["variant"] != "wgmma" for recs in bwd for r in recs):
        raise AssertionError("a float16 Llama or ERNIE shape did not run the wgmma variant")
    out = {"flash_fwd": dict(fwd[0], by_shape=[{k: r.get(k) for k in FP16_KEYS} for r in fwd])}
    for i, kname in enumerate(("flash_bwd_dq", "flash_bwd_dkdv")):
        rows = [dict(case=case, **{k: recs[i].get(k) for k in FP16_KEYS if k != "case"})
                for case, recs in zip(("fp16 causal B1 S4096 H32/8 D128 (train)",
                                       "fp16 non-causal B64 S128 H12 D64 (ERNIE seq128)"), bwd)]
        out[kname] = dict(bwd[0][i], by_shape=rows)
    return out


def causal_pairs(b, sq, sk, h, causal) -> int:
    """Visible (query, key) pairs over all heads."""
    off = sk - sq
    return b * h * (sum(min(sk, i + 1 + off) for i in range(sq)) if causal else sq * sk)


def check_flash_bwd(ta, gen, name, b, sq, sk, h, hkv, d, dtype, causal, dropout_p=0.0,
                    use_lse=False, timed=False):
    """Gradients through the flash wrapper the main path calls (its
    autograd backward launches the dq and dk/dv kernels once each) against
    (a) the plain backward on the same saved tensors and (b) autograd
    through the plain forward."""
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v, do = rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d), rn(b, sq, h, d)
    g_lse = torch.randn(b, h, sq, generator=gen, device="cuda") if use_lse else None
    scale, seed = 1.0 / math.sqrt(d), 1234
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(ta.LAUNCHES)
    out, lse = ta.flash_attention_bshd_lse(*leaves, causal=causal, dropout_p=dropout_p,
                                           dropout_seed=seed)
    outs, cots = ([out, lse], [do, g_lse]) if use_lse else ([out], [do])
    got = torch.autograd.grad(outs, leaves, cots)
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        if ta.LAUNCHES[kname] != before[kname] + 1:
            raise AssertionError(f"{name}: {kname} was not launched exactly once")
    out, lse = out.detach(), lse.detach()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if use_lse:
        delta = delta - g_lse
    delta = delta.contiguous()
    args = (q, k, v, do, lse, delta, causal, scale, dropout_p, seed)
    want = ta._flash_bwd_plain(*args)
    pl = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out_p, lse_p = ta._flash_plain(*pl, causal, scale, dropout_p, seed)
    want_ag = torch.autograd.grad([out_p, lse_p] if use_lse else [out_p], pl, cots)
    del out_p, lse_p, pl
    torch.cuda.synchronize()
    rec = dict(case=name, variant={kn: ta.kernel_variant(kn, dtype, d)
                                   for kn in ("flash_bwd_dq", "flash_bwd_dkdv")})
    for gname, gg, w, wa in zip(("dq", "dk", "dv"), got, want, want_ag):
        rec[gname] = compare(f"{name} {gname} vs plain backward", gg, w,
                             TOL[tol_key(dtype, grad=True)])
        rel = ((gg.float() - wa.float()).norm() / wa.float().norm()).item()
        rec[gname + "_vs_autograd_rel_l2"] = rel
        if not rel <= GRAD_VS_AUTOGRAD_REL[dtype]:
            raise AssertionError(f"{name} {gname}: kernel vs autograd of the plain forward, "
                                 f"relative L2 {rel} > {GRAD_VS_AUTOGRAD_REL[dtype]}")
    rec["max_abs_err"] = max(rec[g]["max_abs_err"] for g in ("dq", "dk", "dv"))
    log("kernel flash_bwd", **rec)
    if not timed:
        return rec, rec
    pairs = causal_pairs(b, sq, sk, h, causal)
    dq_out = torch.empty_like(q)
    common = dict(plain_ms=time_ms(lambda: ta._flash_bwd_plain(*args), iters=3, warmup=1))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out_l = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    common["library_ms"] = time_ms(lambda: torch.autograd.grad(out_l, (qt, kt, vt), dot,
                                                               retain_graph=True))
    del out_l
    bnd_dq, by_dq = bound_ms(6.0 * pairs * d, nbytes(q, k, v, do, lse, delta, dq_out), dtype)
    bnd_kv, by_kv = bound_ms(8.0 * pairs * d, nbytes(q, k, v, do, lse, delta, k, v), dtype)
    dq_call, kv_call = lambda: ta._flash_bwd_dq_cuda(*args), lambda: ta._flash_bwd_dkdv_cuda(*args)
    dq_rec = dict(max_abs_err=rec["dq"]["max_abs_err"], ms=time_ms(dq_call),
                  graph_ms=time_graph_ms(dq_call), bound_ms=bnd_dq, bound_by=by_dq,
                  variant=rec["variant"]["flash_bwd_dq"], **common)
    if dq_rec["variant"] != "cuda_core":
        # the earlier (CUDA-core) dq kernel on the same inputs, straight through
        # its C entry point (variant 0), outside the wrapper and its count
        from paddle_tpu_torch.ops.kernels import build
        use_drop = dropout_p > 0.0
        cc_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dq_out.data_ptr(), ta._DTYPE_CODE[dtype], b, sq, sk, h, hkv, d,
                   int(causal),
                   scale, int(use_drop), seed, ta._keep_threshold(dropout_p) if use_drop else 0,
                   1.0 / (1.0 - dropout_p), 0)
        dq_rec["cuda_core_ms"] = time_ms(lambda: build.check(build.function("flash_bwd_dq")(
            *cc_args, torch.cuda.current_stream().cuda_stream), "flash_bwd_dq (CUDA core)"),
            iters=5, warmup=1)
    kv_rec = dict(max_abs_err=max(rec["dk"]["max_abs_err"], rec["dv"]["max_abs_err"]),
                  ms=time_ms(kv_call), graph_ms=time_graph_ms(kv_call), bound_ms=bnd_kv,
                  bound_by=by_kv, variant=rec["variant"]["flash_bwd_dkdv"], **common)
    log("kernel flash_bwd timing", case=name, variant=rec["variant"], dq=dq_rec, dkdv=kv_rec,
        note="plain_ms and library_ms are for the pair (dq, dk, dv together)")
    return dq_rec, kv_rec


ADAMW_CASES = [  # (name, moment2 dtype, decoupled, wd, clip scale, param dtype)
    ("f32 m2, AdamW wd 0.01, clip 0.37", torch.float32, True, 0.01, 0.37, torch.float32),
    ("bf16 m2, AdamW wd 0.01, clip 1", torch.bfloat16, True, 0.01, 1.0, torch.float32),
    ("bf16 m2, Adam (coupled) wd 0.01, clip 0.37", torch.bfloat16, False, 0.01, 0.37, torch.float32),
    # amp.decorate(level="O2"): bf16 params, no f32 master copy
    ("bf16 P (O2), bf16 m2, AdamW wd 0.01, clip 0.37", torch.bfloat16, True, 0.01, 0.37,
     torch.bfloat16),
    ("bf16 P (O2), f32 m2, AdamW wd 0, clip 1", torch.float32, True, 0.0, 1.0, torch.bfloat16),
]


ADAMW_SEED = 0x9E3779B9  # above 2^31: the uint32 path
ADAMW_SLICE = 64 * 2 ** 20  # elements per plain-version call on a large bucket
# the smallest depth at the Llama-3-8B width whose one bucket passes 2^31
# elements (2.23e9): the kernel's 64-bit offsets and a uint32 hash index >= 2^31
LARGE_BUCKET_LAYERS = 9


def adamw_bucket(gen, n, m2_dtype, pad, p_dtype=torch.float32):
    rn = lambda: torch.randn(n, generator=gen, device="cuda")
    p, g, m = (rn() * 0.02).to(p_dtype), rn() * 1e-3, rn() * 1e-4
    v = (rn() * 1e-4).square().to(m2_dtype)
    for t in (p, g, m, v):
        t[n - pad:] = 0  # padding lanes, as the engine pads a bucket
    return p, m, v, g


def adamw_diff(got, want) -> dict:
    """Differences of the kernel's (p, m, v) from the plain version's."""
    (p, m, v), (wp, wm, wv) = got, want
    rel = lambda a, b: ((a.float() - b.float()).abs() / b.float().abs().clamp_min(1e-30)).max().item()
    d = dict(p_max_abs_err=(p - wp).abs().max().item(), p_max_rel_err=rel(p, wp),
             m_max_abs_err=(m - wm).abs().max().item(), m_max_rel_err=rel(m, wm))
    if v.dtype == torch.bfloat16:
        kb, wb = v.view(torch.int16).int(), wv.view(torch.int16).int()
        d.update(v_bits_equal=int((kb == wb).sum()), v_elems=v.numel(),
                 v_max_ulp_diff=(kb - wb).abs().max().item())
    else:
        d["v_max_rel_err"] = rel(v, wv)
    return d


def judge_adamw(name, diffs, padding_zero, **fields) -> dict:
    """Merge the differences of a bucket's slices and hold them to the
    limits: p, m and an f32 v within one f32 ulp; a bf16 v's bits equal
    except where the f32 v' differs by an ulp (share >= 99.99%), every
    element within one bf16 ulp; padding lanes zero."""
    rec = dict(case=name, **fields)
    for d in diffs:
        for k, x in d.items():
            rec[k] = rec.get(k, 0) + x if k in ("v_bits_equal", "v_elems") else max(rec.get(k, x), x)
    if "v_elems" in rec:
        rec["v_bits_equal_share"] = rec.pop("v_bits_equal") / rec.pop("v_elems")
        ok_v = rec["v_bits_equal_share"] >= 0.9999 and rec["v_max_ulp_diff"] <= 1
    else:
        ok_v = rec["v_max_rel_err"] <= ADAMW_F32_RTOL
    rec["padding_zero"] = padding_zero
    rec["max_abs_err"] = max(rec["p_max_abs_err"], rec["m_max_abs_err"])
    if not (ok_v and padding_zero and rec["p_max_rel_err"] <= ADAMW_F32_RTOL
            and rec["m_max_rel_err"] <= ADAMW_F32_RTOL):
        raise AssertionError(f"fused AdamW {name}: kernel disagrees with its plain version: {rec}")
    log("kernel fused_adamw", **rec)
    return rec


def check_fused_adamw(fo, gen, n=64 * 2 ** 20):
    """The wrapper (one launch) on a 64M-element bucket against the plain
    version, in each case of ADAMW_CASES."""
    pad = fo.PAD_ELEMS // 2
    c1, c2 = 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    for name, m2, decoupled, wd, clip, p_dtype in ADAMW_CASES:
        p, m, v, g = adamw_bucket(gen, n, m2, pad, p_dtype)
        hp = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=wd, decoupled=decoupled)
        scal = fo._scalars(1e-4, clip, c1, c2, "cuda")
        want = fo._reference_apply(p, m, v, g, scal, ADAMW_SEED, 0.9, 0.999, 1e-8, wd, decoupled,
                                   m2 == torch.bfloat16)
        before = fo.LAUNCHES["fused_adamw"]
        clip_t = torch.tensor(clip, device="cuda")  # a device scalar, as the clip gives it
        fo.fused_adamw_apply(p, m, v, g, lr=1e-4, clip_scale=clip_t, c1=c1, c2=c2, seed=ADAMW_SEED,
                             **hp)
        if fo.LAUNCHES["fused_adamw"] != before + 1:
            raise AssertionError(f"{name}: the wrapper did not launch the fused AdamW kernel once")
        torch.cuda.synchronize()
        padding_zero = all(bool((t[n - pad:] == 0).all()) for t in (p, m, v))
        judge_adamw(name, [adamw_diff((p, m, v), want)], padding_zero, n=n)
        del p, m, v, g, want


def train_bucket_elems(cfg) -> int:
    """Elements of the one flat bucket of a Llama (all params share a key)."""
    hdim, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    kv = hdim // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
    layer = 2 * hdim * hdim + 2 * hdim * kv + 3 * hdim * f + 2 * hdim
    return 2 * v * hdim + cfg["num_hidden_layers"] * layer + hdim


def ernie_bucket_elems(cfg, max_pos=512) -> int:
    """Elements of ERNIE MLM's one flat bucket: every param but the
    pooler's, which has no gradient (all f32, one weight decay)."""
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    layer = 4 * (h * h + h) + 2 * h * f + f + h + 4 * h
    return (v + max_pos + 4 + 2) * h + cfg["num_hidden_layers"] * layer + h * h + 3 * h + v


def check_adamw_bucket(fo, gen, name, n_real, starts=None, timed=False, p_dtype=torch.float32):
    """The wrapper on a bucket of `n_real` elements as the training step
    calls it (bf16 m2, AdamW wd 0.01, clip 1; one launch), held against the
    plain version slice by slice, each slice hashed at its flat offset:
    every slice, or those that begin at `starts`.

    Timed: kernel, plain and library times. The plain version runs over the
    bucket in slices (one call would need ~60 GB of temporaries); the
    library call is torch._fused_adamw_ on the same f32 p, m, g with an f32
    v, as a list of the same slices."""
    n = fo.pad_to_tile(n_real)
    p, m, v, g = adamw_bucket(gen, n, torch.bfloat16, n - n_real, p_dtype)
    kw = dict(lr=1e-4, clip_scale=1.0, c1=1.0 - 0.9 ** 3, c2=1.0 - 0.999 ** 3, seed=ADAMW_SEED,
              beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01, decoupled=True)
    hp = (ADAMW_SEED, 0.9, 0.999, 1e-8, 0.01, True, True)
    scal = fo._scalars(kw["lr"], 1.0, kw["c1"], kw["c2"], "cuda")
    starts = range(0, n, ADAMW_SLICE) if starts is None else starts
    saved = {i: tuple(t[i:i + ADAMW_SLICE].clone() for t in (p, m, v)) for i in starts}
    before = fo.LAUNCHES["fused_adamw"]
    fo.fused_adamw_apply(p, m, v, g, **kw)
    if fo.LAUNCHES["fused_adamw"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the fused AdamW kernel once")
    diffs = []
    for i in list(saved):
        s = slice(i, i + ADAMW_SLICE)
        want = fo._reference_apply(*saved.pop(i), g[s], scal, *hp, base=i)
        diffs.append(adamw_diff((p[s], m[s], v[s]), want))
        del want
    padding_zero = all(bool((t[n_real:] == 0).all()) for t in (p, m, v))
    rec = judge_adamw(name, diffs, padding_zero, n=n, slices_compared=len(diffs))
    if not timed:
        return rec

    def plain():
        for i in range(0, n, ADAMW_SLICE):
            s = slice(i, i + ADAMW_SLICE)
            fo._reference_apply(p[s], m[s], v[s], g[s], scal, *hp, base=i)

    # torch's fused AdamW takes one dtype for every list: f32, or with a
    # bf16 P (O2) bf16 g, m and v (it computes in f32 inside)
    lib_g, lib_m, lib_v = (t.to(p.dtype) for t in (g, m, v))
    parts = lambda t: list(t.split(ADAMW_SLICE))
    steps = [torch.tensor(3.0, device="cuda") for _ in parts(p)]
    lib = lambda: torch._fused_adamw_(parts(p), parts(lib_g), parts(lib_m), parts(lib_v), [], steps,
                                      lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
                                      amsgrad=False, maximize=False)
    bnd, by = bound_ms(20.0 * n, nbytes(p, m, v, g) + nbytes(p, m, v), torch.float32)
    rec = dict(rec, ms=time_ms(lambda: fo.fused_adamw_apply(p, m, v, g, **kw), iters=10, warmup=2),
               plain_ms=time_ms(plain, iters=2, warmup=1), library_ms=time_ms(lib, iters=10, warmup=2),
               bound_ms=bnd, bound_by=by, bytes_per_elem=(nbytes(p, m, v, g) + nbytes(p, m, v)) / n)
    log("kernel fused_adamw timing", n=n, ms=rec["ms"], plain_ms=rec["plain_ms"],
        library_ms=rec["library_ms"], bound_ms=bnd, bound_by=by, bytes_per_elem=rec["bytes_per_elem"],
        note="library: torch._fused_adamw_ with an f32 moment2 (28 B/elem), no bf16 form"
        if p.dtype == torch.float32 else "library: torch._fused_adamw_ on bf16 p, g, m and v")
    return rec


def check_rms_norm(IF, gen, name, r, d, dtype, bias, w_dtype=None, timed=False):
    """x of `dtype`; weight and bias of `w_dtype` (x's by default)."""
    w_dtype = w_dtype or dtype
    x = torch.randn(r, d, generator=gen, device="cuda").to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype)
    b = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype) if bias else None
    before = IF.LAUNCHES["rms_norm"]
    got = IF.fused_rms_norm(x, w, b, epsilon=1e-6)
    if IF.LAUNCHES["rms_norm"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the RMSNorm kernel exactly once")
    want = IF._rms_norm_ref(x, w, b, 1e-6)
    torch.cuda.synchronize()
    rec = dict(case=name, **compare(name, got, want, TOL["f32" if dtype == torch.float32 else "bf16"]))
    if timed:
        # a weight of another dtype than x takes torch's unfused rms_norm, which warns
        warnings.filterwarnings("ignore", message="Mismatch dtype between input and weight")
        bnd, by = bound_ms(4.0 * r * d, nbytes(x, w, got) + (nbytes(b) if bias else 0), dtype)
        kern = lambda: IF.fused_rms_norm(x, w, b, epsilon=1e-6)
        lib = None if bias else (lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6))
        # ms and library_ms: device time (CUDA graph); *_eager_ms: one call
        # from Python at a time, the host's overhead included
        rec.update(ms=time_graph_ms(kern), eager_ms=time_ms(kern),
                   plain_ms=time_ms(lambda: IF._rms_norm_ref(x, w, b, 1e-6)),
                   library_ms=lib and time_graph_ms(lib),
                   library_eager_ms=lib and time_ms(lib), bound_ms=bnd, bound_by=by)
    log("kernel rms_norm", **rec)
    return rec


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# card vs CPU, tiny Llama in bf16 O1 (bf16 GEMMs round at other points on
# the two devices); measured on an H100: loss 2.7e-5, grads 0.018,
# params 3.84 lr at most and 0.0096 lr on average
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_REL = 5e-2  # per-tensor ||g_card - g_cpu|| / ||g_cpu|| of the step-1 grads
TRAIN_PARAM_MAX_OVER_LR = 4.4  # 2 steps, each at most a flipped update of ~lr (1.1 lr with bias correction)
TRAIN_PARAM_MEAN_OVER_LR = 0.05
TRAIN_LR = 1e-3


def train_step(ptt, model, opt, ids, labels):
    with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss, _ = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def train_parity(ptt, ta, cfg):
    """A tiny Llama on the card (kernels) and on the CPU (plain versions)
    from the same weights and batch, 2 AMP-O1 fused-AdamW steps each."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(3)
    ref = LlamaForCausalLM(**cfg, device="cpu")
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, cfg["vocab_size"], (2, 64)))
    head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
    variant = {k: ta.kernel_variant(k, torch.bfloat16, head_dim)
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    runs = {}
    before = dict(ta.LAUNCHES)
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(**cfg, device="meta")
        model.load_state_dict({k: t.to(dev) for k, t in ref.state_dict().items()}, assign=True)
        opt = ptt.optimizer.AdamW(TRAIN_LR, parameters=model.parameters(), weight_decay=0.01,
                                  moment2_dtype="bfloat16")
        ptt.seed(11)  # the same stochastic-rounding seeds on both sides
        x = ids.to(dev)
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss1, _ = model(x, labels=x)
        loss1.backward()
        grads = {n: p.grad.detach().float().cpu().clone() for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        loss2 = train_step(ptt, model, opt, x, x)
        runs[dev] = dict(losses=[loss1.item(), loss2.item()], grads=grads,
                         params={n: p.detach().float().cpu() for n, p in model.named_parameters()})
    launches = {k: ta.LAUNCHES[k] - before[k] for k in variant}
    if any(n != 2 * cfg["num_hidden_layers"] for n in launches.values()):
        raise AssertionError(f"train_parity: flash launches {launches}, expected one per layer "
                             "per step on the card")
    card, cpu = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    grad_rel = max(((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                   for n, g in cpu["grads"].items())
    dp = torch.cat([(card["params"][n] - w).abs().reshape(-1) for n, w in cpu["params"].items()])
    rec = dict(losses_card=card["losses"], losses_cpu=cpu["losses"], loss_max_rel_err=loss_rel,
               grad_max_rel_l2_err=grad_rel, param_max_abs_diff_over_lr=dp.max().item() / TRAIN_LR,
               param_mean_abs_diff_over_lr=dp.mean().item() / TRAIN_LR,
               tol=dict(loss_rel=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL,
                        param_max_over_lr=TRAIN_PARAM_MAX_OVER_LR,
                        param_mean_over_lr=TRAIN_PARAM_MEAN_OVER_LR))
    # Adam normalises the gradient: where |g| is near its rounding noise
    # one step can move a param by up to lr either way, so the params are
    # held to two flipped updates at most, and on average to a small part of lr
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL
            and rec["param_max_abs_diff_over_lr"] <= TRAIN_PARAM_MAX_OVER_LR
            and rec["param_mean_abs_diff_over_lr"] <= TRAIN_PARAM_MEAN_OVER_LR):
        raise AssertionError(f"train_parity: card and CPU runs disagree: {rec}")
    log("train_parity", layers=cfg["num_hidden_layers"], hidden=cfg["hidden_size"],
        head_dim=head_dim, variant=variant, launches=launches, steps=2, **rec)


def profile_train(step, step_ms, steps=2):
    """Device time by kind of kernel over `steps` calls of `step`, the
    idle share against the host-clock `step_ms`, and the torch ops whose
    own kernels take the most device time (the hand-written kernels are
    launched through ctypes, under no torch op)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_kind, by_op = {}, {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CPU and us > 0:
            by_op[e.key] = us / 1e3 / steps
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        n = e.key.lower()
        kind = ("flash_fwd" if "flash_fwd" in n else
                "flash_bwd" if "flash_bwd" in n else
                "optimizer" if "fused_adamw" in n else
                "gemm" if any(t in n for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")) else
                "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
    busy = sum(by_kind.values())
    return dict(steps=steps, step_ms=step_ms,
                device_ms_per_step={k: round(v, 3) for k, v in sorted(by_kind.items())},
                device_busy_ms=busy if by_kind else None,
                device_idle_share=(1.0 - busy / step_ms) if by_kind else None,
                device_ms_by_torch_op=[[k, round(v, 3)] for k, v in
                                       sorted(by_op.items(), key=lambda kv: -kv[1])[:14]])


def rms_norm_entry(ta, IF, state):
    """The fused_rms_norm entry point as a user calls it, forward and
    backward, at the Llama-3-8B width (4096 tokens x 4096, bf16): its own
    path, apart from training, where nn.RMSNorm runs the plain rms_norm
    as in the JAX package."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(1, TRAIN_SEQ, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    w = torch.nn.Parameter((1.0 + 0.1 * torch.randn(4096, generator=gen, device="cuda")))
    g_out = torch.randn(1, TRAIN_SEQ, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    ta.reset_launch_counts()
    out = IF.fused_rms_norm(x, w)
    out.backward(g_out)
    torch.cuda.synchronize()
    launches = IF.LAUNCHES["rms_norm"]
    ok = (launches == 1 and out.shape == x.shape and out.dtype == torch.bfloat16
          and all(bool(torch.isfinite(t).all()) for t in (out, x.grad, w.grad)))
    if not ok:
        raise AssertionError(f"rms_norm_entry: launches {launches}, or a non-finite output/grad")
    state["rms_norm_launches"] = {"rms_norm": launches}
    # the same inputs and output cotangent through the plain version and autograd
    xr, wr = (t.detach().clone().requires_grad_(True) for t in (x, w))
    want = IF._rms_norm_ref(xr, wr, None, 1e-6)
    want.backward(g_out)
    tol = TOL["bf16"]
    rec = dict(out=compare("rms_norm_entry out", out.detach(), want.detach(), tol),
               dx=compare("rms_norm_entry dx", x.grad, xr.grad, tol),
               dw=compare("rms_norm_entry dw", w.grad[None], wr.grad[None], tol))
    log("rms_norm_entry", shape=list(x.shape), x_dtype="bfloat16", w_dtype="float32",
        launches=launches, grads_finite=True, **rec)


TRAIN_PER_STEP = {"flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
                  "flash_bwd_dkdv": TRAIN_LAYERS, "fused_adamw": 1}


def step_peaks(fwd_bwd, opt, step=None) -> dict:
    """Device memory peaks of one training step in GB: the forward and
    backward (`fwd_bwd`), then the optimizer step (`step`, default
    opt.step) and clear_grad, the peak reset before each (the step's flat
    copies of P and G set the second)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    fb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    (step or opt.step)()
    opt.clear_grad()
    torch.cuda.synchronize()
    return dict(fwd_bwd_peak_gb=fb, step_peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def train_bf16(ptt, ta, state, steps=5):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = dict(LLAMA3_8B, num_hidden_layers=TRAIN_LAYERS)
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(**cfg, device="cuda")
    opt = ptt.optimizer.AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                              moment2_dtype="bfloat16")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg["vocab_size"], (1, TRAIN_SEQ))).cuda()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the main path: every count 0 before it, read after it. Step 1 also
    # builds the optimizer bucket, so ms/step is timed over steps 2..N.
    ta.reset_launch_counts()
    losses, per_step = [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(ta.LAUNCHES)
        losses.append(train_step(ptt, model, opt, ids, ids))
        per_step.append({k: ta.LAUNCHES[k] - before[k] for k in TRAIN_PER_STEP})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    launches = dict(ta.LAUNCHES)
    losses = [x.item() for x in losses]
    if any(d != TRAIN_PER_STEP for d in per_step):
        raise AssertionError(f"train_bf16: launches per step {per_step} != {TRAIN_PER_STEP}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train_bf16: losses not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    def fwd_bwd():
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()

    peaks = step_peaks(fwd_bwd, opt)
    prof = profile_train(lambda: train_step(ptt, model, opt, ids, ids), step_ms)
    state["train_launches"] = launches
    state["train_bf16"] = dict(ms_per_step=step_ms, tokens_per_sec=TRAIN_SEQ / (step_ms / 1e3),
                               **peaks)
    log("train_bf16", layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=1,
        params_b=sum(p.numel() for p in model.parameters()) / 1e9, init_s=init_s,
        losses=losses, ms_per_step=step_ms, tokens_per_sec=TRAIN_SEQ / (step_ms / 1e3),
        peak_mem_gb=peak, launches=launches, launches_per_step=per_step[0], **peaks)
    log("train_bf16 profile", **prof)
    del model, opt, fwd_bwd
    gc.collect()  # the optimizer and its flat engine hold each other: collect the cycle
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the rest of training: recompute with micro-batches, float16 under a
# GradScaler, O2 with a checkpoint and resume, AMP parity card vs CPU
# ---------------------------------------------------------------------------

RECOMPUTE_MICRO = 2
# per step: the forward and the backward's replay launch the flash forward
# once a layer each, for each micro-batch
RECOMPUTE_PER_STEP = {"flash_fwd": 2 * RECOMPUTE_MICRO * TRAIN_LAYERS,
                      "flash_bwd_dq": RECOMPUTE_MICRO * TRAIN_LAYERS,
                      "flash_bwd_dkdv": RECOMPUTE_MICRO * TRAIN_LAYERS, "fused_adamw": 1}


def build_llama_at(ptt, layers, seq=TRAIN_SEQ, recompute=False, micro=1):
    """bench.py:480-510 (_build_llama_at) with the port: the Llama-3-8B
    width at `layers`, seed 0, `micro` rows of random ids and labels from
    seed 0, and the step through to_static as written (`micro`
    grad-accumulated micro-batches of one row under AMP O1 bf16, each
    (loss / micro).backward(), then one optimizer step). The optimizer is
    train_bf16's (FLAGS_fused_optimizer, AdamW 1e-4, wd 0.01, bf16
    moment2), so recompute and micro-batching are the only differences.
    -> (model, opt, ids, labels, the micro-batch loop, the step)."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    batch, hidden = micro, 4096
    ptt.seed(0)
    model = LlamaForCausalLM(vocab_size=32000, hidden_size=hidden, num_hidden_layers=layers,
                             num_attention_heads=32, num_key_value_heads=8,
                             intermediate_size=14336, recompute=recompute)
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    opt = ptt.optimizer.AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                              moment2_dtype="bfloat16")
    rng = np.random.RandomState(0)
    ids = ptt.to_tensor(rng.randint(0, 32000, (batch, seq)).astype(np.int64))
    labels = ptt.to_tensor(rng.randint(0, 32000, (batch, seq)).astype(np.int64))

    def micro_batches(ids, labels):
        loss = None
        for i in range(micro):  # micro=1 degenerates to the plain step
            with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss, _ = model(ids[i:i + 1], labels=labels[i:i + 1])
            (loss * (1.0 / micro)).backward()  # grads accumulate across rows
        return loss

    @ptt.jit.to_static
    def train_step(ids, labels):
        loss = micro_batches(ids, labels)
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, ids, labels, micro_batches, train_step


def train_recompute(ptt, ta, state, steps=5):
    """The bench's Llama step with recompute=True and micro=2 at 4 layers,
    seq 4096: exact launches a step, losses finite and falling, ms/step and
    tokens/s (8192 tokens a step), the forward+backward and step peaks,
    beside train_bf16's from the same call."""
    gc.collect()  # what earlier phases left in cycles: the peaks measured are this phase's own
    torch.cuda.empty_cache()
    model, opt, ids, labels, fwd_bwd, step = build_llama_at(
        ptt, TRAIN_LAYERS, TRAIN_SEQ, recompute=True, micro=RECOMPUTE_MICRO)
    torch.cuda.synchronize()
    ta.reset_launch_counts()
    losses, per_step = [], []
    for i in range(steps):
        if i == 1:  # step 1 builds the bucket
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(ta.LAUNCHES)
        losses.append(step(ids, labels))
        per_step.append({k: ta.LAUNCHES[k] - before[k] for k in RECOMPUTE_PER_STEP})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    launches = dict(ta.LAUNCHES)
    losses = [x.item() for x in losses]
    if any(d != RECOMPUTE_PER_STEP for d in per_step):
        raise AssertionError(f"train_recompute: launches per step {per_step} != "
                             f"{RECOMPUTE_PER_STEP}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train_recompute: losses not finite and falling: {losses}")
    peaks = step_peaks(lambda: fwd_bwd(ids, labels), opt)
    prof = profile_train(lambda: step(ids, labels), step_ms)
    tokens = RECOMPUTE_MICRO * TRAIN_SEQ
    state["recompute_launches"] = launches
    log("train_recompute", layers=TRAIN_LAYERS, seq=TRAIN_SEQ, micro_batches=RECOMPUTE_MICRO,
        recompute=True, tokens_per_step=tokens, losses=losses, ms_per_step=step_ms,
        tokens_per_sec=tokens / (step_ms / 1e3), launches=launches,
        launches_per_step=per_step[0], **peaks, train_bf16_same_call=state.get("train_bf16"))
    log("train_recompute profile", **prof)
    del model, opt, fwd_bwd, step
    gc.collect()
    torch.cuda.empty_cache()


FP16_STEPS, FP16_INF_STEP = 8, 6  # the grad hook's inf lands in step 6 of 8 (1-based)
FP16_SCALER = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2, decr_every_n_nan_or_inf=1)


def expected_scales(found, init_loss_scaling, incr_every_n_steps, decr_every_n_nan_or_inf,
                    incr_ratio=2.0, decr_ratio=0.5):
    """The scale after each step under the JAX package's GradScaler.update
    (paddle_tpu/amp/__init__.py:249-264) for a sequence of found-inf flags."""
    scale, good, bad, out = np.float32(init_loss_scaling), 0, 0, []
    for f in found:
        good, bad = (0, bad + 1) if f else (good + 1, 0)
        if bad >= decr_every_n_nan_or_inf:
            scale, bad = max(np.float32(scale * np.float32(decr_ratio)), np.float32(1.0)), 0
        if good >= incr_every_n_steps:
            scale, good = np.float32(scale * np.float32(incr_ratio)), 0
        out.append(float(scale))
    return out


def optimizer_snapshot(model, opt) -> dict:
    """Clones of every parameter and flat-bucket moment, the beta powers and
    `@step` (what a skipped step must leave bit for bit)."""
    eng = opt._flat_engine
    buckets = {k: (b["moment1"].clone(), b["moment2"].clone(), float(b["beta1_pow"]),
                   float(b["beta2_pow"])) for k, b in (eng.buckets.items() if eng else ())}
    return dict(params=[p.detach().clone() for p in model.parameters()], buckets=buckets,
                step=opt._step_count)


def snapshot_equal(a, b) -> bool:
    """Snapshot `b` (after a skipped step) holds `a`'s values bit for bit;
    a bucket the skipped step built (a first step's) holds its fill: zero
    moments, beta powers 1, as the JAX package's blended-back step leaves it."""
    if a["step"] != b["step"] or not set(a["buckets"]) <= set(b["buckets"]):
        return False
    if not all(torch.equal(x, y) for x, y in zip(a["params"], b["params"])):
        return False
    for k, (n1, n2, c1, c2) in b["buckets"].items():
        if k not in a["buckets"]:
            if n1.any() or n2.any() or (c1, c2) != (1.0, 1.0):
                return False
            continue
        m1, m2, b1, b2 = a["buckets"][k]
        if not (torch.equal(m1, n1) and torch.equal(m2.view(torch.int16), n2.view(torch.int16))
                and b1 == c1 and b2 == c2):
            return False
    return True


def train_fp16_scaler(ptt, ta, state):
    """AMP O1 in float16 at the Llama-3-8B width, 4 layers, seq 4096, B1,
    under GradScaler(2**15, incr every 2, decr every 1): fused AdamW (bf16
    moment2) over two param groups (norms without decay, the rest 0.01)
    with the embedding at an lr scale of 0.5 through its optimize_attr
    (three B5 buckets). 8 steps on one batch; a grad hook multiplies one
    gradient by inf in step 6. Every step with found_inf leaves every
    param, moment, beta power and `@step` bit-identical; the scale follows
    the JAX package's update rule over the logged found_inf sequence; the
    flash kernels run in float16 with exact launches, fused_adamw once per
    bucket on the steps that update."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dict(LLAMA3_8B, num_hidden_layers=TRAIN_LAYERS)
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(0)
    model = LlamaForCausalLM(**cfg, device="cuda")
    model.llama.embed_tokens.weight.optimize_attr = {"learning_rate": 0.5}  # ParamAttr(learning_rate=0.5)
    named = list(model.named_parameters())
    groups = [{"params": [p for n, p in named if "norm" in n], "weight_decay": 0.0},
              {"params": [p for n, p in named if "norm" not in n]}]
    opt = ptt.optimizer.AdamW(1e-4, parameters=groups, weight_decay=0.01, moment2_dtype="bfloat16")
    scaler = ptt.amp.GradScaler(**FP16_SCALER)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg["vocab_size"],
                                                           (1, TRAIN_SEQ))).cuda()
    poison = [False]
    model.llama.layers[0].mlp.down_proj.weight.register_hook(
        lambda g: g * float("inf") if poison[0] else g)

    def fwd_bwd():
        with ptt.amp.auto_cast(level="O1", dtype="float16"):
            loss, _ = model(ids, labels=ids)
        scaler.scale(loss).backward()
        return loss

    ta.reset_launch_counts()
    rows, step_s = [], []
    for i in range(1, FP16_STEPS + 1):
        poison[0] = i == FP16_INF_STEP
        before = optimizer_snapshot(model, opt)
        launches0 = dict(ta.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fwd_bwd()
        scaler.step(opt)
        opt.clear_grad()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        found = scaler._found_inf
        row = dict(step=i, found_inf=found, loss=loss.item(), scale=scaler._scale,
                   launches={k: ta.LAUNCHES[k] - launches0[k] for k in TRAIN_PER_STEP})
        if found:
            after = optimizer_snapshot(model, opt)
            row["state_unchanged"] = snapshot_equal(before, after)
            del after
        rows.append(row)
        del before
    launches = dict(ta.LAUNCHES)
    variants = {" ".join(k): n for k, n in ta.LAUNCH_VARIANTS.items()}
    found = [r["found_inf"] for r in rows]
    n_buckets = len(opt._flat_engine.buckets)
    want_scales = expected_scales(found, **FP16_SCALER)
    bad = []
    for r in rows:
        want = {"flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
                "flash_bwd_dkdv": TRAIN_LAYERS, "fused_adamw": 0 if r["found_inf"] else n_buckets}
        if r["launches"] != want:
            bad.append(f"step {r['step']} launches {r['launches']} != {want}")
        if r["found_inf"] and not r["state_unchanged"]:
            bad.append(f"step {r['step']}: found_inf, but the optimizer state changed")
    if n_buckets != 3:
        bad.append(f"{n_buckets} fused AdamW buckets, expected 3")
    if not found[FP16_INF_STEP - 1]:
        bad.append(f"the injected inf of step {FP16_INF_STEP} was not found")
    if [r["scale"] for r in rows] != want_scales:
        bad.append(f"scales {[r['scale'] for r in rows]} != the update rule's {want_scales}")
    updated = [r for r in rows if not r["found_inf"]]
    if len(updated) < 2 or not all(math.isfinite(r["loss"]) for r in updated):
        bad.append(f"{len(updated)} steps updated, or a non-finite loss on one")
    if any(k.split()[1] != "float16" or k.split()[2] != "wgmma" for k in variants
           if k.startswith("flash")):
        bad.append(f"a flash kernel did not run the float16 wgmma variant: {variants}")
    if bad:
        raise AssertionError("train_fp16_scaler: " + "; ".join(bad) + f"; rows {rows}")
    timed = [t for t, r in zip(step_s[1:], rows[1:]) if not r["found_inf"]]
    step_ms = 1e3 * sum(timed) / len(timed)
    peaks = step_peaks(fwd_bwd, opt, step=lambda: scaler.step(opt))

    def step():
        fwd_bwd()
        scaler.step(opt)
        opt.clear_grad()

    prof = profile_train(step, step_ms)
    state["fp16_launches"] = launches
    state["fp16_variants"] = variants
    log("train_fp16_scaler", layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=1, steps=FP16_STEPS,
        inf_step=FP16_INF_STEP, scaler=FP16_SCALER, buckets=[list(map(str, k)) for k in
                                                             opt._flat_engine.buckets],
        found_inf=found, scales=[r["scale"] for r in rows], losses=[r["loss"] for r in rows],
        skipped_state_unchanged=[r.get("state_unchanged") for r in rows],
        launches_per_step=[r["launches"] for r in rows], launch_variants=variants,
        ms_per_step=step_ms, timed_steps=len(timed), tokens_per_sec=TRAIN_SEQ / (step_ms / 1e3),
        **peaks, train_bf16_same_call=state.get("train_bf16"))
    log("train_fp16_scaler profile", **prof)
    del model, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()


O2_LAYERS, O2_STEPS, O2_SAVE_AT = 1, 5, 3


def o2_build(ptt):
    """1 layer at the Llama-3-8B width from seed 0, decorate(O2, bf16):
    AdamW (bf16 moment2, wd 0.01, FLAGS_fused_optimizer) on a LinearWarmup
    (2 steps) over a CosineAnnealingDecay, and a GradScaler."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(0)
    model = LlamaForCausalLM(**dict(LLAMA3_8B, num_hidden_layers=O2_LAYERS), device="cuda")
    lr = ptt.optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=8), warmup_steps=2,
                            start_lr=1e-5, end_lr=1e-4)
    opt = ptt.optimizer.AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                              moment2_dtype="bfloat16")
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = ptt.amp.GradScaler(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)
    return dict(model=model, opt=opt, sched=sched, scaler=scaler)


def o2_steps(ptt, run, ids, n) -> list:
    m, opt, scaler = run["model"], run["opt"], run["scaler"]
    losses = []
    for _ in range(n):
        with ptt.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = m(ids, labels=ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        run["sched"].step()
        losses.append(loss.item())
    return losses


def o2_result(run, losses) -> dict:
    return dict(losses=losses, params={n: p.detach().clone() for n, p in
                                       run["model"].named_parameters()},
                scaler={k: v.item() for k, v in run["scaler"].state_dict().items()},
                lr=run["opt"].get_lr())


def o2_distance(a, b) -> dict:
    """Largest |difference| of the losses and of each param (f32)."""
    return dict(loss=max(abs(x - y) for x, y in zip(a["losses"], b["losses"])),
                params={n: (a["params"][n].float() - b["params"][n].float()).abs().max().item()
                        for n in a["params"]})


def train_o2_resume(ptt, ta, state):
    """amp.decorate O2 (bf16 params, B5 with a bf16 P) at the Llama-3-8B
    width, 1 layer, seq 4096: two uninterrupted 5-step runs, whose distance
    is the limit (trap: the loss's gather and the embedding backward may
    sum with atomics; deterministic algorithms are asked for in this phase),
    then 3 steps, paddle.save of the model, the optimizer (with its
    scheduler), the scaler and the framework generators to a fresh
    directory, everything built anew, paddle.load and set_state_dict before
    the first step, 2 more steps: losses and every param within the two
    runs' distance, the scaler state and the lr equal."""
    from paddle_tpu_torch.framework import random as prandom

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 32000, (1, TRAIN_SEQ))).cuda()
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.filterwarnings("ignore", message=".*deterministic.*")
    tmp = None
    try:
        ta.reset_launch_counts()
        runs = []
        for _ in range(2):
            run = o2_build(ptt)
            if any(p.dtype != torch.bfloat16 for p in run["model"].parameters()):
                raise AssertionError("train_o2_resume: decorate left a parameter that is not bf16")
            t0 = time.perf_counter()
            losses = o2_steps(ptt, run, ids, O2_STEPS)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / O2_STEPS
            runs.append(o2_result(run, losses))
            del run
            gc.collect()
        launches = dict(ta.LAUNCHES)
        run = o2_build(ptt)
        first = o2_steps(ptt, run, ids, O2_SAVE_AT)
        nbytes_state = sum(t.numel() * t.element_size() for t in run["model"].state_dict().values())
        nbytes_state += sum(t.numel() * t.element_size() for t in run["opt"].state_dict().values()
                            if isinstance(t, torch.Tensor))
        tmp = tempfile.mkdtemp(prefix="ptt_o2_resume_")
        free = shutil.disk_usage(tmp).free
        if free < 1.5 * nbytes_state:
            raise AssertionError(f"train_o2_resume: {free / 1e9:.1f} GB free under {tmp}, the "
                                 f"checkpoint needs {nbytes_state / 1e9:.1f} GB")
        path = os.path.join(tmp, "llama_o2.pdckpt")
        t0 = time.perf_counter()
        ptt.save({"model": run["model"].state_dict(), "opt": run["opt"].state_dict(),
                  "scaler": run["scaler"].state_dict(), "rng": prandom.get_rng_state()}, path)
        save_s, file_gb = time.perf_counter() - t0, os.path.getsize(path) / 1e9
        del run
        gc.collect()
        torch.cuda.empty_cache()
        run = o2_build(ptt)
        t0 = time.perf_counter()
        ck = ptt.load(path)
        run["model"].load_state_dict(ck["model"])
        run["opt"].set_state_dict(ck["opt"])
        run["scaler"].load_state_dict(ck["scaler"])
        prandom.set_rng_state(ck["rng"])
        load_s = time.perf_counter() - t0
        m2_dtype = str(ck["opt"]["moment2_0"].dtype)
        del ck
        resumed = o2_result(run, first + o2_steps(ptt, run, ids, O2_STEPS - O2_SAVE_AT))
        del run
    finally:
        torch.use_deterministic_algorithms(det)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    a, b = runs
    d_ab, d_ra = o2_distance(a, b), o2_distance(resumed, a)
    over = [n for n in d_ra["params"] if d_ra["params"][n] > d_ab["params"][n]]
    bit_equal = d_ra["loss"] == 0 and all(v == 0 for v in d_ra["params"].values())
    rec = dict(layers=O2_LAYERS, seq=TRAIN_SEQ, steps=O2_STEPS, saved_at=O2_SAVE_AT,
               params_b=sum(p.numel() for p in a["params"].values()) / 1e9,
               losses=a["losses"], losses_resumed=resumed["losses"],
               uninterrupted_distance=dict(loss=d_ab["loss"], param_max=max(d_ab["params"].values())),
               resumed_distance=dict(loss=d_ra["loss"], param_max=max(d_ra["params"].values())),
               resumed_bit_equal=bit_equal, scaler=resumed["scaler"], lr=resumed["lr"],
               checkpoint_gb=file_gb, save_s=save_s, load_s=load_s, moment2_dtype=m2_dtype,
               ms_per_step=step_ms, launches=launches, deterministic_algorithms=True)
    if (d_ra["loss"] > d_ab["loss"] or over or resumed["scaler"] != a["scaler"]
            or resumed["lr"] != a["lr"] or not all(math.isfinite(x) for x in a["losses"])):
        raise AssertionError(f"train_o2_resume: the resumed run is not within the distance of "
                             f"two uninterrupted runs (params over it: {over}): {rec}, scaler "
                             f"{a['scaler']}, lr {a['lr']}")
    state["o2_launches"] = launches
    log("train_o2_resume", **rec)
    gc.collect()
    torch.cuda.empty_cache()


# card vs CPU limits of amp_parity's O2 case, set before its first card run
# at 1.5-5x the worst measured by the port against the JAX package on the
# CPU at the same config (loss 6.5e-5, grads 0.0128, params 0.85 of
# (4.4 lr + 4 bf16 ulps) at most and 0.0126 lr on average)
O2_LOSS_RTOL = 3e-4
O2_GRAD_REL = 5e-2
O2_PARAM_MAX_OVER_BOUND = 1.5  # of 4.4 lr + 4 ulps of the param's value
O2_PARAM_MEAN_OVER_LR = 0.05


def amp_parity_run(ptt, cfg, ref_state, dev, ids, case):
    """2 AdamW steps (TRAIN_LR, wd 0.01, fused, bf16 moment2, seed 11 for
    the rounding) of a tiny Llama from `ref_state` on `dev` in `case`:
    "o1_fp16" (O1 float16, GradScaler 2**15), "o2_bf16" (decorate O2) or
    "recompute_micro2" (recompute, 2 micro-batches of one row, O1 bf16).
    -> losses, the step-1 grads (unscaled) and the params, f32 on the CPU."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.set_flags({"FLAGS_fused_optimizer": True})
    model = LlamaForCausalLM(**cfg, recompute=case == "recompute_micro2", device="meta")
    # a copy on either device: assigned as they are, the CPU run would train
    # `ref_state` itself, and the next case would start from its weights
    model.load_state_dict({k: t.to(dev, copy=True) for k, t in ref_state.items()}, assign=True)
    opt = ptt.optimizer.AdamW(TRAIN_LR, parameters=model.parameters(), weight_decay=0.01,
                              moment2_dtype="bfloat16")
    scaler = ptt.amp.GradScaler(init_loss_scaling=2.0 ** 15) if case == "o1_fp16" else None
    if case == "o2_bf16":
        model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    level, dtype = {"o1_fp16": ("O1", "float16"), "o2_bf16": ("O2", "bfloat16"),
                    "recompute_micro2": ("O1", "bfloat16")}[case]
    micro = 2 if case == "recompute_micro2" else 1
    x = ids.to(dev)
    ptt.seed(11)  # the same stochastic-rounding seeds on both sides
    losses, grads = [], None
    for i in range(2):
        for r in range(micro):
            xr = x[r:r + 1] if micro > 1 else x
            with ptt.amp.auto_cast(level=level, dtype=dtype):
                loss, _ = model(xr, labels=xr)
            if scaler is not None:
                scaler.scale(loss).backward()
            else:
                (loss * (1.0 / micro)).backward()
        if scaler is not None:
            scaler.unscale_(opt)
        if i == 0:
            grads = {n: p.grad.detach().float().cpu().clone() for n, p in model.named_parameters()}
        if scaler is not None:
            scaler.step(opt)
        else:
            opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return dict(losses=losses, grads=grads,
                params={n: p.detach().float().cpu() for n, p in model.named_parameters()})


def amp_parity(ptt, ta):
    """A tiny Llama (head_dim 64: the tensor-core flash variants) from one
    set of weights on the card and on the CPU, 2 steps each in three cases:
    O1 float16 with a GradScaler and recompute with micro=2 in O1 bf16
    (train_parity's limits), O2 bf16 through decorate (O2_* limits)."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = TINY_LLAMA_D64
    ptt.seed(3)
    ref = LlamaForCausalLM(**cfg, device="cpu")
    ref_state = ref.state_dict()
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, cfg["vocab_size"], (2, 64)))
    layers = cfg["num_hidden_layers"]
    for case in ("o1_fp16", "o2_bf16", "recompute_micro2"):
        ta.reset_launch_counts()
        card = amp_parity_run(ptt, cfg, ref_state, "cuda", ids, case)
        launches = {k: ta.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
        variants = {" ".join(k): n for k, n in ta.LAUNCH_VARIANTS.items()}
        cpu = amp_parity_run(ptt, cfg, ref_state, "cpu", ids, case)
        fwd = 2 * layers * (4 if case == "recompute_micro2" else 1)
        bwd = 2 * layers * (2 if case == "recompute_micro2" else 1)
        want = {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkdv": bwd}
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
        grad_rel = max(((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                       for n, g in cpu["grads"].items())
        dp = torch.cat([(card["params"][n] - w).abs().reshape(-1) for n, w in cpu["params"].items()])
        rec = dict(case=case, losses_card=card["losses"], losses_cpu=cpu["losses"],
                   loss_max_rel_err=loss_rel, grad_max_rel_l2_err=grad_rel,
                   param_max_abs_diff_over_lr=dp.max().item() / TRAIN_LR,
                   param_mean_abs_diff_over_lr=dp.mean().item() / TRAIN_LR,
                   launches=launches, launch_variants=variants)
        if case == "o2_bf16":
            ulp = torch.cat([w.abs().reshape(-1) for w in cpu["params"].values()]) * 2.0 ** -8
            over = (dp / (4.4 * TRAIN_LR + 4 * ulp)).max().item()
            rec.update(param_max_over_bound=over, tol=dict(
                loss_rel=O2_LOSS_RTOL, grad_rel_l2=O2_GRAD_REL,
                param_max_over_bound=O2_PARAM_MAX_OVER_BOUND,
                param_mean_over_lr=O2_PARAM_MEAN_OVER_LR))
            ok = (loss_rel <= O2_LOSS_RTOL and grad_rel <= O2_GRAD_REL
                  and over <= O2_PARAM_MAX_OVER_BOUND
                  and rec["param_mean_abs_diff_over_lr"] <= O2_PARAM_MEAN_OVER_LR)
        else:
            rec["tol"] = dict(loss_rel=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL,
                              param_max_over_lr=TRAIN_PARAM_MAX_OVER_LR,
                              param_mean_over_lr=TRAIN_PARAM_MEAN_OVER_LR)
            ok = (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL
                  and rec["param_max_abs_diff_over_lr"] <= TRAIN_PARAM_MAX_OVER_LR
                  and rec["param_mean_abs_diff_over_lr"] <= TRAIN_PARAM_MEAN_OVER_LR)
        if launches != want:
            raise AssertionError(f"amp_parity {case}: flash launches {launches} != {want}")
        if not ok:
            raise AssertionError(f"amp_parity {case}: card and CPU runs disagree: {rec}")
        log("amp_parity", **rec)


# ---------------------------------------------------------------------------
# ERNIE-3.0 MLM pretraining (bench.py's headline workload)
# ---------------------------------------------------------------------------

# ERNIE-3.0-base at full width and depth (bench.py:189-200, _ernie_dims)
ERNIE_BASE = dict(vocab_size=40000, hidden_size=768, num_hidden_layers=12, intermediate_size=3072)
# the parity model: 4 heads of 64 (the tensor-core flash variants), non-causal
TINY_ERNIE = dict(vocab_size=1024, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=512, max_position_embeddings=128, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
ERNIE_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkdv": 12, "fused_adamw": 1}
# a leaf of an encoder layer whose CPU gradient norm is below this share of
# the same layer's query-bias gradient norm holds a gradient that is 0 but
# for rounding (the key bias: 0.012-0.017 measured on the CPU in bf16 O1,
# 1e-6 in f32); both devices' gradients there are held to it as noise
ZERO_GRAD_NOISE = 0.05


def ernie_train_step(ptt, model, opt):
    """bench.py:237-245's step: AMP O1 bf16 MLM loss, backward, AdamW,
    clear_grad, through to_static; with keep_grads it also hands back the
    grads of the backward (CPU f32 copies)."""

    @ptt.jit.to_static
    def step(ids, labels, keep_grads=False):
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = model(ids, labels=labels)
        loss.backward()
        grads = ({n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
                  if p.grad is not None} if keep_grads else None)
        opt.step()
        opt.clear_grad()
        return loss, grads

    return step


def ernie_parity(ptt, ta):
    """A tiny ERNIE on the card (kernels) and on the CPU (plain versions)
    from the same weights and batch, 2 AMP-O1 fused-AdamW steps each
    through to_static; train_parity's limits."""
    from paddle_tpu_torch.models import ErnieForMaskedLM, ErnieModel

    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(3)
    ref = ErnieForMaskedLM(ErnieModel(**TINY_ERNIE))
    rng = np.random.RandomState(4)
    ids = rng.randint(1, TINY_ERNIE["vocab_size"], (2, 64))
    ids[0, 40:] = 0  # the padding id: its embedding output must stay zero
    ids[1, 3] = 0
    labels = np.where(rng.rand(2, 64) < 0.5, ids, -100)
    head_dim = TINY_ERNIE["hidden_size"] // TINY_ERNIE["num_attention_heads"]
    variant = {k: ta.kernel_variant(k, torch.bfloat16, head_dim)
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    if set(variant.values()) != {"wgmma"}:
        raise AssertionError(f"ernie_parity: head_dim {head_dim} runs {variant}, not wgmma")
    pooler0 = {n: p.detach().float().cpu().clone() for n, p in ref.named_parameters()
               if n.startswith("ernie.pooler.")}
    runs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(ref).to(dev)
        opt = ptt.optimizer.AdamW(TRAIN_LR, parameters=model.parameters(), weight_decay=0.01,
                                  moment2_dtype="bfloat16")
        step = ernie_train_step(ptt, model, opt)
        x, y = torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)
        ptt.seed(11)  # the same stochastic-rounding seeds on both sides
        before = dict(ta.LAUNCHES)
        loss1, grads = step(x, y, keep_grads=True)
        loss2, _ = step(x, y)
        launches = {k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP}
        params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
        runs[dev] = dict(losses=[loss1.item(), loss2.item()], grads=grads, params=params,
                         launches=launches)
    want = {k: 2 * (TINY_ERNIE["num_hidden_layers"] if k != "fused_adamw" else 1)
            for k in ERNIE_PER_STEP}
    if runs["cuda"]["launches"] != want or any(runs["cpu"]["launches"].values()):
        raise AssertionError(f"ernie_parity: launches card {runs['cuda']['launches']}, cpu "
                             f"{runs['cpu']['launches']}; expected {want} on the card, none on the CPU")
    card, cpu = runs["cuda"], runs["cpu"]
    if set(card["grads"]) != set(cpu["grads"]) or any(n in cpu["grads"] for n in pooler0):
        raise AssertionError("ernie_parity: the sets of params with a gradient differ, or the "
                             "pooler (outside the MLM loss) got one")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    # a leaf whose true gradient is 0 (the key bias: a shift of every key by
    # b moves one query's scores by the same q.b, which the softmax ignores)
    # holds only each device's own rounding noise: chosen by the rule on the
    # CPU gradient above, and held to be noise on both devices, not to the
    # other device's noise
    def query_bias_norm(n):
        layer = re.match(r".*\.layers\.\d+\.", n)
        return cpu["grads"][layer.group(0) + "self_attn.q_proj.bias"].norm().item() if layer else None

    ref_norm = {n: query_bias_norm(n) for n in cpu["grads"]}
    zero_grad = sorted(n for n, g in cpu["grads"].items()
                       if ref_norm[n] and g.norm().item() < ZERO_GRAD_NOISE * ref_norm[n])
    zero_grad_noise = max((r["grads"][n].norm().item() / ref_norm[n] for r in runs.values()
                           for n in zero_grad), default=0.0)
    grad_rel = max(((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                   for n, g in cpu["grads"].items() if n not in zero_grad)
    dp = torch.cat([(card["params"][n] - w).abs().reshape(-1) for n, w in cpu["params"].items()])
    pooler_still = all(torch.equal(r["params"][n], w) for r in runs.values()
                       for n, w in pooler0.items())
    pad_row_moved = all(bool(r["params"]["ernie.embeddings.word_embeddings.weight"][0].any())
                        for r in runs.values())
    rec = dict(losses_card=card["losses"], losses_cpu=cpu["losses"], loss_max_rel_err=loss_rel,
               grad_max_rel_l2_err=grad_rel, zero_grad_leaves=zero_grad,
               zero_grad_over_query_bias=zero_grad_noise,
               param_max_abs_diff_over_lr=dp.max().item() / TRAIN_LR,
               param_mean_abs_diff_over_lr=dp.mean().item() / TRAIN_LR,
               pooler_unchanged=pooler_still, padding_row_moved=pad_row_moved,
               tol=dict(loss_rel=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL,
                        zero_grad_over_query_bias=ZERO_GRAD_NOISE,
                        param_max_over_lr=TRAIN_PARAM_MAX_OVER_LR,
                        param_mean_over_lr=TRAIN_PARAM_MEAN_OVER_LR))
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL and pooler_still
            and pad_row_moved and zero_grad_noise <= ZERO_GRAD_NOISE
            and rec["param_max_abs_diff_over_lr"] <= TRAIN_PARAM_MAX_OVER_LR
            and rec["param_mean_abs_diff_over_lr"] <= TRAIN_PARAM_MEAN_OVER_LR):
        raise AssertionError(f"ernie_parity: card and CPU runs disagree: {rec}")
    log("ernie_parity", layers=TINY_ERNIE["num_hidden_layers"], hidden=TINY_ERNIE["hidden_size"],
        head_dim=head_dim, variant=variant, launches=card["launches"], steps=2,
        ids_at_padding=int((ids == 0).sum()), **rec)


def build_ernie(ptt, batch, seq, heads, max_pos, attn_dropout):
    """bench.py:203-245 (build_train_step) with the port: ERNIE-3.0-base,
    hidden dropout 0, fused AdamW 1e-4, wd 0.01, bf16 moment2, one batch
    of random ids and labels from seed 0, the step through to_static."""
    from paddle_tpu_torch.models import ErnieForMaskedLM, ErnieModel

    ptt.seed(0)
    model = ErnieForMaskedLM(ErnieModel(
        **ERNIE_BASE, num_attention_heads=heads, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=attn_dropout, max_position_embeddings=max_pos))
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    opt = ptt.optimizer.AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                              moment2_dtype="bfloat16")
    rng = np.random.RandomState(0)
    ids = ptt.to_tensor(rng.randint(0, ERNIE_BASE["vocab_size"], (batch, seq)).astype(np.int64))
    labels = ptt.to_tensor(rng.randint(0, ERNIE_BASE["vocab_size"], (batch, seq)).astype(np.int64))
    return model, ernie_train_step(ptt, model, opt), ids, labels


def ernie_train(ptt, ta, state, name, batches, seq, heads, max_pos, attn_dropout, steps=5):
    """The bench's ERNIE step at one shape: `steps` steps on one batch,
    ms/step on the host clock over steps 2..N (step 1 builds the optimizer
    bucket), exact launches per step, and the bench's MFU count
    (bench.py:407-416). `batches`: the batch, then the smaller one the
    bench falls back to when it runs out of memory."""
    head_dim = ERNIE_BASE["hidden_size"] // heads
    variant = {k: ta.kernel_variant(k, torch.bfloat16, head_dim)
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    if set(variant.values()) != {"wgmma"}:
        raise AssertionError(f"{name}: head_dim {head_dim} runs {variant}, not wgmma")
    for batch in batches:
        # earlier phases leave reference cycles (an optimizer and its flat
        # engine, profiler events) that hold device memory until a full
        # collection: collected here, the peak measured is this phase's own
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            model, step, ids, labels = build_ernie(ptt, batch, seq, heads, max_pos, attn_dropout)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            # the main path: every count 0 before it, read after it
            ta.reset_launch_counts()
            losses, per_step = [], []
            for i in range(steps):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                before = dict(ta.LAUNCHES)
                losses.append(step(ids, labels)[0])
                per_step.append({k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP})
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if batch == batches[-1]:
                raise
            model = step = None
            log(name, out_of_memory_at_batch=batch)
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    launches = dict(ta.LAUNCHES)
    losses = [x.item() for x in losses]
    if any(d != ERNIE_PER_STEP for d in per_step):
        raise AssertionError(f"{name}: launches per step {per_step} != {ERNIE_PER_STEP}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: losses not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    emb = model.ernie.embeddings
    n_params = sum(p.numel() for p in model.parameters())
    flops_per_token = (6 * (n_params - emb.position_embeddings.weight.numel()
                            - emb.token_type_embeddings.weight.numel())
                       + 12 * seq * ERNIE_BASE["hidden_size"] * ERNIE_BASE["num_hidden_layers"])
    tokens_per_sec = batch * seq / (step_ms / 1e3)
    prof = profile_train(lambda: step(ids, labels), step_ms)
    state.setdefault("ernie_launches", {})[name] = launches
    log(name, batch=batch, seq=seq, heads=heads, head_dim=head_dim, variant=variant,
        attn_dropout=attn_dropout, params_m=n_params / 1e6, init_s=init_s,
        losses=losses,
        ms_per_step=step_ms, tokens_per_sec=tokens_per_sec, flops_per_token=flops_per_token,
        mfu=tokens_per_sec * flops_per_token / PEAK_FLOPS[torch.bfloat16],
        step_ms_at_peak=batch * seq * flops_per_token / PEAK_FLOPS[torch.bfloat16] * 1e3,
        peak_mem_gb=peak, launches=launches, launches_per_step=per_step[0])
    log(f"{name} profile", **prof)
    del model, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# ResNet-50 ImageNet training (bench.py:1982-2006, BASELINE.json's second
# metric, images/s). No hand-written kernel lies on this path: the convs are
# cuDNN's, batch norm, pools, the loss and Momentum plain torch ops, as the
# JAX package leaves them to XLA.
# ---------------------------------------------------------------------------

RESNET_PARITY_BATCH, RESNET_PARITY_HW = 4, 64  # layer4 is 2x2
# f32 card (cuDNN, TF32 off) vs CPU: summation order only. Limits of the
# relative error of each loss (to the step-1 loss), of each tensor's step-1
# grad and of each param's and BN buffer's change over the 2 steps, at
# 2.6-3.9x the worst measured on one H100 (3.2e-6, 7.7e-4, 2.6e-3)
RESNET_F32_TOL = dict(loss=1e-5, grad=2e-3, change=1e-2)
# O1: a bf16 logit near 3 moves by 2^-8 * 3 = 0.012 a rounding, so the mean
# loss of 4 images by a few thousandths (the port against the JAX package
# on the CPU: 1.9e-3 of the step-1 loss). Grads and changes in O1 are bf16
# noise: on the CPU the O1 step-1 grads of either package are ~54% (relative
# L2) from its f32 grads, and the port's from the JAX package's ~27%. So
# each tensor of the card's O1 run is held within 1.5x the CPU's own O1-vs-f32
# distance of that tensor (two independent roundings of equal size differ by
# sqrt(2)x), not to train_parity's 5e-2; the step-2 loss, after updates
# that far apart, to 2e-2 of the step-1 loss. Measured on one H100:
# losses 2.3e-3 and 9.5e-3, the worst tensor 1.30x.
RESNET_O1_LOSS = (5e-3, 2e-2)  # of the step-1 loss, at steps 1 and 2
RESNET_O1_NOISE_RATIO = 1.5
RESNET_BATCH = 64  # bench.py:1978 (BENCH_RESNET_BATCH's default)
# A ReLU input within f32 rounding of 0 may take either side on two
# devices, and two inputs of a max-pool window within rounding of each
# other either argmax; at B4 64x64 (16-64 values a BN channel in layer3-4)
# one such flip moves a BN channel's grads by percents: on the CPU alone,
# f32 against f64, 2 ReLU flips (inputs 1.7e-9 and 5e-7 of their tensor's
# rms) put resnet18's layer3.0.bn1.bias grad 3.0e-2 apart. So an f32 CPU
# run takes the card's decisions, and the two devices may decide
# differently only within DECISION_TIE of the input's rms.
DECISION_TIE = 1e-4


def _kinks():
    """nn.functional's name -> (the regions of an input: ReLU x > 0, ReLU6
    and the hard activations which of their three pieces, a max pool each
    window's argmax; the function's value in given regions; each output
    element's distance to the other side of its decision), each taking the
    call's arguments by name."""
    hs = lambda x, slope, offset: x * slope + offset
    pick = lambda x, idx: x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
    zero, full = torch.zeros_like, torch.full_like
    pieces = lambda x, lo, hi: (x > lo).to(torch.int8) + (x > hi).to(torch.int8)

    def argmax(x, kernel_size, stride, padding, ceil_mode, **_):
        return torch.nn.functional.max_pool2d(x, kernel_size, stride or kernel_size, padding,
                                              ceil_mode=ceil_mode, return_indices=True)[1]

    return {
        "relu": (lambda x: (x > 0).to(torch.int8),
                 lambda x, r: torch.where(r == 0, zero(x), x),
                 lambda x, r, m: x.abs()),
        "relu6": (lambda x: pieces(x, 0, 6),
                  lambda x, r: torch.where(r == 0, zero(x), torch.where(r == 1, x, full(x, 6.0))),
                  lambda x, r, m: torch.minimum(x.abs(), (x - 6).abs())),
        "hardswish": (lambda x: pieces(x, -3, 3),
                      lambda x, r: torch.where(r == 0, zero(x), torch.where(
                          r == 1, x * (x + 3.0) / 6.0, x)),
                      lambda x, r, m: torch.minimum((x + 3).abs(), (x - 3).abs())),
        "hardsigmoid": (lambda x, **a: pieces(hs(x, **a), 0, 1),
                        lambda x, r, **a: torch.where(r == 0, zero(x), torch.where(
                            r == 1, hs(x, **a), full(x, 1.0))),
                        lambda x, r, m, **a: torch.minimum(
                            hs(x, **a).abs(), (hs(x, **a) - 1).abs()) / a["slope"]),
        "max_pool2d": (argmax,
                       lambda x, r, **a: pick(x, r),
                       lambda x, r, m, **a: (pick(x, r) - pick(x, m)).abs()),
    }


@contextlib.contextmanager
def kink_decisions(ptt, decisions, force):
    """Wrap nn.functional's relu, relu6, hardswish, hardsigmoid and
    max_pool2d (the layers and the models' functional calls look them up
    there at call time): record each call's decisions (_kinks) into
    `decisions`, or (force) take the recorded ones, in call order. Yields
    the calls and the forced run's disagreements: their count and the
    largest distance to the other side over the input's rms."""
    import inspect

    F = ptt.nn.functional
    kinds = _kinks()
    originals = {k: getattr(F, k) for k in kinds}
    calls = iter(decisions)
    seen = dict(calls=0, disagree=0, worst_over_rms=0.0)

    def wrap(name):
        regions, value, gap = kinds[name]
        orig = originals[name]
        sig = inspect.signature(orig)

        def fn(*args, **kw):
            y = orig(*args, **kw)
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            a = dict(a.arguments)
            x, _ = a.pop("x"), a.pop("name", None)
            if name == "max_pool2d" and (a.pop("return_mask") or a.pop("data_format") != "NCHW"
                                         or isinstance(a["padding"], str)):
                return y
            xd = x.detach()
            mine = regions(xd, **a)
            seen["calls"] += 1
            if not force:
                decisions.append(mine.cpu())
                return y
            theirs = next(calls).to(x.device)
            diff = theirs != mine
            if not bool(diff.any()):
                return y
            seen["disagree"] += int(diff.sum())
            rms = xd.double().pow(2).mean().sqrt()
            seen["worst_over_rms"] = max(seen["worst_over_rms"],
                                         (gap(xd, theirs, mine, **a)[diff].max() / rms).item())
            return torch.where(diff, value(x, theirs, **a).to(y.dtype), y)

        return fn

    for k in kinds:
        setattr(F, k, wrap(k))
    try:
        yield seen
    finally:
        for k, f in originals.items():
            setattr(F, k, f)


def resnet_parity_run(ptt, ref_state, dev, amp, imgs, labels, masks=None, force=False):
    """resnet18(num_classes=10) on `dev` from `ref_state`: 2 steps through
    to_static (AMP O1 bf16 or f32) of Momentum(PiecewiseDecay([1], [0.01,
    0.005]) stepped each step, momentum 0.9, L2Decay(1e-4)). Returns the
    losses, the step-1 grads and the state before and after (CPU f32);
    with `masks`, the ReLU and max-pool decisions recorded into it or
    (force) taken from it (kink_decisions)."""
    from paddle_tpu_torch.vision.models import resnet18

    model = resnet18(num_classes=10)
    model.load_state_dict(ref_state)
    model.to(dev)
    sched = ptt.optimizer.lr.PiecewiseDecay([1], [0.01, 0.005])
    opt = ptt.optimizer.Momentum(sched, momentum=0.9, parameters=model.parameters(),
                                 weight_decay=ptt.regularizer.L2Decay(1e-4))

    @ptt.jit.to_static
    def step(x, y, keep_grads=False):
        with ptt.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            loss = ptt.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        grads = ({n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
                 if keep_grads else None)
        opt.step()
        opt.clear_grad()
        return loss, grads

    state = lambda: {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}
    before = state()
    x, y = imgs.to(dev), labels.to(dev)
    kinks = kink_decisions(ptt, masks, force) if masks is not None else contextlib.nullcontext()
    with kinks as seen:
        loss1, grads = step(x, y, keep_grads=True)
        sched.step()
        loss2, _ = step(x, y)
        sched.step()
    return dict(losses=[loss1.item(), loss2.item()], grads=grads, before=before, after=state(),
                decisions=seen)


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def resnet_dists(a, b) -> dict:
    """name -> (a's step-1 grad against b's, a's change over the run against
    b's), relative L2, for every param and BN buffer."""
    return {n: (_rel(a["grads"][n], b["grads"][n]) if n in b["grads"] else 0.0,
                _rel(a["after"][n] - a["before"][n], b["after"][n] - b["before"][n]))
            for n in b["after"]}


def resnet_parity(ptt):
    """resnet18 built once from seed 3, run on the card and on the CPU in
    f32 and in AMP O1 bf16 on one batch B4 3x64x64; the card against the
    CPU."""
    from paddle_tpu_torch.vision.models import resnet18

    ptt.set_device("cpu")  # the reference model and its weights on the host
    ptt.seed(3)
    ref_state = resnet18(num_classes=10).state_dict()
    ptt.set_device("cuda")
    rng = np.random.RandomState(4)
    imgs = torch.from_numpy(rng.randn(RESNET_PARITY_BATCH, 3, RESNET_PARITY_HW,
                                      RESNET_PARITY_HW).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, (RESNET_PARITY_BATCH,)).astype(np.int64))
    masks = []
    runs = {(dev, amp): resnet_parity_run(ptt, ref_state, dev, amp, imgs, labels)
            if amp or dev == "cpu" else
            resnet_parity_run(ptt, ref_state, dev, amp, imgs, labels, masks=masks)
            for amp in (False, True) for dev in ("cuda", "cpu")}
    # the f32 CPU run again, with the card's ReLU and max-pool decisions
    tied = resnet_parity_run(ptt, ref_state, "cpu", False, imgs, labels, masks=masks, force=True)
    rec = {}
    for amp in (False, True):
        card, cpu = runs[("cuda", amp)], runs[("cpu", amp)] if amp else tied
        loss_err = [abs(a - b) / cpu["losses"][0] for a, b in zip(card["losses"], cpu["losses"])]
        dist = resnet_dists(card, cpu)
        buffers_moved = all(not torch.equal(r["after"][n], r["before"][n]) for r in (card, cpu)
                            for n in r["after"] if n.endswith(("_mean", "_variance")))
        if not amp:
            tol = RESNET_F32_TOL
            worst_grad = max((g, n) for n, (g, _) in dist.items())
            worst_change = max((c, n) for n, (_, c) in dist.items())
            untied = resnet_dists(card, runs[("cpu", False)])
            ok = (max(loss_err) <= tol["loss"] and worst_grad[0] <= tol["grad"]
                  and worst_change[0] <= tol["change"]
                  and tied["decisions"]["worst_over_rms"] <= DECISION_TIE)
            rec["f32"] = dict(losses_card=card["losses"], losses_cpu=cpu["losses"],
                              loss_err=loss_err, worst_grad=worst_grad,
                              worst_change=worst_change, buffers_moved=buffers_moved,
                              decision_calls=len(masks),
                              decisions_disagree=tied["decisions"]["disagree"],
                              decisions_disagree_worst_over_rms=tied["decisions"][
                                  "worst_over_rms"],
                              worst_grad_own_decisions=max((g, n) for n, (g, _) in untied.items()),
                              tol=dict(tol, decision_tie=DECISION_TIE))
        else:
            noise = resnet_dists(cpu, runs[("cpu", False)])
            ratios = {n: max(dist[n][k] / max(noise[n][k], 1e-12) for k in (0, 1)) for n in dist}
            worst = max((r, n) for n, r in ratios.items())
            ok = (all(e <= t for e, t in zip(loss_err, RESNET_O1_LOSS))
                  and worst[0] <= RESNET_O1_NOISE_RATIO)
            rec["o1"] = dict(losses_card=card["losses"], losses_cpu=cpu["losses"],
                             loss_err=loss_err, worst_tensor=worst[1],
                             worst_over_cpu_noise=worst[0],
                             worst_tensor_card_vs_cpu=dist[worst[1]],
                             worst_tensor_cpu_o1_vs_f32=noise[worst[1]],
                             max_grad_card_vs_cpu=max(g for g, _ in dist.values()),
                             max_grad_cpu_o1_vs_f32=max(g for g, _ in noise.values()),
                             buffers_moved=buffers_moved,
                             tol=dict(loss=RESNET_O1_LOSS, noise_ratio=RESNET_O1_NOISE_RATIO))
        if not (ok and buffers_moved):
            raise AssertionError(f"resnet_parity: card and CPU runs disagree: {rec}")
    log("resnet_parity", model="resnet18", batch=RESNET_PARITY_BATCH,
        image=[3, RESNET_PARITY_HW, RESNET_PARITY_HW], steps=2, **rec)


def build_resnet(ptt, batch):
    """bench.py:1982-2006 (build_resnet_step) with the port: seed 0,
    resnet50(num_classes=1000), Momentum(0.1, weight_decay=1e-4), one
    seed-0 batch of randn images and labels, AMP O1 bf16; returns (model,
    the step through to_static, the same step eagerly, images, labels)."""
    from paddle_tpu_torch.vision.models import resnet50

    ptt.seed(0)
    model = resnet50(num_classes=1000)
    opt = ptt.optimizer.Momentum(0.1, parameters=model.parameters(), weight_decay=1e-4)
    rng = np.random.RandomState(0)
    imgs = ptt.to_tensor(rng.randn(batch, 3, 224, 224).astype(np.float32))
    labels = ptt.to_tensor(rng.randint(0, 1000, (batch,)).astype(np.int64))

    def step_body(imgs, labels):
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(imgs)
            loss = ptt.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, ptt.jit.to_static(step_body), step_body, imgs, labels, opt


def resnet_flops_per_image(ptt, model) -> float:
    """3 x 2 x the multiply-adds of every conv and of the fc at one
    224x224 image, from the model's own shapes (forward 1x, backward 2x)."""
    macs = []

    def hook(m, inp, out):
        if isinstance(m, ptt.nn.Conv2D):
            macs.append(out.numel() * m.weight[0].numel())
        else:
            macs.append(m.weight.numel())

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (ptt.nn.Conv2D, ptt.nn.Linear))]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, 224, 224, device=model.fc.weight.device))
    model.train()
    for h in hooks:
        h.remove()
    return 3 * 2 * float(sum(macs))


def profile_resnet(ptt, model, opt, imgs, labels, step_ms, steps=2):
    """Device time a step over `steps` of the bench's step (its body again,
    with profiler scopes around the forward, the optimizer and each batch
    norm's forward): forward, backward (the rest of the busy time) and
    optimizer; cuDNN conv forward and backward and the dtype casts by torch
    op; the batch norms' forward (scope) and their backward autograd nodes
    (VarMean, Rsqrt, Sub, Mul and Add backward; the residual adds' own Add
    nodes launch no kernel); the idle share against the host-clock
    `step_ms`; the top torch ops and kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.nn.layers import norm as norm_layers

    bn = norm_layers.batch_norm

    def scoped_bn(*a, **kw):
        with record_function("scope::batch_norm_forward"):
            return bn(*a, **kw)

    def step():
        with record_function("scope::forward"):
            with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = ptt.nn.functional.cross_entropy(model(imgs), labels)
        loss.backward()
        with record_function("scope::optimizer"):
            opt.step()
            opt.clear_grad()
        return loss

    norm_layers.batch_norm = scoped_bn
    try:
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    finally:
        norm_layers.batch_norm = bn
    bn_backward_nodes = ("VarMeanBackward0", "RsqrtBackward0", "SubBackward0", "MulBackward0",
                         "AddBackward0")
    busy, by_op, scopes, kernels, bn_bwd = 0.0, {}, {}, {}, 0.0
    for e in prof.key_averages():
        ms = lambda us: us / 1e3 / steps
        if e.key.startswith("scope::"):
            # a scope shows twice: its span on the device's timeline (not a
            # kernel: left out of the busy time) and, on the host, the
            # device time of the kernels launched inside it
            if e.device_type == torch.autograd.DeviceType.CPU:
                scopes[e.key[7:]] = ms(e.device_time_total)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            busy += ms(e.self_device_time_total)
            kernels[e.key[:90]] = ms(e.self_device_time_total)
        elif e.key.startswith("autograd::engine::evaluate_function: ") and \
                e.key.split(": ", 1)[1] in bn_backward_nodes:
            bn_bwd += ms(e.device_time_total)
        elif e.self_device_time_total > 0:
            by_op[e.key] = ms(e.self_device_time_total)
    top = lambda d, k: [[n, round(v, 3)] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
    fwd, opt_ms = scopes.get("forward", 0.0), scopes.get("optimizer", 0.0)
    return dict(steps=steps, step_ms=step_ms, device_busy_ms=busy,
                device_idle_share=1.0 - busy / step_ms,
                device_ms_per_step=dict(
                    forward=fwd, backward=busy - fwd - opt_ms, optimizer=opt_ms,
                    conv_fwd=by_op.get("aten::cudnn_convolution", 0.0),
                    conv_bwd=by_op.get("aten::convolution_backward", 0.0),
                    batch_norm_fwd=scopes.get("batch_norm_forward", 0.0),
                    batch_norm_bwd_nodes=bn_bwd, dtype_casts=by_op.get("aten::copy_", 0.0)),
                device_ms_by_torch_op=top(by_op, 14), top_kernels=top(kernels, 8))


def resnet50_train(ptt, ta, state, warmup=2, steps=10, eager_steps=4):
    """bench.py's ResNet-50 step at its own shape (batch 64, 3x224x224, 1000
    classes, all 50 layers): `warmup` steps, then `steps` timed to a
    synchronize through to_static, then `eager_steps` without it (the
    bench's dygraph number); MFU, peak memory and a profiled split."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, static_step, eager_step, imgs, labels, opt = build_resnet(ptt, RESNET_BATCH)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    losses = [static_step(imgs, labels) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [static_step(imgs, labels) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    losses += [eager_step(imgs, labels) for _ in range(eager_steps)]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / eager_steps
    launches = dict(ta.LAUNCHES)
    losses = [x.item() for x in losses]
    if any(launches.values()):
        raise AssertionError(f"resnet50_train: a hand-written kernel launched: {launches}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"resnet50_train: losses not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = resnet_flops_per_image(ptt, model)
    images_per_sec = RESNET_BATCH / (step_ms / 1e3)
    prof = profile_resnet(ptt, model, opt, imgs, labels, step_ms)
    state["resnet_launches"] = launches
    log("resnet50_train", batch=RESNET_BATCH, image=[3, 224, 224], classes=1000, layers=50,
        params_m=sum(p.numel() for p in model.parameters()) / 1e6,
        buffers=sum(1 for _ in model.buffers()), init_s=init_s, losses=losses,
        ms_per_step=step_ms, images_per_sec=images_per_sec,
        ms_per_step_dygraph=eager_ms, images_per_sec_dygraph=RESNET_BATCH / (eager_ms / 1e3),
        flops_per_image=flops, flops_per_step=flops * RESNET_BATCH,
        mfu=images_per_sec * flops / PEAK_FLOPS[torch.bfloat16],
        step_ms_at_peak=RESNET_BATCH * flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
        peak_mem_gb=peak, launches=launches)
    log("resnet50_train profile", **prof)
    del model, static_step, eager_step, opt
    torch.cuda.empty_cache()


# --- PP-OCR det+rec and PP-YOLOE (models/ocr.py, models/detection.py) --------
# Parity runs in f32 (TF32 off) held to resnet_parity's limits: losses and
# forward outputs within 1e-5, step-1 grads within 2e-3, relative L2. A grad
# that is 0 by construction (a bias feeding a batch norm) is rounding noise in
# both runs and is held to be noise (below 1e-6 of the model's largest grad).
OCR_TOL = dict(loss=RESNET_F32_TOL["loss"], out=RESNET_F32_TOL["loss"], grad=RESNET_F32_TOL["grad"])
# two 64x64 pages: one page's 2x2 stride-32 maps give each batch norm 4 values
# there, and f32 rounding alone then moves the binary map by ~3e-5 (CPU, f64)
PARITY_PAGES, PARITY_HW, PARITY_CROPS = 2, 64, 4
PPOCR_IMAGES, PPOCR_BOXES = 8, 3  # bench.py:2041 (_build_ppocr's n_images, n_boxes)
OCR_DET_BATCH, OCR_REC_BATCH, OCR_LABEL_LEN, OCR_HW = 8, 128, 10, 640
YOLO_BATCH, YOLO_HW = 8, 640


def slope_measure(run, steps, warm=3):
    """A copy of bench.py's _slope_measure (bench.py:245-255): `run(n)` does n
    iterations ending in a host fetch and returns (seconds, final value); the
    time a step is the slope between a short and a long run, so the constant
    fetch latency cancels."""
    run(warm)
    short = max(2, steps // 4)
    t_short, _ = run(short)
    t_long, final = run(steps)
    return (t_long - t_short) / (steps - short), final


def grads_of(model) -> dict:
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}


def grad_dists(card: dict, cpu: dict) -> tuple:
    """(worst relative L2 of a card grad against the CPU's, its name); a
    grad whose CPU norm is below 1e-6 of the largest (0 by construction)
    must be below that on the card too."""
    scale = max(g.norm().item() for g in cpu.values())
    worst = (0.0, "")
    for n, g in cpu.items():
        if g.norm().item() <= 1e-6 * scale:
            if card[n].norm().item() > 1e-6 * scale:
                raise AssertionError(f"{n}: a zero grad on the CPU is {card[n].norm().item()} on the card")
        else:
            worst = max(worst, (_rel(card[n], g), n))
    return worst


def hold(phase: str, dists: dict, tol: dict) -> None:
    """Raise unless every (value, limit key) in `dists` is within `tol`."""
    bad = {k: v for k, (v, key) in dists.items() if not v <= tol[key]}
    if bad:
        raise AssertionError(f"{phase}: card and CPU runs disagree: {bad} (limits {tol})")


def no_kernel_launched(ta, phase: str) -> dict:
    launches = dict(ta.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"{phase}: a hand-written kernel launched: {launches}")
    return launches


def ocr_parity_run(ptt, det_state, rec_state, dev, data, masks, force):
    """The tiny DBNet and CRNN from one state on `dev`: DBNet's train maps,
    db_loss and grads (the batch norms' momentum 0, so the buffers become the
    batch's statistics), then the eval prob map of a second pair of pages;
    CRNN's logits, CTC loss and grads; the CTC gradient of the logits from
    the port's ctc_loss and from torch's. The ReLU and max-pool decisions
    are recorded into `masks` or (force) taken from it, as resnet_parity's
    f32 runs take them."""
    from paddle_tpu_torch.models import ocr

    F = ptt.nn.functional
    det, rec = ocr.DBNet(8, 32), ocr.CRNN(num_classes=11, hidden_size=32)
    det.load_state_dict(det_state)
    rec.load_state_dict(rec_state)
    det.to(dev), rec.to(dev)
    with kink_decisions(ptt, masks, force) as seen:
        for m in det.modules():
            if isinstance(m, ptt.nn.BatchNorm2D):
                m._momentum = 0.0
        d = {k: v.to(dev) for k, v in data.items()}
        maps = det(d["page"])
        loss = ocr.db_loss(maps, d["gt_prob"], d["gt_thresh"], prob_mask=d["mask"],
                           thresh_mask=d["mask"])
        loss.backward()
        det.eval()
        with torch.no_grad():
            prob = det(d["page2"])
        logits = rec(d["crops"])
        lengths = torch.full((logits.shape[0],), logits.shape[1], dtype=torch.int64, device=dev)
        ctc = F.ctc_loss(F.log_softmax(logits.transpose(0, 1), axis=-1), d["labels"], lengths,
                         d["label_lengths"])
        ctc.backward()
        x = logits.detach().transpose(0, 1).contiguous()
        ctc_grads = []
        for fn in (F.ctc_loss, torch.nn.functional.ctc_loss):
            leaf = x.clone().requires_grad_(True)
            inp = leaf if fn is F.ctc_loss else torch.log_softmax(leaf, -1)
            fn(inp, d["labels"], lengths, d["label_lengths"]).backward()
            ctc_grads.append(leaf.grad.cpu())
    return dict(maps=maps.detach().cpu(), loss=loss.item(), det_grads=grads_of(det),
                prob=prob.cpu(), logits=logits.detach().cpu(), ctc=ctc.item(),
                rec_grads=grads_of(rec), ctc_grads=ctc_grads,
                decisions=seen)


def ocr_parity(ptt):
    """OCRSystem(DBNet(8, 32), CRNN(11, 32)) from one state on the card and
    on the CPU (the state moved to both); the host postprocess and decode
    of one numpy input, as a card tensor and as numpy."""
    from paddle_tpu_torch.models import ocr

    ptt.set_device("cpu")
    ptt.seed(3)
    det_state = ocr.DBNet(8, 32).state_dict()
    rec_state = ocr.CRNN(num_classes=11, hidden_size=32).state_dict()
    ptt.set_device("cuda")
    rng = np.random.RandomState(4)
    hw, n = PARITY_HW, PARITY_PAGES
    data = {k: torch.from_numpy(v) for k, v in dict(
        page=rng.rand(n, 3, hw, hw).astype(np.float32),
        page2=rng.rand(n, 3, hw, hw).astype(np.float32),
        gt_prob=(rng.rand(n, 1, hw, hw) > 0.8).astype(np.float32),
        gt_thresh=(0.3 + 0.4 * rng.rand(n, 1, hw, hw)).astype(np.float32),
        mask=(rng.rand(n, 1, hw, hw) > 0.1).astype(np.float32),
        crops=rng.rand(PARITY_CROPS, 3, 32, 100).astype(np.float32),
        labels=rng.randint(1, 11, (PARITY_CROPS, 5)).astype(np.int64),
        label_lengths=np.array([5, 3, 4, 1][:PARITY_CROPS], np.int64)).items()}
    masks = []
    card = ocr_parity_run(ptt, det_state, rec_state, "cuda", data, masks, False)
    cpu = ocr_parity_run(ptt, det_state, rec_state, "cpu", data, masks, True)
    if not cpu["decisions"]["worst_over_rms"] <= DECISION_TIE:
        raise AssertionError(f"ocr_parity: a ReLU or max pool decides otherwise on the card than "
                             f"on the CPU away from a tie: {cpu['decisions']} (limit {DECISION_TIE} "
                             "of the input's rms)")
    dists = dict(db_loss=(abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), "loss"),
                 ctc=(abs(card["ctc"] - cpu["ctc"]) / abs(cpu["ctc"]), "loss"),
                 train_maps=(_rel(card["maps"], cpu["maps"]), "out"),
                 eval_prob=(_rel(card["prob"], cpu["prob"]), "out"),
                 logits=(_rel(card["logits"], cpu["logits"]), "out"),
                 ctc_grad_vs_torch_on_card=(_rel(*card["ctc_grads"]), "grad"),
                 ctc_grad_card_vs_cpu=(_rel(card["ctc_grads"][0], cpu["ctc_grads"][0]), "grad"))
    worst_det, worst_rec = grad_dists(card["det_grads"], cpu["det_grads"]), \
        grad_dists(card["rec_grads"], cpu["rec_grads"])
    dists["det_grads"], dists["rec_grads"] = (worst_det[0], "grad"), (worst_rec[0], "grad")
    if not all(torch.isfinite(g).all() for g in card["rec_grads"].values()):
        raise AssertionError("ocr_parity: a CRNN grad through ctc_loss is not finite on the card")
    hold("ocr_parity", dists, OCR_TOL)
    # the host functions read a card tensor back: the same results as on numpy
    pm = rng.rand(n, 1, hw, hw).astype(np.float32) ** 3
    pm[0, 0, 5:12, 6:30], pm[1, 0, 20:35, 2:9] = 0.9, 0.7
    on_card = ocr.db_postprocess(torch.from_numpy(pm).cuda())
    on_host = ocr.db_postprocess(pm)
    dec_card = ocr.ctc_greedy_decode(card["logits"].cuda())
    dec_host = ocr.ctc_greedy_decode(card["logits"].numpy())
    if not (all(np.array_equal(a, b) for a, b in zip(on_card, on_host)) and dec_card == dec_host):
        raise AssertionError("ocr_parity: db_postprocess or ctc_greedy_decode differs on a card tensor")
    log("ocr_parity", pages=[n, 3, hw, hw], crops=[PARITY_CROPS, 3, 32, 100], frames=24,
        dists={k: v for k, (v, _) in dists.items()}, worst_det_grad=worst_det,
        worst_rec_grad=worst_rec, losses_card=[card["loss"], card["ctc"]],
        losses_cpu=[cpu["loss"], cpu["ctc"]], boxes=[len(b) for b in on_host],
        decision_calls=len(masks), decisions_disagree=cpu["decisions"]["disagree"],
        decisions_disagree_worst_over_rms=cpu["decisions"]["worst_over_rms"],
        tol=dict(OCR_TOL, decision_tie=DECISION_TIE))


def profile_calls(fns: dict, calls: int = 3, scopes=()) -> dict:
    """Device time a call of each fn in `fns` (name -> fn), over `calls`
    calls under torch.profiler: the busy time (the kernels' own), by torch
    op, and the device time inside each record_function scope in `scopes`."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy, by_op, in_scope = 0.0, {}, {}
        for e in prof.key_averages():
            ms = e.self_device_time_total / 1e3 / calls
            if e.key.startswith("scope::"):
                if e.device_type == torch.autograd.DeviceType.CPU:
                    in_scope[e.key[7:]] = e.device_time_total / 1e3 / calls
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                busy += ms
            elif ms > 0:
                by_op[e.key] = ms
        out[name] = dict(busy_ms=busy, scopes=in_scope, by_op=dict(
            sorted(by_op.items(), key=lambda kv: -kv[1])[:10]))
    return out


def lstm_scope():
    """A context in which every RNN time loop runs under the profiler scope
    `scope::lstm` (its step ops' device time)."""
    from torch.profiler import record_function

    from paddle_tpu_torch.nn.layers import rnn

    @contextlib.contextmanager
    def ctx():
        orig = rnn.RNN.forward

        def scoped(self, *a, **kw):
            with record_function("scope::lstm"):
                return orig(self, *a, **kw)

        rnn.RNN.forward = scoped
        try:
            yield
        finally:
            rnn.RNN.forward = orig

    return ctx()


def sharpen_for_boxes(ptt, det, page):
    """Untrained, DBNet's eval prob map is 0.5 everywhere (the batch norms'
    buffers are their init's), and db_postprocess finds no box. For a run
    that crops: the buffers set to one train pass's statistics over `page`
    (momentum 0) and the prob branch's last transposed conv sharpened
    (weight x10, bias 0.4), as tests/test_torch_ocr.py does at 64x64."""
    bns = [m for m in det.modules() if isinstance(m, ptt.nn.BatchNorm2D)]
    saved = [m._momentum for m in bns]
    for m in bns:
        m._momentum = 0.0
    det.train()
    with torch.no_grad():
        det(page)
        det.head.prob[6].weight.mul_(10.0)
        det.head.prob[6].bias.fill_(0.4)
    for m, mom in zip(bns, saved):
        m._momentum = mom
    det.eval()


def ppocr_e2e(ptt, ta, state):
    """bench.py:2041-2093 (_build_ppocr) as written, on the port: OCRSystem()
    at its defaults (DBNet base 16 / neck 96, CRNN 37 classes / hidden 96),
    eval, a seed-0 1x3x640x640 page and 3 crops of 3x32x100; det (forward +
    db_postprocess) and rec (CRNN + ctc_greedy_decode) under to_static, each
    timed by the bench's slope over 8 images. Then the device time a call by
    op kind, the host postprocess, and OCRSystem.forward(page) end to end."""
    from paddle_tpu_torch.models.ocr import OCRSystem, ctc_greedy_decode, db_postprocess

    ptt.seed(0)
    sys_ = OCRSystem()
    sys_.eval()
    rng = np.random.RandomState(0)
    img = ptt.to_tensor(rng.rand(1, 3, 640, 640).astype(np.float32))
    crops = ptt.to_tensor(rng.rand(PPOCR_BOXES, *sys_.rec_image_shape).astype(np.float32))
    det_fwd = ptt.jit.to_static(lambda im: sys_.det(im))
    rec_fwd = ptt.jit.to_static(lambda c: sys_.rec(c))

    def det_once():
        return db_postprocess(det_fwd(img))

    def rec_once():
        return ctc_greedy_decode(rec_fwd(crops))

    def measure(fn, n_steps):
        def run(n):
            t0 = time.perf_counter()
            out = None
            for _ in range(n):
                out = fn()  # both end host-side (numpy postprocess)
            return time.perf_counter() - t0, out

        return slope_measure(run, n_steps, warm=2)[0]

    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    det_s = measure(det_once, PPOCR_IMAGES)
    rec_s = measure(rec_once, PPOCR_IMAGES)
    launches = no_kernel_launched(ta, "ppocr_e2e")
    e2e = det_s + rec_s
    rec_logits = rec_fwd(crops)
    if tuple(rec_logits.shape) != (PPOCR_BOXES, 24, 37) or not torch.isfinite(rec_logits).all():
        raise AssertionError(f"ppocr_e2e: rec logits {tuple(rec_logits.shape)} not finite/shaped")
    with lstm_scope():
        prof = profile_calls({"det": det_once, "rec": rec_once})
    prob = det_fwd(img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        db_postprocess(prob.detach().cpu().numpy())
    post_ms = (time.perf_counter() - t0) * 1e3 / 5
    t0 = time.perf_counter()
    for _ in range(5):
        ctc_greedy_decode(rec_logits.detach().cpu().numpy())
    decode_ms = (time.perf_counter() - t0) * 1e3 / 5
    split = {}
    for name, wall in (("det", det_s * 1e3), ("rec", rec_s * 1e3)):
        p = prof[name]
        split[name] = dict(
            wall_ms=wall, device_busy_ms=p["busy_ms"], device_idle_share=1.0 - p["busy_ms"] / wall,
            cudnn_conv_ms=p["by_op"].get("aten::cudnn_convolution", 0.0),
            transposed_conv_ms=p["by_op"].get("aten::cudnn_convolution_transpose", 0.0),
            lstm_step_ops_ms=p["scopes"].get("lstm", 0.0), top_ops=p["by_op"])
    split["det"]["postprocess_host_ms"] = post_ms
    split["rec"]["decode_host_ms"] = decode_ms
    # OCRSystem.forward end to end (host crop and resize included): at the
    # defaults, then with a prob map that has boxes
    full = {}
    for case in ("defaults", "sharpened"):
        if case == "sharpened":
            sharpen_for_boxes(ptt, sys_.det, img)
        sys_(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sys_(img)
        full[case] = dict(ms=(time.perf_counter() - t0) * 1e3, boxes=len(res[0]),
                          labels_sample=[lab for _, lab in res[0][:3]])
    state["ppocr_launches"] = launches
    log("ppocr_e2e", page=[1, 3, 640, 640], rec_boxes=PPOCR_BOXES, n_images=PPOCR_IMAGES,
        det_ms_per_image=det_s * 1e3, rec_ms_per_batch=rec_s * 1e3, ms_per_image_e2e=e2e * 1e3,
        images_per_sec=1.0 / e2e, params_m=sum(p.numel() for p in sys_.parameters()) / 1e6,
        launches=launches)
    log("ppocr_e2e profile", **split)
    log("ppocr_e2e OCRSystem.forward", **full)
    del sys_, det_fwd, rec_fwd
    torch.cuda.empty_cache()


def train_timed(step, steps):
    """`steps` calls of `step` (-> loss, all-grads-finite flag, both on the
    card): the first untimed, the rest timed to a synchronize; -> (ms a
    step, losses, flags), read after the run."""
    out = [step()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out += [step() for _ in range(steps - 1)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    return ms, [l.item() for l, _ in out], [bool(f) for _, f in out]


def adam_step(model, opt, loss_fn):
    """One step: loss, backward, a flag that every grad is finite (on the
    card, read later), Adam, clear."""

    def step():
        loss = loss_fn()
        loss.backward()
        finite = torch.stack([torch.isfinite(p.grad).all() for p in model.parameters()]).all()
        opt.step()
        opt.clear_grad()
        return loss.detach(), finite

    return step


def ocr_train(ptt, ta, state, steps=5):
    """Both OCR models at their default widths, 5 Adam (1e-3) steps each on
    one seeded batch, per tensor (FLAGS_fused_optimizer off, its default): DBNet with db_loss at B8 3x640x640, CRNN with CTC at
    B128 3x32x100 (24 frames, labels of 10 classes in 1..36). Every loss and
    every grad finite (the CTC's too)."""
    from paddle_tpu_torch.models.ocr import CRNN, DBNet, db_loss

    F = ptt.nn.functional
    rng = np.random.RandomState(0)
    recs = {}
    ptt.set_flags({"FLAGS_fused_optimizer": False})  # the default; earlier phases turn it on
    ptt.seed(0)
    b, hw = OCR_DET_BATCH, OCR_HW
    imgs = ptt.to_tensor(rng.rand(b, 3, hw, hw).astype(np.float32))
    gt_prob = ptt.to_tensor((rng.rand(b, 1, hw, hw) > 0.8).astype(np.float32))
    gt_thresh = ptt.to_tensor((0.3 + 0.4 * rng.rand(b, 1, hw, hw)).astype(np.float32))
    crops = ptt.to_tensor(rng.rand(OCR_REC_BATCH, 3, 32, 100).astype(np.float32))
    labels = ptt.to_tensor(rng.randint(1, 37, (OCR_REC_BATCH, OCR_LABEL_LEN)).astype(np.int64))
    lengths = ptt.to_tensor(np.full(OCR_REC_BATCH, 24, np.int64))
    label_lengths = ptt.to_tensor(np.full(OCR_REC_BATCH, OCR_LABEL_LEN, np.int64))
    for name in ("dbnet", "crnn"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = DBNet() if name == "dbnet" else CRNN()
        opt = ptt.optimizer.Adam(1e-3, parameters=model.parameters())
        if name == "dbnet":
            loss_fn, batch = (lambda: db_loss(model(imgs), gt_prob, gt_thresh)), b
        else:
            loss_fn = lambda: F.ctc_loss(F.log_softmax(model(crops).transpose(0, 1), axis=-1),
                                         labels, lengths, label_lengths)
            batch = OCR_REC_BATCH
        ta.reset_launch_counts()
        ms, losses, finite = train_timed(adam_step(model, opt, loss_fn), steps)
        launches = no_kernel_launched(ta, f"ocr_train {name}")
        if not (all(math.isfinite(x) for x in losses) and all(finite)):
            raise AssertionError(f"ocr_train {name}: losses {losses}, grads finite {finite}")
        recs[name] = dict(batch=batch, ms_per_step=ms, images_per_sec=batch / (ms / 1e3),
                          losses=losses, grads_finite=finite,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          params_m=sum(p.numel() for p in model.parameters()) / 1e6,
                          launches=launches)
        del model, opt
    state["ocr_train_launches"] = recs["crnn"]["launches"]
    log("ocr_train", steps=steps, dbnet_image=[3, hw, hw], crnn_image=[3, 32, 100],
        label_len=OCR_LABEL_LEN, **recs)
    torch.cuda.empty_cache()


def yolo_targets(outs, seed=1) -> list:
    """Dense targets per level on the outputs' device: one-hot-ish class
    maps (10% ones), distances U(0, 1), 30% positive cells."""
    rng = np.random.RandomState(seed)
    dev = outs[0][0].device
    targets = []
    for cls, _ in outs:
        b, c, h, w = cls.shape
        t = dict(cls=(rng.rand(b, c, h, w) > 0.9), box=rng.rand(b, 4, h, w),
                 mask=(rng.rand(b, 1, h, w) > 0.7))
        targets.append({k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in t.items()})
    return targets


def yolo_parity_run(ptt, state_dict, dev, x):
    """PPYOLOE(4, 8, 32) from one state on `dev`: train forward,
    ppyoloe_loss and grads, then infer (eval) with its decode's output."""
    from paddle_tpu_torch.models.detection import PPYOLOE, ppyoloe_loss

    model = PPYOLOE(num_classes=4, base_channels=8, neck_channels=32)
    model.load_state_dict(state_dict)
    model.to(dev)
    outs = model(x.to(dev))
    loss = ppyoloe_loss(outs, yolo_targets(outs), 4)
    loss.backward()
    decoded = []
    decode = model.decode
    model.decode = lambda o: decoded.append(decode(o)) or decoded[-1]
    rows = model.infer(x.to(dev))
    (boxes, scores), = decoded
    return dict(outs=torch.cat([torch.cat([c.flatten(), r.flatten()]) for c, r in outs]).detach().cpu(),
                loss=loss.item(), grads=grads_of(model), boxes=boxes.cpu(), scores=scores.cpu(),
                rows=rows)


def nms_of(boxes, scores, score_thresh=0.4, iou_thresh=0.5, top_k=100):
    """infer's filter and class-aware nms for one image, on its device."""
    from paddle_tpu_torch.vision.ops import nms

    conf, cls_id = scores.max(-1)
    keep = conf >= score_thresh
    return nms(boxes[keep], iou_thresh, scores=conf[keep], category_idxs=cls_id[keep],
               top_k=top_k), int(keep.sum())


def ppyoloe(ptt, ta, state, steps=5):
    """PPYOLOE: the tiny model card against CPU; then PPYOLOE() at its
    defaults (80 classes, base 32, neck 96): B1 640x640 inference at the
    default thresholds (forward, decode and nms timed, nms's n and sweeps,
    its indices against the CPU port's on the same boxes), and B8 640x640
    training with ppyoloe_loss, 5 Adam steps."""
    from paddle_tpu_torch.models.detection import PPYOLOE, ppyoloe_loss
    from paddle_tpu_torch.vision import ops as vops

    ptt.set_device("cpu")
    ptt.seed(5)
    tiny = PPYOLOE(num_classes=4, base_channels=8, neck_channels=32).state_dict()
    ptt.set_device("cuda")
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 64, 64).astype(np.float32))
    card, cpu = (yolo_parity_run(ptt, tiny, dev, x) for dev in ("cuda", "cpu"))
    worst = grad_dists(card["grads"], cpu["grads"])
    dists = dict(loss=(abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), "loss"),
                 outputs=(_rel(card["outs"], cpu["outs"]), "out"),
                 boxes=(_rel(card["boxes"], cpu["boxes"]), "out"),
                 scores=(_rel(card["scores"], cpu["scores"]), "out"), grads=(worst[0], "grad"))
    hold("ppyoloe parity", dists, OCR_TOL)
    rows_equal = [a.shape == b.shape and np.array_equal(a[:, 5], b[:, 5])
                  for a, b in zip(card["rows"], cpu["rows"])]
    if not all(rows_equal):
        raise AssertionError(f"ppyoloe parity: infer kept other boxes on the card: {rows_equal}")
    parity = dict(dists={k: v for k, (v, _) in dists.items()}, worst_grad=worst,
                  kept=[len(r) for r in card["rows"]])

    # inference at full width, B1 640x640
    gc.collect()
    torch.cuda.empty_cache()
    ptt.seed(0)
    model = PPYOLOE()
    model.eval()
    img = ptt.to_tensor(np.random.RandomState(0).randn(1, 3, YOLO_HW, YOLO_HW).astype(np.float32))
    ta.reset_launch_counts()
    results = model.infer(img)  # the entry point, once (warm-up)
    with torch.no_grad():
        outs = model(img)
        boxes, scores = model.decode(outs)
        nms_of(boxes[0], scores[0])
    timing = {}
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = model(img)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            boxes, scores = model.decode(outs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            keep, n = nms_of(boxes[0], scores[0])
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            sweeps = vops.LAST_SWEEPS
            timing = dict(forward_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
                          nms_ms=(t3 - t2) * 1e3, nms_n=n, nms_sweeps=sweeps, kept=int(keep.numel()))
        timing["infer_ms"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = model.infer(img)
            timing["infer_ms"].append((time.perf_counter() - t0) * 1e3)
    launches = no_kernel_launched(ta, "ppyoloe infer")
    t0 = time.perf_counter()
    keep_cpu, _ = nms_of(boxes[0].cpu(), scores[0].cpu())
    timing["nms_cpu_port_ms"] = (time.perf_counter() - t0) * 1e3
    if not torch.equal(keep.cpu(), keep_cpu):
        raise AssertionError("ppyoloe: the card's nms indices differ from the CPU port's")
    if not (results[0].shape == (timing["kept"], 6) and np.isfinite(results[0]).all()):
        raise AssertionError(f"ppyoloe: infer gave {results[0].shape}, expected {timing['kept']} rows")
    del model, outs, boxes, scores

    # training at full width, B8 640x640
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ptt.set_flags({"FLAGS_fused_optimizer": False})
    ptt.seed(0)
    model = PPYOLOE()
    opt = ptt.optimizer.Adam(1e-3, parameters=model.parameters())
    imgs = ptt.to_tensor(np.random.RandomState(1).randn(YOLO_BATCH, 3, YOLO_HW, YOLO_HW)
                         .astype(np.float32))
    with torch.no_grad():
        targets = yolo_targets(model(imgs))
    ta.reset_launch_counts()
    ms, losses, finite = train_timed(
        adam_step(model, opt, lambda: ppyoloe_loss(model(imgs), targets, 80)), steps)
    train_launches = no_kernel_launched(ta, "ppyoloe train")
    if not (all(math.isfinite(v) for v in losses) and all(finite)):
        raise AssertionError(f"ppyoloe train: losses {losses}, grads finite {finite}")
    train = dict(batch=YOLO_BATCH, ms_per_step=ms, images_per_sec=YOLO_BATCH / (ms / 1e3),
                 losses=losses, grads_finite=finite,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    state["ppyoloe_launches"] = {**launches, **train_launches}
    log("ppyoloe", parity=parity, image=[3, YOLO_HW, YOLO_HW], classes=80,
        params_m=sum(p.numel() for p in model.parameters()) / 1e6, infer_b1=timing,
        nms_indices_equal_cpu_port=True, train=train, launches=launches)
    del model, opt
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The paddle op surface (ops/{creation,math,manipulation,logic,search,linalg,
# einsum,inplace}.py, methods in ops/_patch.py) and ERNIE sequence
# classification, BASELINE.json configs[1] (PaddleNLP's fine-tune loop).
# ---------------------------------------------------------------------------

def _tests_module(name):
    """A numpy/torch-only module of this checkout's tests/ directory (the
    parity tables, the seq2seq model)."""
    import importlib

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    return importlib.import_module(name)


def _same(got, want, tol) -> str:
    """'' when the card's `got` matches the CPU's `want`, else the difference."""
    if not isinstance(want, torch.Tensor):
        return "" if got == want else f"{got!r} != {want!r}"
    if got.dtype != want.dtype or got.shape != want.shape:
        return f"{got.dtype}{tuple(got.shape)} != {want.dtype}{tuple(want.shape)}"
    if not (want.is_floating_point() or want.is_complex()):
        return "" if torch.equal(got, want) else "integer results differ"
    g, w = got.to(torch.complex128 if want.is_complex() else torch.float64), \
        want.to(torch.complex128 if want.is_complex() else torch.float64)
    ok = torch.allclose(g, w, rtol=tol["rtol"], atol=tol["atol"], equal_nan=True)
    return "" if ok else f"max |diff| {(g - w).abs().max().item():.3g}"


def widened_calls(fn) -> dict:
    """Calls of each widened Tensor method (ops/_patch.py WIDENED) while fn() runs."""
    from paddle_tpu_torch.ops import _patch

    counts, saved = dict.fromkeys(_patch.WIDENED, 0), {}
    for name in _patch.WIDENED:
        saved[name] = meth = getattr(torch.Tensor, name)

        def counted(self, *a, _m=meth, _n=name, **k):
            counts[_n] += 1
            return _m(self, *a, **k)

        setattr(torch.Tensor, name, counted)
    try:
        fn()
    finally:
        for name, meth in saved.items():
            setattr(torch.Tensor, name, meth)
    return counts


def table_on_card(ptt, tab, cases, phase):
    """Each (row, bf16) case of a parity table run by the port on the card
    and on the CPU (gradients for the float rows), held to the row's
    tolerance; raises naming every row that differs. Returns (cases, cases
    with gradients)."""
    bad, n_cases, n_grads = [], 0, 0
    for row, bf16 in cases:
        dtype = torch.bfloat16 if bf16 else None
        tol = tab.TOL["bf16" if bf16 else row.tol]
        gtol = tab.TOL["bf16_grad" if bf16 else row.tol + "_grad"]
        res = {}
        for dev in ("cuda", "cpu"):
            ptt.set_device(dev)
            try:
                res[dev] = tab.run_port(ptt, row, dev, dtype)
            except Exception as e:  # noqa: BLE001 - every failing row is reported below
                res[dev] = e
        ptt.set_device("cuda")
        n_cases += 1
        label = row.id + ("-bf16" if bf16 else "")
        if isinstance(res["cuda"], Exception) or isinstance(res["cpu"], Exception):
            bad.append(f"{label}: raised {res['cuda']!r} / {res['cpu']!r}")
            continue
        (go, gg), (wo, wg) = res["cuda"], res["cpu"]
        diffs = [_same(g, w, tol) for g, w in zip(go, wo)] + (
            [] if len(go) == len(wo) else [f"{len(go)} outputs != {len(wo)}"])
        if wg is not None:
            n_grads += 1
            diffs += [_same(g, w, gtol) for g, w in zip(gg, wg)
                      if not (g is None and w is None)]
        if any(diffs):
            bad.append(f"{label}: {[d for d in diffs if d]}")
    if bad:
        raise AssertionError(f"{phase}: {len(bad)} of {n_cases} rows differ between the card "
                             f"and the CPU: {bad}")
    return n_cases, n_grads


def op_surface(ptt):
    """Every row of the parity table on the card against the port on the
    CPU (f32; bf16 rows also in bf16; gradients for the float rows), the
    random ops' determinism and moments on the card, the widened methods'
    torch forms against the saved C methods, and the host microseconds a
    widened method adds to a call."""
    tab = _tests_module("torch_op_table")
    from paddle_tpu_torch.ops import _patch

    t0 = time.perf_counter()
    n_cases, n_grads = table_on_card(ptt, tab, [(r, False) for r in tab.ROWS + tab.INPLACE_ROWS]
                                     + [(r, True) for r in tab.ROWS if r.bf16], "op_surface")
    table_s = time.perf_counter() - t0
    # random ops on the card: the same draws after seed(), and their moments
    n = 1 << 20
    rand_rec = {}
    for name, fn, mean, std in (
            ("rand", lambda: ptt.rand([n]), 0.5, 12 ** -0.5),
            ("randn", lambda: ptt.randn([n]), 0.0, 1.0),
            ("normal", lambda: ptt.normal(1.0, 2.0, [n]), 1.0, 2.0),
            ("randint", lambda: ptt.randint(0, 10, [n]), 4.5, (99 / 12) ** 0.5),
            ("bernoulli", lambda: ptt.bernoulli(ptt.full([n], 0.3)), 0.3, 0.21 ** 0.5),
            ("poisson", lambda: ptt.poisson(ptt.full([n], 4.0)), 4.0, 2.0),
            ("standard_gamma", lambda: ptt.standard_gamma(ptt.full([n], 2.0)), 2.0, 2 ** 0.5),
            ("multinomial", lambda: ptt.multinomial(ptt.to_tensor([0.1, 0.2, 0.7]), n, True),
             1.6, 0.44 ** 0.5),
            ("uniform_", lambda: ptt.uniform_(torch.empty(n, device="cuda"), -1.0, 3.0), 1.0,
             4 * 12 ** -0.5)):
        ptt.seed(7)
        a = fn()
        ptt.seed(7)
        b = fn()
        v = a.double()
        m_err, s_err = abs(v.mean().item() - mean) / (std / n ** 0.5), abs(v.std().item() - std) / std
        rand_rec[name] = dict(mean=v.mean().item(), std=v.std().item(), mean_err_in_se=m_err,
                              std_rel_err=s_err)
        if a.device.type != "cuda" or not torch.equal(a, b) or m_err > 5 or s_err > 0.01:
            raise AssertionError(f"op_surface: random op {name} on the card: {rand_rec[name]}")
    # the widened methods: torch's forms give the saved C methods' results on the card
    x = torch.arange(24.0, device="cuda").reshape(2, 3, 4)
    for name, args, kwargs in tab.TORCH_FORMS:
        args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)
        kwargs = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
        got, want = getattr(x, name)(*args, **kwargs), _patch.TORCH_METHODS[name](x, *args, **kwargs)
        if not torch.equal(got, want):
            raise AssertionError(f"op_surface: widened {name}{args} differs from torch's")
    # host microseconds a call: the widened method against the saved C method
    calls = 20000
    forms = {"transpose": ((0, 1), {}), "unsqueeze": ((1,), {}),
             "gather": ((2, torch.zeros(2, 3, 1, dtype=torch.int64, device="cuda")), {}),
             "index_select": ((0, torch.tensor([1], device="cuda")), {}), "reshape": ((6, 4), {}),
             "expand": ((5, 2, 3, 4), {}), "tile": ((2, 1, 1), {})}
    host_us = {}
    for name, (args, kwargs) in forms.items():
        widened, saved = getattr(torch.Tensor, name), _patch.TORCH_METHODS[name]
        per = {}
        for label, meth in (("saved", saved), ("widened", widened), ("saved2", saved),
                            ("widened2", widened)):
            t1 = time.perf_counter()
            for _ in range(calls):
                meth(x, *args, **kwargs)
            per[label] = (time.perf_counter() - t1) / calls * 1e6
        torch.cuda.synchronize()
        host_us[name] = dict(saved_us=min(per["saved"], per["saved2"]),
                             widened_us=min(per["widened"], per["widened2"]),
                             added_us=min(per["widened"], per["widened2"])
                             - min(per["saved"], per["saved2"]))
    log("op_surface", rows=n_cases, rows_with_grads=n_grads, table_s=table_s,
        tol={k: v for k, v in tab.TOL.items()}, random=rand_rec,
        torch_forms=len(tab.TORCH_FORMS), widened_host_us=host_us)


CLS_BATCH, CLS_SEQ, CLS_STEPS, CLS_LR = 32, 128, 20, 2e-5  # PaddleNLP's ERNIE fine-tune lr


def cls_batches(rng, n, batch, seq, vocab, padded=True):
    """PaddleNLP-style classification batches: a [CLS] id 1 first, per-row
    lengths in [seq / 4, seq] (padded) padded with id 0, and a random label
    that tokens 1-8 spell out (id 2 or 3 against random ids from 4 up): a
    separable task, so a fine-tune's loss falls within a few epochs."""
    out = []
    for _ in range(n):
        lens = rng.randint(seq // 4, seq + 1, batch) if padded else np.full(batch, seq)
        labels = rng.randint(0, 2, batch).astype(np.int64)
        ids = rng.randint(4, vocab, (batch, seq)).astype(np.int64)
        ids[:, 0] = 1
        ids[:, 1:9] = 2 + labels[:, None]
        ids[np.arange(seq)[None, :] >= lens[:, None]] = 0
        out.append((ids, labels, int(lens.sum())))
    return out


def cls_finetune_step(ptt, model, opt, sched, keep_grads=False, level="O1"):
    """One step of the fine-tune loop: to_static, AMP O1 bf16, the padding
    mask when the batch holds padding, cross_entropy, AdamW, LinearWarmup."""

    @ptt.jit.to_static
    def step(ids, labels, masked=True):
        with ptt.amp.auto_cast(level=level, dtype="bfloat16"):
            logits = model(ids, attention_mask=(ids != 0).astype("int64") if masked else None)
            loss = ptt.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        grads = ({n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
                  if p.grad is not None} if keep_grads else None)
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss, grads

    return step


def cls_eval(ptt, model, batches):
    """Eval through the op surface (argmax, equal, cast, sum, metric.Accuracy):
    (accuracy, the metric's accuracy, the mean loss), without dropout."""
    model.eval()
    metric = ptt.metric.Accuracy()
    correct = total = 0
    loss = 0.0
    with ptt.no_grad():
        for ids, labels, _ in batches:
            ids, labels = ptt.to_tensor(ids), ptt.to_tensor(labels)
            logits = model(ids, attention_mask=ptt.cast(ids != 0, "int64"))
            loss += float(ptt.nn.functional.cross_entropy(logits, labels)) / len(batches)
            pred = ptt.argmax(logits, axis=-1)
            correct += int(ptt.sum(ptt.cast(ptt.equal(pred, labels), "int64")))
            total += int(labels.shape[0])
            metric.update(metric.compute(logits, ptt.unsqueeze(labels, -1)))
    model.train()
    return correct / total, metric.accumulate(), loss


def ernie_cls_parity(ptt, ta):
    """A tiny ErnieForSequenceClassification (hidden 256, 4 heads of 64) on
    the card and on the CPU from one state: 2 fine-tune steps at the
    fine-tune lr (padded batches and a mask: the plain attention chain; the
    fused AdamW, a bf16 moment2, the same stochastic-rounding seeds), then
    the eval; ernie_parity's limits (params in units of that lr). A step-1
    grad off by more than TRAIN_GRAD_REL passes only within the O1 noise
    rule of resnet_parity: its distance from the CPU's f32 grad at most
    RESNET_O1_NOISE_RATIO x the CPU O1 grad's own distance from it."""
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification, ErnieModel

    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(3)
    ref = ErnieForSequenceClassification(ErnieModel(**TINY_ERNIE), num_classes=2, dropout=0.0)
    batches = cls_batches(np.random.RandomState(4), 3, 4, 64, TINY_ERNIE["vocab_size"])
    runs = {}
    for run, dev, level, n_steps in (("cuda", "cuda", "O1", 2), ("cpu", "cpu", "O1", 2),
                                     ("cpu_f32", "cpu", "O0", 1)):
        ptt.set_device(dev)
        model = copy.deepcopy(ref).to(dev)
        sched = ptt.optimizer.lr.LinearWarmup(CLS_LR, 1, 0.5 * CLS_LR, CLS_LR)
        opt = ptt.optimizer.AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                                  moment2_dtype="bfloat16")
        step = cls_finetune_step(ptt, model, opt, sched, keep_grads=True, level=level)
        ptt.seed(11)  # the same stochastic-rounding seeds on both sides
        ta.reset_launch_counts()
        losses, grads = [], None
        for ids, labels, _ in batches[:n_steps]:
            loss, g = step(ptt.to_tensor(ids), ptt.to_tensor(labels))
            losses.append(loss.item())
            grads = grads or g
        launches = {k: v for k, v in ta.LAUNCHES.items() if v}
        acc = cls_eval(ptt, model, batches[2:])[:2]
        runs[run] = dict(losses=losses, grads=grads, launches=launches, acc=acc,
                         params={n: p.detach().float().cpu() for n, p in model.named_parameters()})
    ptt.set_device("cuda")
    card, cpu, f32 = runs["cuda"], runs["cpu"], runs["cpu_f32"]["grads"]
    if card["launches"] != {"fused_adamw": 2} or cpu["launches"]:
        raise AssertionError(f"ernie_cls_parity: launches card {card['launches']}, cpu "
                             f"{cpu['launches']}; expected 2 fused_adamw (masked: no flash)")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    # a leaf whose true gradient is 0 (the key bias: a shift of every key by
    # b moves one query's scores by the same q.b, which the softmax ignores)
    # holds each device's rounding noise only (ernie_parity's rule)
    def query_bias_norm(n):
        layer = re.match(r".*\.layers\.\d+\.", n)
        return cpu["grads"][layer.group(0) + "self_attn.q_proj.bias"].norm().item() if layer else None

    ref_norm = {n: query_bias_norm(n) for n in cpu["grads"]}
    zero_grad = sorted(n for n, g in cpu["grads"].items()
                       if ref_norm[n] and g.norm().item() < ZERO_GRAD_NOISE * ref_norm[n])
    zero_grad_noise = max((r["grads"][n].norm().item() / ref_norm[n] for r in (card, cpu)
                           for n in zero_grad), default=0.0)
    grad_rel, o1_noise = {}, {}
    for n, g in cpu["grads"].items():
        if n in zero_grad:
            continue
        grad_rel[n] = ((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
        if grad_rel[n] > TRAIN_GRAD_REL:  # the card's distance from f32 against the CPU's own
            o1_noise[n] = ((card["grads"][n] - f32[n]).norm()
                           / (g - f32[n]).norm().clamp_min(1e-30)).item()
    dp = torch.cat([(card["params"][n] - w).abs().reshape(-1) for n, w in cpu["params"].items()])
    rec = dict(losses_card=card["losses"], losses_cpu=cpu["losses"], loss_max_rel_err=loss_rel,
               grad_max_rel_l2_err=max(grad_rel.values()), zero_grad_leaves=zero_grad,
               zero_grad_over_query_bias=zero_grad_noise,
               over_grad_rel_o1_noise_ratio=o1_noise,
               param_max_abs_diff_over_lr=dp.max().item() / CLS_LR,
               param_mean_abs_diff_over_lr=dp.mean().item() / CLS_LR,
               eval_acc_card=card["acc"], eval_acc_cpu=cpu["acc"],
               tol=dict(loss_rel=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL,
                        o1_noise_ratio=RESNET_O1_NOISE_RATIO,
                        zero_grad_over_query_bias=ZERO_GRAD_NOISE,
                        param_max_over_lr=TRAIN_PARAM_MAX_OVER_LR,
                        param_mean_over_lr=TRAIN_PARAM_MEAN_OVER_LR))
    if not (loss_rel <= TRAIN_LOSS_RTOL
            and all(v <= RESNET_O1_NOISE_RATIO for v in o1_noise.values())
            and zero_grad_noise <= ZERO_GRAD_NOISE
            and rec["param_max_abs_diff_over_lr"] <= TRAIN_PARAM_MAX_OVER_LR
            and rec["param_mean_abs_diff_over_lr"] <= TRAIN_PARAM_MEAN_OVER_LR
            and set(card["grads"]) == set(cpu["grads"])):
        raise AssertionError(f"ernie_cls_parity: card and CPU runs disagree: {rec}")
    log("ernie_cls_parity", layers=TINY_ERNIE["num_hidden_layers"],
        hidden=TINY_ERNIE["hidden_size"], launches=card["launches"], steps=2,
        padding_ids=int(sum((b[0] == 0).sum() for b in batches[:2])), **rec)


def ernie_finetune(ptt, ta, state):
    """BASELINE.json configs[1]: ErnieForSequenceClassification(ernie_3_0_base(),
    num_classes=2), dropout 0.1, B32 S128 PaddleNLP-padded batches with an
    attention_mask (the plain attention chain, as the JAX package takes it),
    AdamW 2e-5 wd 0.01 under LinearWarmup (2 of 20 steps) with
    FLAGS_fused_optimizer (B5), each step through to_static under AMP O1
    bf16; 20 steps over 4 batches (5 epochs), an eval of 4 held-out batches;
    then 5 steps on unpadded full-length batches without a mask (B1-B3).
    The loss falls: its mean over the 4 training batches without dropout,
    before the steps and after."""
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification, ernie_3_0_base

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ptt.seed(0)
    t0 = time.perf_counter()
    model = ErnieForSequenceClassification(ernie_3_0_base(), num_classes=2, dropout=0.1)
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    sched = ptt.optimizer.lr.LinearWarmup(CLS_LR, 2, 0.0, CLS_LR)
    opt = ptt.optimizer.AdamW(learning_rate=sched, parameters=model.parameters(),
                              weight_decay=0.01)
    step = cls_finetune_step(ptt, model, opt, sched)
    rng = np.random.RandomState(0)
    vocab = ERNIE_BASE["vocab_size"]
    train, held_out = cls_batches(rng, 4, CLS_BATCH, CLS_SEQ, vocab), \
        cls_batches(rng, 4, CLS_BATCH, CLS_SEQ, vocab)
    data = [(ptt.to_tensor(i), ptt.to_tensor(y), n) for i, y, n in train]
    _, _, train_loss0 = cls_eval(ptt, model, train)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    losses, per_step, real_tokens = [], [], 0
    for i in range(CLS_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ids, labels, n = data[i % len(data)]
        before = dict(ta.LAUNCHES)
        losses.append(step(ids, labels)[0])
        per_step.append({k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP})
        real_tokens += n if i else 0
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (CLS_STEPS - 1)
    launches = {k: v for k, v in ta.LAUNCHES.items() if v}
    losses = [x.item() for x in losses]
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0, "fused_adamw": 1}
    if any(d != want for d in per_step):
        raise AssertionError(f"ernie_finetune: launches per step {per_step} != {want}")
    epochs = [sum(losses[i:i + 4]) / 4 for i in range(0, CLS_STEPS, 4)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    acc, metric_acc, eval_loss = cls_eval(ptt, model, held_out)
    train_acc, _, train_loss = cls_eval(ptt, model, train)
    # the loss over the 4 training batches without dropout, before and after
    if not (all(math.isfinite(x) for x in losses) and train_loss < train_loss0):
        raise AssertionError(f"ernie_finetune: losses not finite and falling: {losses}, "
                             f"train loss {train_loss0} -> {train_loss}")
    if acc != metric_acc:
        raise AssertionError(f"ernie_finetune: eval accuracy {acc} != metric.Accuracy {metric_acc}")
    emb = model.ernie.embeddings
    n_params = sum(p.numel() for p in model.parameters())
    n_emb = sum(e.weight.numel() for e in (emb.word_embeddings, emb.position_embeddings,
                                            emb.token_type_embeddings))
    # bench.py:407-416's count with every embedding a lookup (no tied decoder here)
    flops_per_token = (6 * (n_params - n_emb)
                       + 12 * CLS_SEQ * ERNIE_BASE["hidden_size"] * ERNIE_BASE["num_hidden_layers"])
    tokens_per_sec = CLS_BATCH * CLS_SEQ / (step_ms / 1e3)
    calls = widened_calls(lambda: step(*data[0][:2]))
    prof = profile_train(lambda: step(*data[1][:2]), step_ms)
    state.setdefault("ernie_launches", {})["ernie_finetune"] = launches
    log("ernie_finetune", batch=CLS_BATCH, seq=CLS_SEQ, steps=CLS_STEPS, lr=CLS_LR,
        params_m=n_params / 1e6, init_s=init_s, losses=losses, loss_by_epoch=epochs,
        ms_per_step=step_ms, tokens_per_sec_padded=tokens_per_sec,
        tokens_per_sec_real=real_tokens / ((CLS_STEPS - 1) * step_ms / 1e3),
        real_token_share=sum(n for _, _, n in train) / (len(train) * CLS_BATCH * CLS_SEQ),
        flops_per_token=flops_per_token,
        mfu=tokens_per_sec * flops_per_token / PEAK_FLOPS[torch.bfloat16],
        step_ms_at_peak=CLS_BATCH * CLS_SEQ * flops_per_token / PEAK_FLOPS[torch.bfloat16] * 1e3,
        peak_mem_gb=peak, train_loss_before=train_loss0, train_loss_after=train_loss,
        train_acc=train_acc, eval_loss=eval_loss, eval_acc=acc, eval_metric_acc=metric_acc,
        launches=launches, launches_per_step=per_step[0], widened_calls_per_step=calls)
    log("ernie_finetune profile", **prof)
    # unpadded full-length batches, no mask: the flash kernels (B1-B3)
    full = [(ptt.to_tensor(i), ptt.to_tensor(y)) for i, y, _ in
            cls_batches(rng, 5, CLS_BATCH, CLS_SEQ, vocab, padded=False)]
    ta.reset_launch_counts()
    per_step, ulosses = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, labels in full:
        before = dict(ta.LAUNCHES)
        ulosses.append(step(ids, labels, masked=False)[0])
        per_step.append({k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP})
    torch.cuda.synchronize()
    u_ms = (time.perf_counter() - t0) * 1e3 / len(full)
    ulaunches = {k: v for k, v in ta.LAUNCHES.items() if v}
    ulosses = [x.item() for x in ulosses]
    if any(d != ERNIE_PER_STEP for d in per_step) or not all(math.isfinite(x) for x in ulosses):
        raise AssertionError(f"ernie_finetune unpadded: launches per step {per_step} != "
                             f"{ERNIE_PER_STEP}, or losses {ulosses} not finite")
    state.setdefault("ernie_launches", {})["ernie_finetune_unpadded"] = ulaunches
    log("ernie_finetune unpadded", steps=len(full), losses=ulosses, ms_per_step=u_ms,
        tokens_per_sec=CLS_BATCH * CLS_SEQ / (u_ms / 1e3),
        mfu=CLS_BATCH * CLS_SEQ / (u_ms / 1e3) * flops_per_token / PEAK_FLOPS[torch.bfloat16],
        launches=ulaunches, launches_per_step=per_step[0])
    ptt.set_flags({"FLAGS_fused_optimizer": False})
    del model, opt, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the nn remainder: its functionals on the card, then Transformer training
# and beam-search decoding (tests/torch_seq2seq.py's model)
# ---------------------------------------------------------------------------

def nn_surface(ptt):
    """Every row of tests/torch_nn_table.py on the card against the port on
    the CPU, as op_surface runs its table; then the random nn layers and
    functionals on the card: drawn again equal after seed(), their kept
    share and moments as the CPU tests hold them."""
    tab, nn_tab = _tests_module("torch_op_table"), _tests_module("torch_nn_table")
    t0 = time.perf_counter()
    n_cases, n_grads = table_on_card(ptt, tab, [(r, False) for r in nn_tab.ROWS]
                                     + [(r, True) for r in nn_tab.ROWS if r.bf16], "nn_surface")
    table_s = time.perf_counter() - t0
    F = ptt.nn.functional
    n = 1 << 20
    x = torch.randn(n, device="cuda")
    neg = -torch.rand(n, device="cuda") - 0.1
    draws = {"dropout": lambda: F.dropout(x, 0.3), "dropout_axis": lambda: F.dropout(
                 x.reshape(1024, 1024), 0.5, axis=1),
             "dropout2d": lambda: F.dropout2d(x.reshape(16, 64, 32, 32), 0.5),
             "alpha_dropout": lambda: F.alpha_dropout(x, 0.2),
             "rrelu": lambda: F.rrelu(neg, 0.1, 0.3),
             "gumbel_softmax": lambda: F.gumbel_softmax(x.reshape(-1, 16), 0.5),
             "Dropout": lambda: ptt.nn.Dropout(0.3)(x), "RReLU": lambda: ptt.nn.RReLU(0.1, 0.3)(neg)}
    rec = {}
    for name, fn in draws.items():
        ptt.seed(7)
        a = fn()
        ptt.seed(7)
        b = fn()
        if a.device.type != "cuda" or not torch.equal(a, b):
            raise AssertionError(f"nn_surface: {name} on the card is not drawn again equal")
        rec[name] = dict(mean=a.float().mean().item(), std=a.float().std().item())
    kept = (draws["dropout"]() != 0).float().mean().item()
    slope = (draws["rrelu"]() / neg)
    ad = draws["alpha_dropout"]()
    rows = draws["gumbel_softmax"]().sum(-1)
    checks = dict(dropout_kept=abs(kept - 0.7) < 0.01,
                  rrelu_slopes=bool(slope.min() >= 0.1 and slope.max() <= 0.3
                                    and abs(slope.mean().item() - 0.2) < 2e-3),
                  alpha_dropout_moments=abs(ad.mean().item()) < 0.02
                  and abs(ad.std().item() - 1.0) < 0.02,
                  gumbel_rows_sum_to_one=bool(torch.allclose(rows, torch.ones_like(rows),
                                                             atol=1e-5)))
    if not all(checks.values()):
        raise AssertionError(f"nn_surface: random draws on the card: {checks} {rec}")
    log("nn_surface", rows=n_cases, rows_with_grads=n_grads, table_s=table_s,
        tol={k: v for k, v in tab.TOL.items()}, random=rec, random_checks=checks)


TINY_S2S = dict(vocab=512, d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                dim_feedforward=64, dropout=0.0)


@contextlib.contextmanager
def kernel_rounding(ta):
    """The flash wrapper's plain version on CPU tensors, rounding where the
    kernels round: exp(s - m) to the storage type before P.V and the
    division by l after it (flash_fwd.cu, as pallas.py:413-415), where the
    plain version rounds the normalized p (as pallas.py:361). The backward
    and the masked chain (its calls pass a mask) keep the plain version,
    with whose rounding the backward kernels agree exactly."""
    plain = ta._flash_plain

    def rounded_as_kernel(q, k, v, causal, scale, dropout_p, seed, *mask):
        if mask:
            return plain(q, k, v, causal, scale, dropout_p, seed, *mask)
        if dropout_p:
            raise ValueError("kernel_rounding takes no dropout")
        sq, sk = q.shape[1], k.shape[1]
        qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
        s = (qh @ kh.transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(~torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq), -1e30)
        m = s.max(dim=-1, keepdim=True).values
        e = torch.exp(s - m)
        l = e.sum(dim=-1, keepdim=True)
        out = (e.to(q.dtype).float() @ vh) / l
        return out.to(q.dtype).transpose(1, 2), (m + torch.log(l)).squeeze(-1)

    ta._flash_plain = rounded_as_kernel
    try:
        yield
    finally:
        ta._flash_plain = plain


def s2s_step(ptt, s2s, model, opt, batch, vocab, amp=True, keep_grads=False):
    """One training step of the label-smoothed loss: (loss, CPU f32 grads or None)."""
    src, tgt_in, labels = batch
    with ptt.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        loss = s2s.loss_fn(ptt, model(src, tgt_in), labels, vocab)
    loss.backward()
    grads = ({n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
             if keep_grads else None)
    opt.step()
    opt.clear_grad()
    return loss, grads


def transformer_parity(ptt, ta):
    """The tiny seq2seq from one set of weights on the card (kernels) and on
    the CPU (plain versions), 2 fused-Adam steps each in f32 and in AMP O1
    bf16: f32 held as resnet_parity holds it; O1 held by ernie_parity's
    limits against a CPU O1 run that rounds where the kernels round
    (kernel_rounding); then greedy (beam 1) and beam-4 decoding in f32 on
    both from the card's trained O1 weights: ids equal."""
    s2s = _tests_module("torch_seq2seq")
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.set_device("cpu")
    ptt.seed(3)
    ref_state = {k: v.detach().clone() for k, v in s2s.make_model(ptt, **TINY_S2S).state_dict().items()}
    data = s2s.copy_task(np.random.RandomState(4), 4, 16, TINY_S2S["vocab"])

    def run(dev, amp):
        ptt.set_device(dev)
        model = s2s.make_model(ptt, **TINY_S2S)
        model.set_state_dict(ref_state)
        opt = ptt.optimizer.Adam(TRAIN_LR, beta1=0.9, beta2=0.98, epsilon=1e-9,
                                 parameters=model.parameters())
        batch = [torch.from_numpy(a).to(dev) for a in data]
        before = dict(ta.LAUNCHES)
        loss1, grads = s2s_step(ptt, s2s, model, opt, batch, TINY_S2S["vocab"], amp, True)
        loss2, _ = s2s_step(ptt, s2s, model, opt, batch, TINY_S2S["vocab"], amp)
        return dict(losses=[loss1.item(), loss2.item()], grads=grads,
                    launches={k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP},
                    before={n: w.float() for n, w in ref_state.items()},
                    after={n: p.detach().float().cpu() for n, p in model.named_parameters()},
                    buckets=len(opt._flat_engine.buckets))

    runs = {(dev, amp): run(dev, amp)
            for dev, amp in (("cuda", True), ("cpu", True), ("cuda", False), ("cpu", False))}
    with kernel_rounding(ta):
        runs[("cpu_k", True)] = run("cpu", True)
    layers = TINY_S2S["num_encoder_layers"] + TINY_S2S["num_decoder_layers"]
    for amp in (True, False):
        card, cpu = runs[("cuda", amp)], runs[("cpu", amp)]
        want = {"flash_fwd": 2 * layers, "flash_bwd_dq": 2 * layers,
                "flash_bwd_dkdv": 2 * layers, "fused_adamw": 2 * card["buckets"]}
        if card["launches"] != want or any(v for r in (cpu, runs[("cpu_k", True)])
                                           for v in r["launches"].values()):
            raise AssertionError(f"transformer_parity: launches card {card['launches']}, cpu "
                                 f"{cpu['launches']}; expected {want} on the card, none on the CPU")
    card, cpu = runs[("cuda", False)], runs[("cpu", False)]
    # the key biases' gradient is 0 but for rounding (C-trap10): held as
    # noise against the same attention's query-bias gradient, on both
    # devices, and left out of the f32 distances (Adam steps noise by ~lr)
    zero = {n: cpu["grads"][n.replace("k_proj", "q_proj")].norm().item()
            for n in cpu["grads"] if n.endswith("k_proj.bias")}
    zero_noise = max(r["grads"][n].norm().item() / ref for r in runs.values()
                     for n, ref in zero.items())
    dist = {n: d for n, d in resnet_dists(card, cpu).items() if n not in zero}
    f32 = dict(loss_err=[abs(a - b) / cpu["losses"][0] for a, b in zip(card["losses"],
                                                                       cpu["losses"])],
               worst_grad=max((g, n) for n, (g, _) in dist.items()),
               worst_change=max((c, n) for n, (_, c) in dist.items()),
               key_bias_grad_over_query_bias=zero_noise)
    ok = (max(f32["loss_err"]) <= RESNET_F32_TOL["loss"]
          and f32["worst_grad"][0] <= RESNET_F32_TOL["grad"]
          and f32["worst_change"][0] <= RESNET_F32_TOL["change"] and zero_noise <= ZERO_GRAD_NOISE)
    # O1: the card against the CPU run with the kernels' rounding points
    card, cpu = runs[("cuda", True)], runs[("cpu_k", True)]
    grad_dist = lambda x, y: {n: d[0] for n, d in resnet_dists(x, y).items()
                              if n in y["grads"] and n not in zero}
    dist = grad_dist(card, cpu)
    worst = max((g, n) for n, g in dist.items())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    dp = torch.cat([(card["after"][n] - w).abs().reshape(-1) for n, w in cpu["after"].items()])
    # for the record: the card against the plain version's O1 run, and the
    # two CPU roundings (normalized p or not) against each other
    vs_plain, roundings = grad_dist(card, runs[("cpu", True)]), grad_dist(cpu, runs[("cpu", True)])
    o1 = dict(losses_card=card["losses"], losses_cpu=cpu["losses"], loss_max_rel_err=loss_rel,
              worst_grad=worst, median_grad=float(np.median(list(dist.values()))),
              param_max_abs_diff_over_lr=dp.max().item() / TRAIN_LR,
              param_mean_abs_diff_over_lr=dp.mean().item() / TRAIN_LR,
              vs_plain_rounding=dict(worst=max((g, n) for n, g in vs_plain.items()),
                                     median=float(np.median(list(vs_plain.values())))),
              plain_vs_kernel_rounding_on_cpu=dict(
                  worst=max((g, n) for n, g in roundings.items()),
                  median=float(np.median(list(roundings.values())))))
    ok = (ok and loss_rel <= TRAIN_LOSS_RTOL and worst[0] <= TRAIN_GRAD_REL
          and o1["param_max_abs_diff_over_lr"] <= TRAIN_PARAM_MAX_OVER_LR
          and o1["param_mean_abs_diff_over_lr"] <= TRAIN_PARAM_MEAN_OVER_LR)
    # decoding from one set of weights (the card's O1-trained), f32 on both
    ids = {}
    for dev in ("cuda", "cpu"):
        ptt.set_device(dev)
        model = s2s.make_model(ptt, **TINY_S2S)
        model.set_state_dict(runs[("cuda", True)]["after"])
        model.eval()
        src = torch.from_numpy(data[0][:2]).to(dev)
        with torch.no_grad():
            ids[dev] = {beam: [t.cpu() for t in s2s.beam_search(ptt, model, src, beam, 12,
                                                                first_step_cache=False)]
                        for beam in (1, 4)}
    ptt.set_device("cuda")
    # ids and lengths exactly; the scores (f32 log-probs) to f32 rounding
    ids_equal = {beam: (torch.equal(ids["cuda"][beam][0], ids["cpu"][beam][0])
                        and torch.equal(ids["cuda"][beam][2], ids["cpu"][beam][2])
                        and torch.allclose(ids["cuda"][beam][1], ids["cpu"][beam][1], rtol=1e-5,
                                           atol=1e-4))
                 for beam in (1, 4)}
    rec = dict(f32=f32, o1=o1, ids_equal=ids_equal, beam4_ids=ids["cuda"][4][0][0].tolist(),
               tol=dict(f32=RESNET_F32_TOL, key_bias_noise=ZERO_GRAD_NOISE,
                        o1_loss_rel=TRAIN_LOSS_RTOL, o1_grad_rel_l2=TRAIN_GRAD_REL,
                        o1_param_max_over_lr=TRAIN_PARAM_MAX_OVER_LR,
                        o1_param_mean_over_lr=TRAIN_PARAM_MEAN_OVER_LR))
    if not (ok and all(ids_equal.values())):
        raise AssertionError(f"transformer_parity: card and CPU runs disagree: {rec}")
    log("transformer_parity", **TINY_S2S, launches=runs[("cuda", True)]["launches"], steps=2,
        **rec)


# Vaswani et al. 2017, Table 3 "base", as PaddleNLP's machine_translation/
# transformer trains it on WMT14 en-de (shared BPE vocabulary of ~37000)
TRANSFORMER_BASE = dict(vocab=37000, d_model=512, nhead=8, num_encoder_layers=6,
                        num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
S2S_BATCH, S2S_SEQ, S2S_STEPS = 64, 64, 10  # 4096 target tokens a step, PaddleNLP's batch_size
DECODE_SOURCES, DECODE_BEAM = 8, 4
DECODE_STEPS = S2S_SEQ + 50  # the paper's input length + 50


def decode_dispatch(ptt, ta, s2s, model, src, want_ids, b1_calls, turns=8):
    """The beam decode's seconds with every B1 call through the registered
    op (as a traced graph runs it) and through the direct ctypes launch
    (the eager path), in turns (op, direct, direct, op): the op's dispatch
    cost on the path with the most B1 calls. Both give the main run's ids;
    the medians are compared."""
    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            ids = s2s.beam_search(ptt, model, src, DECODE_BEAM, DECODE_STEPS,
                                  first_step_cache=False)[0]
        torch.cuda.synchronize()
        if not torch.equal(ids, want_ids):
            raise AssertionError("transformer_base: a timed decode's ids differ")
        return time.perf_counter() - t0

    direct = ta.direct_launch
    secs = {"op": [], "direct": []}
    run()  # a warm-up decode
    try:
        for i in range(turns):
            key = "op" if i % 4 in (0, 3) else "direct"
            ta.direct_launch = (lambda *ts: False) if key == "op" else direct
            secs[key].append(run())
    finally:
        ta.direct_launch = direct
    op_s, direct_s = float(np.median(secs["op"])), float(np.median(secs["direct"]))
    return dict(b1_calls=b1_calls, op_s=secs["op"], direct_s=secs["direct"],
                op_over_direct_us_a_call=(op_s - direct_s) * 1e6 / b1_calls)


def transformer_base(ptt, ta, state):
    """Transformer-base training then beam-search decoding on the card."""
    s2s = _tests_module("torch_seq2seq")
    cfg = TRANSFORMER_BASE
    d, heads = cfg["d_model"], cfg["nhead"]
    variant = {k: ta.kernel_variant(k, torch.bfloat16, d // heads)
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    if set(variant.values()) != {"wgmma"}:
        raise AssertionError(f"transformer_base: head_dim {d // heads} runs {variant}")
    # B1 at the decode shapes (beam 4 x 8 sources, bf16): one query against
    # the self-attention cache (odd lengths, the last 114) and the
    # cross-attention's 64 memory rows, against its plain version
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = DECODE_SOURCES * DECODE_BEAM
    decode_b1 = [check_flash(ta, gen, f"bf16 decode B{b} Sq1 Sk{sk} H8 D64", b, 1, sk, heads, heads,
                             d // heads, torch.bfloat16, False, timed=sk in (S2S_SEQ, DECODE_STEPS))
                 for sk in (1, 7, 33, S2S_SEQ, 113, DECODE_STEPS)]
    # B1-B3 at the training shape (the encoder's and the cross-attention's
    # unmasked calls), with the phase's attention dropout and without
    train_shape = (S2S_BATCH, S2S_SEQ, S2S_SEQ, heads, heads, d // heads)
    train_cases = [(f"bf16 non-causal B{S2S_BATCH} S{S2S_SEQ} H{heads} D{d // heads}"
                    + (f" dropout p={p}" if p else "") + " (Transformer-base train)", p)
                   for p in (cfg["dropout"], 0.0)]
    train_b1 = [check_flash(ta, gen, case, *train_shape, torch.bfloat16, False, dropout_p=p,
                            timed=True) for case, p in train_cases]
    train_bwd = [(case, check_flash_bwd(ta, gen, case, *train_shape, torch.bfloat16, False,
                                        dropout_p=p, timed=True)) for case, p in train_cases]
    if (any(r["variant"] != "wgmma" for r in train_b1)
            or any(r["variant"] != "wgmma" for _, recs in train_bwd for r in recs)):
        raise AssertionError("transformer_base: the training shape's flash kernels did not run "
                             "the wgmma variant")
    fwd_keys = ("case", "variant", "ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
                "bound_ms", "max_abs_err")
    state["transformer_by_shape"] = {
        "flash_fwd": [{k: r.get(k) for k in fwd_keys} for r in train_b1 + decode_b1
                      if "ms" in r],
        **{kname: [dict(case=case, **{k: recs[i][k] for k in ("variant", "ms", "graph_ms",
                                                               "plain_ms", "library_ms",
                                                               "bound_ms", "max_abs_err")})
                   for case, recs in train_bwd]
           for i, kname in enumerate(("flash_bwd_dq", "flash_bwd_dkdv"))}}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ptt.set_device("cuda")
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(0)
    t0 = time.perf_counter()
    model = s2s.make_model(ptt, **cfg)
    sched = ptt.optimizer.lr.NoamDecay(d_model=d, warmup_steps=4000, learning_rate=2.0)
    opt = ptt.optimizer.Adam(sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
                             parameters=model.parameters())
    data = s2s.copy_task(np.random.RandomState(0), S2S_BATCH, S2S_SEQ, cfg["vocab"])
    batch = [torch.from_numpy(a).cuda() for a in data]
    n_params = sum(p.numel() for p in model.parameters())

    def eval_loss():
        model.eval()
        with torch.no_grad(), ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = s2s.loss_fn(ptt, model(batch[0], batch[1]), batch[2], cfg["vocab"]).item()
        model.train()
        return out

    loss_before = eval_loss()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    losses, per_step = [], []
    for i in range(S2S_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(ta.LAUNCHES)
        losses.append(s2s_step(ptt, s2s, model, opt, batch, cfg["vocab"])[0])
        sched.step()
        per_step.append({k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (S2S_STEPS - 1)
    train_launches = dict(ta.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    loss_after = eval_loss()
    buckets = len(opt._flat_engine.buckets)
    layers = cfg["num_encoder_layers"] + cfg["num_decoder_layers"]
    want_step = {"flash_fwd": layers, "flash_bwd_dq": layers, "flash_bwd_dkdv": layers,
                 "fused_adamw": buckets}
    if any(p != want_step for p in per_step):
        raise AssertionError(f"transformer_base: launches per step {per_step} != {want_step}")
    if not (all(math.isfinite(x) for x in losses) and loss_after < loss_before):
        raise AssertionError(f"transformer_base: losses not finite, or the eval loss did not "
                             f"fall: {losses}, {loss_before} -> {loss_after}")
    # 6 N a target token (the shared embedding counted once, as the output
    # projection's GEMM; source and target lengths are equal) plus attention:
    # 12 S d a token for each encoder self-, decoder self- and cross-attention
    attn = 12 * S2S_SEQ * d * (cfg["num_encoder_layers"] + 2 * cfg["num_decoder_layers"])
    flops_per_token = 6 * n_params + attn
    tokens_per_sec = S2S_BATCH * S2S_SEQ / (step_ms / 1e3)
    prof = profile_train(lambda: s2s_step(ptt, s2s, model, opt, batch, cfg["vocab"]), step_ms)
    # decoding: the main path's second half
    model.eval()
    src = batch[0][:DECODE_SOURCES]
    ta.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        ids, scores, lengths = s2s.beam_search(ptt, model, src, DECODE_BEAM, DECODE_STEPS,
                                               first_step_cache=False)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = dict(ta.LAUNCHES)
    steps = ids.shape[1]
    sc = scores.float()
    if not (tuple(ids.shape) == (DECODE_SOURCES, steps, DECODE_BEAM) and 0 < steps <= DECODE_STEPS
            and bool(torch.isfinite(sc[:, 0]).all()) and bool((sc.diff(dim=2) <= 1e-3).all())):
        raise AssertionError(f"transformer_base: beam output {tuple(ids.shape)} not [8, T, 4] "
                             "with finite scores sorted across beams")
    want_decode = {"flash_fwd": cfg["num_encoder_layers"] + 2 * cfg["num_decoder_layers"] * steps}
    if decode_launches["flash_fwd"] != want_decode["flash_fwd"]:
        raise AssertionError(f"transformer_base: decode launches {decode_launches} != "
                             f"{want_decode}")
    total = {k: train_launches[k] + decode_launches[k] for k in train_launches}
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "fused_adamw"):
        if not total[k]:
            raise AssertionError(f"transformer_base: {k} was never launched")
    dispatch = decode_dispatch(ptt, ta, s2s, model, src, ids, decode_launches["flash_fwd"])
    state["transformer_launches"] = total
    log("transformer_base", **cfg, params_m=n_params / 1e6, batch=S2S_BATCH, seq=S2S_SEQ,
        head_dim=d // heads, variant=variant, init_s=init_s, losses=losses,
        eval_loss_before=loss_before, eval_loss_after=loss_after, lr_last=sched.get_lr(),
        ms_per_step=step_ms, target_tokens_per_sec=tokens_per_sec,
        flops_per_token=flops_per_token,
        mfu=tokens_per_sec * flops_per_token / PEAK_FLOPS[torch.bfloat16], peak_mem_gb=peak,
        launches_train=train_launches, launches_per_step=per_step[0], buckets=buckets,
        decode=dict(sources=DECODE_SOURCES, beam=DECODE_BEAM, max_steps=DECODE_STEPS,
                    steps=steps, seconds=decode_s, ms_per_step=decode_s * 1e3 / steps,
                    beam_tokens_per_sec=DECODE_SOURCES * DECODE_BEAM * steps / decode_s,
                    source_tokens_per_sec=DECODE_SOURCES * steps / decode_s,
                    lengths=lengths[:, 0].tolist(), best_ids_0=ids[0, :12, 0].tolist(),
                    launches=decode_launches, dispatch=dispatch),
        b1_decode_shapes=[{k: r.get(k) for k in ("case", "variant", "ms", "plain_ms",
                                                  "library_ms", "bound_ms", "max_abs_err")}
                          for r in decode_b1],
        flash_by_shape=state["transformer_by_shape"])
    log("transformer_base profile", **prof)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the static graph (paddle.static): capture, the pass pipeline, the Executor
# ---------------------------------------------------------------------------

STATIC_IDS = (4, 512)  # the Llama capture's eval batch
STATIC_MATCHES = {"fuse_attention": LLAMA3_8B["num_hidden_layers"], "fuse_norm_matmul": 1}


def llama_8b(ptt):
    """serve_bf16's model: Llama-3-8B width at 32 layers, bf16, seed 0."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.seed(0)
    return LlamaForCausalLM(**LLAMA3_8B, device="cuda", dtype="bfloat16").eval()


def wall_ms(fn, iters=3) -> float:
    """Host-clock ms of one call of `fn` ending in a synchronize, the best
    of `iters` after one warm-up call."""
    fn()
    best = None
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def static_llama_capture(ptt, ta, model, state):
    """bench.py:_measure_passes at full width: capture_program of the eval
    forward over ids [4, 512], the default pipeline through Executor.run
    with passes on and off; on and off bit-identical, the logits against
    the eager forward within serve_bf16's cached-logits limit, the match
    counts, B1 exactly once a layer a run."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.jit import capture_program
    from paddle_tpu_torch.static import passes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L = LLAMA3_8B["num_hidden_layers"]
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, LLAMA3_8B["vocab_size"], STATIC_IDS)).cuda()
    t0 = time.perf_counter()
    program, feed_names, fetch_list = capture_program(model, ids, feed_names=["ids"])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_peak = torch.cuda.max_memory_allocated() / 1e9
    fetch_vid = program.resolve_fetch(fetch_list[0])
    best = None
    for _ in range(3):  # the per-compile-miss cost: clone, every pass, the verifies
        t0 = time.perf_counter()
        work, res = passes.run_default_pipeline(program, fetch_vars=[fetch_vid],
                                                feed_names=feed_names)
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    matches = {k: v for k, v in res.matches.items() if v}
    if {k: matches.get(k, 0) for k in STATIC_MATCHES} != STATIC_MATCHES:
        raise AssertionError(f"static_llama_capture: matches {matches}, expected {STATIC_MATCHES}")
    exe = static.Executor()
    feed = {"ids": ids}
    exe.run(program, feed=feed, fetch_list=fetch_list, return_numpy=False)  # the compile miss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    (on,) = exe.run(program, feed=feed, fetch_list=fetch_list, return_numpy=False)
    torch.cuda.synchronize()
    launches = dict(ta.LAUNCHES)
    replay_peak = torch.cuda.max_memory_allocated() / 1e9
    ptt.set_flags({"FLAGS_program_passes": False})
    try:
        before = ta.LAUNCHES["flash_fwd"]
        (off,) = exe.run(program, feed=feed, fetch_list=fetch_list, return_numpy=False)
        off_flash = ta.LAUNCHES["flash_fwd"] - before
        off_ms = wall_ms(lambda: exe.run(program, feed=feed, fetch_list=fetch_list,
                                         return_numpy=False))
    finally:
        ptt.set_flags({"FLAGS_program_passes": True})
    want = {k: (L if k == "flash_fwd" else 0) for k in launches}
    if launches != want or off_flash != L:
        raise AssertionError(f"static_llama_capture: launches {launches} (passes off: B1 "
                             f"{off_flash}), expected {want}")
    if not torch.equal(on, off):
        raise AssertionError("static_llama_capture: passes on and off differ")
    on_ms = wall_ms(lambda: exe.run(program, feed=feed, fetch_list=fetch_list,
                                    return_numpy=False))
    with torch.no_grad():
        eager = model(ids)
        eager_ms = wall_ms(lambda: model(ids))
    rel = ((on.float() - eager.float()).norm(dim=-1)
           / eager.float().norm(dim=-1).clamp_min(1e-30)).max().item()
    if not (rel <= LOGIT_REL_BOUND and torch.isfinite(on).all()):
        raise AssertionError(f"static_llama_capture: replay vs eager logits rel err {rel} > "
                             f"{LOGIT_REL_BOUND}")
    state["static_llama_launches"] = launches
    log("static_llama_capture", layers=L, ids=list(STATIC_IDS), capture_s=capture_s,
        n_ops_recorded=len(program.ops), n_ops_after=len(work.ops), matches=matches,
        rewritten_ops={k: v for k, v in res.rewritten_ops.items() if v}, pipeline_ms=best,
        replay_ms=on_ms, replay_passes_off_ms=off_ms, eager_forward_ms=eager_ms,
        passes_on_off_identical=True, replay_equals_eager=bool(torch.equal(on, eager)),
        logits_max_row_rel_err=rel, rel_err_bound=LOGIT_REL_BOUND, launches=launches,
        capture_peak_mem_gb=capture_peak, replay_peak_mem_gb=replay_peak,
        weights_gb=sum(nbytes(p) for p in model.parameters()) / 1e9)
    del program, work, on, off, eager
    torch.cuda.empty_cache()


STATIC_ERNIE_BATCH, STATIC_ERNIE_SEQ, STATIC_ERNIE_STEPS = 64, 128, 5


def static_ernie_program(ptt, model, loss_scale_feed=False):
    """bench.py's ERNIE step written as a static Program: feeds, the MLM
    loss under auto_cast(O1, bf16), AdamW.minimize with the fused bucket.
    `loss_scale_feed` multiplies the loss by a fed [1] f32 scale (1.0 keeps
    every bit; NaN poisons the update, as a bad batch would)."""
    from paddle_tpu_torch import static

    ptt.set_flags({"FLAGS_fused_optimizer": True})
    main = static.Program()
    with static.program_guard(main, static.Program()):
        ids = static.data("ids", [STATIC_ERNIE_BATCH, STATIC_ERNIE_SEQ], "int64")
        labels = static.data("labels", [STATIC_ERNIE_BATCH, STATIC_ERNIE_SEQ], "int64")
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = model(ids, labels=labels)
        if loss_scale_feed:
            loss = loss * static.data("loss_scale", [1], "float32")
        ptt.optimizer.AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                            moment2_dtype="bfloat16").minimize(loss)
    return main, loss


def static_ernie_train(ptt, ta, state):
    """ernie_seq128 as a static Program: ERNIE-3.0-base MLM at B64 S128 from
    build_ernie's seed-0 weights and batch, 5 Executor.run steps against 5
    eager to_static steps from the same state: each loss within 1e-3, exact
    launches a step (B1-B3 once a layer, B5 once), ms/step, tokens/s, MFU,
    peak memory and idle share beside the eager step's."""
    from paddle_tpu_torch import static

    head_dim = ERNIE_BASE["hidden_size"] // 12
    B, S, steps = STATIC_ERNIE_BATCH, STATIC_ERNIE_SEQ, STATIC_ERNIE_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, step, ids, labels = build_ernie(ptt, B, S, 12, 512, 0.0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    emb = model.ernie.embeddings
    n_params = sum(p.numel() for p in model.parameters())
    flops_per_token = (6 * (n_params - emb.position_embeddings.weight.numel()
                            - emb.token_type_embeddings.weight.numel())
                       + 12 * S * ERNIE_BASE["hidden_size"] * ERNIE_BASE["num_hidden_layers"])

    def timed(run):
        """ms a step over steps 2..N to a synchronize (as ernie_train), the
        losses read after"""
        losses = []
        for i in range(steps):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(run())
        torch.cuda.synchronize()
        return [x.item() for x in losses], (time.perf_counter() - t0) * 1e3 / (steps - 1)

    eager_losses, eager_ms = timed(lambda: step(ids, labels)[0])
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    eager_prof = profile_train(lambda: step(ids, labels), eager_ms)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        model.load_state_dict(init)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    main, loss = static_ernie_program(ptt, model)
    capture_s = time.perf_counter() - t0
    exe = static.Executor()
    feed = {"ids": ids, "labels": labels}
    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    per_step = []

    def run():
        before = dict(ta.LAUNCHES)
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
        per_step.append({k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP})
        return lv

    static_losses, static_ms = timed(run)
    launches = dict(ta.LAUNCHES)
    static_peak = torch.cuda.max_memory_allocated() / 1e9
    rel = [abs(a - b) / abs(b) for a, b in zip(static_losses, eager_losses)]
    if any(d != ERNIE_PER_STEP for d in per_step):
        raise AssertionError(f"static_ernie_train: launches per step {per_step} != "
                             f"{ERNIE_PER_STEP}")
    if not (max(rel) <= TRAIN_LOSS_RTOL and all(math.isfinite(x) for x in static_losses)):
        raise AssertionError(f"static_ernie_train: static losses {static_losses} vs eager "
                             f"{eager_losses}: rel err {rel} > {TRAIN_LOSS_RTOL}")
    static_prof = profile_train(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                                return_numpy=False), static_ms)
    state["static_ernie_launches"] = launches
    n_ops = len(main.ops)
    del main, loss, exe
    checked = static_ernie_checked(ptt, ta, state, model, init, feed, timed)
    del init

    def figures(ms, peak, prof):
        tps = B * S / (ms / 1e3)
        return dict(ms_per_step=ms, tokens_per_sec=tps,
                    mfu=tps * flops_per_token / PEAK_FLOPS[torch.bfloat16], peak_mem_gb=peak,
                    device_busy_ms=prof["device_busy_ms"],
                    device_idle_share=prof["device_idle_share"])

    log("static_ernie_train", batch=B, seq=S, heads=12, head_dim=head_dim, steps=steps,
        params_m=n_params / 1e6, capture_s=capture_s, n_ops_recorded=n_ops,
        losses_static=static_losses, losses_eager=eager_losses, loss_rel_err=rel,
        loss_rel_bound=TRAIN_LOSS_RTOL, launches=launches, launches_per_step=per_step[0],
        flops_per_token=flops_per_token, static=figures(static_ms, static_peak, static_prof),
        eager_ernie_seq128=figures(eager_ms, eager_peak, eager_prof),
        checked=dict(checked, static_ms_unchecked=static_ms))
    log("static_ernie_train profile", static=static_prof, eager=eager_prof)
    del model
    torch.cuda.empty_cache()


def static_ernie_checked(ptt, ta, state, model, init, feed, timed):
    """static_ernie_train's 5 steps twice more from the same weights, both
    under deterministic algorithms (the loss's gather and the embedding
    backward may sum with atomics) and with a fed loss scale of 1.0: once
    plain, once with FLAGS_check_nan_inf on and a compile-cache directory
    set. Limits: losses bit-equal, exact launches, one ledger `miss` and
    then hits; then a NaN scale makes the Executor raise GuardianAnomaly
    naming static_executor, with a flight-recorder dump that parses.
    Returns the figures (ms a step with the check and without)."""
    from paddle_tpu_torch import compile_cache as cc
    from paddle_tpu_torch import static
    from paddle_tpu_torch import telemetry

    work = tempfile.mkdtemp(prefix="static_checked_")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.filterwarnings("ignore", message=".*deterministic.*")
    feed = dict(feed, loss_scale=np.ones(1, np.float32))

    def hits():
        fam = telemetry.default_registry().get("paddle_tpu_compile_cache_hits_total")
        return sum(c.value for c in fam.children()
                   if dict(c.labels) == {"origin": "static_executor", "outcome": "hit"}) if fam else 0

    def five_steps(checked):
        with torch.no_grad():
            model.load_state_dict(init)
        if checked:
            os.environ[cc.store.ENV_DIR] = os.path.join(work, "cache")
            cc.configure(os.path.join(work, "cache"))
            ptt.set_flags({"FLAGS_check_nan_inf": True})
        main, loss = static_ernie_program(ptt, model, loss_scale_feed=True)
        exe = static.Executor()
        cc.ledger.reset()
        hits0 = hits()
        ta.reset_launch_counts()
        per_step = []

        def run():
            before = dict(ta.LAUNCHES)
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
            per_step.append({k: ta.LAUNCHES[k] - before[k] for k in ERNIE_PER_STEP})
            return lv

        losses, ms = timed(run)
        return dict(losses=losses, ms=ms, per_step=per_step, launches=dict(ta.LAUNCHES),
                    events=[(e["origin"], e["outcome"]) for e in cc.ledger.events()],
                    hits=hits() - hits0, main=main, loss=loss, exe=exe)

    problems = []
    try:
        plain = five_steps(False)
        del plain["main"], plain["loss"], plain["exe"]
        recorder = ptt.FlightRecorder(name="static_ernie", crash_dir=os.path.join(work, "crash"))
        chk = five_steps(True)
        if chk["losses"] != plain["losses"]:
            problems.append(f"checked losses {chk['losses']} != unchecked {plain['losses']}")
        if any(d != ERNIE_PER_STEP for d in chk["per_step"] + plain["per_step"]):
            problems.append(f"launches per step {chk['per_step']} != {ERNIE_PER_STEP}")
        if chk["events"] != [("static_executor", "miss")] or chk["hits"] != STATIC_ERNIE_STEPS - 1:
            problems.append(f"ledger events {chk['events']}, hits {chk['hits']}")
        bad = dict(feed, loss_scale=np.full(1, np.nan, np.float32))
        try:
            chk["exe"].run(chk["main"], feed=bad, fetch_list=[chk["loss"]], return_numpy=False)
            problems.append("a NaN batch raised nothing")
        except ptt.GuardianAnomaly as e:
            if "static_executor" not in str(e):
                problems.append(f"the anomaly does not name static_executor: {e}")
            dumps = [p for p in e.dump_paths if p.startswith(work)]
            doc = json.load(open(dumps[0])) if dumps else {}
            if doc.get("reason") != "compiled_state:static_executor" or not recorder.records():
                problems.append(f"flight recorder dump {dumps}: reason {doc.get('reason')}")
    finally:
        ptt.set_flags({"FLAGS_check_nan_inf": False})
        os.environ.pop(cc.store.ENV_DIR, None)
        cc.configure(None)
        torch.use_deterministic_algorithms(det)
    if problems:
        raise AssertionError("static_ernie_train (checked): " + "; ".join(problems))
    state["static_ernie_checked_launches"] = chk["launches"]
    shutil.rmtree(work, ignore_errors=True)
    return dict(deterministic_ms_per_step=plain["ms"], checked_ms_per_step=chk["ms"],
                check_cost_ms=chk["ms"] - plain["ms"], losses=chk["losses"],
                losses_bit_equal=True, ledger_events=chk["events"], ledger_hits=chk["hits"],
                launches=chk["launches"], nan_batch="GuardianAnomaly(static_executor)")


def static_parity(ptt, ta):
    """The tiny f32 Llama's capture and a 3-step static training (fused
    AdamW) on the card and on the CPU: matches per pass equal, logits and
    losses within train_parity's limits; then the unfused attention chain
    on the card, its fuse_attention rewrite (one B1 launch) against the
    chain it replaced under TOL."""
    import math as _math

    from paddle_tpu_torch import static
    from paddle_tpu_torch.jit import capture_program
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.static import passes

    ptt.seed(3)
    ref = LlamaForCausalLM(**TINY_LLAMA, device="cpu")
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, TINY_LLAMA["vocab_size"], (2, 64)))
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            ptt.set_device(dev)
            model = LlamaForCausalLM(**TINY_LLAMA, device="meta")
            model.load_state_dict({k: t.to(dev) for k, t in ref.state_dict().items()}, assign=True)
            model.eval()
            x = ids.to(dev)
            prog, names, fetch = capture_program(model, x, feed_names=["ids"])
            (logits,) = static.Executor().run(prog, feed={"ids": x}, fetch_list=fetch,
                                              return_numpy=False)
            matches = passes.LAST_RESULT[0].matches
            model.train()
            ptt.set_flags({"FLAGS_fused_optimizer": True})
            main = static.Program()
            with static.program_guard(main, static.Program()):
                fi = static.data("ids", [2, 64], "int64")
                loss, _ = model(fi, labels=fi)
                ptt.optimizer.AdamW(TRAIN_LR, parameters=model.parameters(),
                                    weight_decay=0.01).minimize(loss)
            exe = static.Executor()
            losses = [exe.run(main, feed={"ids": x}, fetch_list=[loss])[0].item()
                      for _ in range(3)]
            runs[dev] = dict(matches=matches, logits=logits.float().cpu(), losses=losses,
                             params={n: p.detach().float().cpu()
                                     for n, p in model.named_parameters()})
    finally:
        ptt.set_device("cuda")
        ptt.set_flags({"FLAGS_fused_optimizer": False})
    card, cpu = runs["cuda"], runs["cpu"]
    logit_rel = ((card["logits"] - cpu["logits"]).norm() / cpu["logits"].norm()).item()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    dp = torch.cat([(card["params"][n] - w).abs().reshape(-1) for n, w in cpu["params"].items()])
    rec = dict(matches_card=card["matches"], matches_cpu=cpu["matches"],
               logits_rel_l2_err=logit_rel, losses_card=card["losses"], losses_cpu=cpu["losses"],
               loss_max_rel_err=loss_rel, param_max_abs_diff_over_lr=dp.max().item() / TRAIN_LR,
               param_mean_abs_diff_over_lr=dp.mean().item() / TRAIN_LR)
    if not (card["matches"] == cpu["matches"] and card["matches"]["fuse_attention"] == 2
            and logit_rel <= TRAIN_LOSS_RTOL and loss_rel <= TRAIN_LOSS_RTOL
            and rec["param_max_abs_diff_over_lr"] <= TRAIN_PARAM_MAX_OVER_LR
            and rec["param_mean_abs_diff_over_lr"] <= TRAIN_PARAM_MEAN_OVER_LR
            and card["losses"][-1] < card["losses"][0]):
        raise AssertionError(f"static_parity: card and CPU disagree: {rec}")

    # the unfused chain -> the flash dispatch, at ERNIE's head layout in f32
    b, h, s, d = 2, 12, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = {n: torch.randn(b, h, s, d, generator=gen, device="cuda") for n in "qkv"}
    chain = static.Program()
    with static.program_guard(chain, static.Program()):
        q, k, v = (static.data(n, [b, h, s, d], "float32") for n in "qkv")
        p = ptt.nn.functional.softmax(ptt.scale(ptt.matmul(q, k, transpose_y=True),
                                                1.0 / _math.sqrt(d)))
        out = ptt.matmul(p, v)
    fv = chain.resolve_fetch(out)
    work, res = passes.run_default_pipeline(chain, fetch_vars=[fv])
    if res.matches.get("fuse_attention") != 1 or [op.name for op in work.ops] != [
            "fused_flash_attention"]:
        raise AssertionError(f"static_parity: the unfused chain was not rewritten: {res}")
    params = [chain._var_tensors[vid] for vid in chain.param_vars]
    want = chain.replay_env({chain.feed_vars[n]: t for n, t in qkv.items()}, params)[fv]
    before = ta.LAUNCHES["flash_fwd"]
    got = work.replay_env({work.feed_vars[n]: t for n, t in qkv.items()}, params)[fv]
    torch.cuda.synchronize()
    flash = ta.LAUNCHES["flash_fwd"] - before
    if flash != 1:
        raise AssertionError(f"static_parity: the fused op launched B1 {flash} times, not once")
    cmp = compare("static_parity fused_flash_attention", got, want, TOL["f32"])
    log("static_parity", tiny=dict(TINY_LLAMA), steps=3, **rec,
        tol=dict(loss_rel=TRAIN_LOSS_RTOL, param_max_over_lr=TRAIN_PARAM_MAX_OVER_LR,
                 param_mean_over_lr=TRAIN_PARAM_MEAN_OVER_LR),
        unfused_chain=dict(shape=[b, h, s, d], dtype="float32", flash_launches=flash,
                           variant=ta.kernel_variant("flash_fwd", torch.float32, d), **cmp))


# ---------------------------------------------------------------------------
# deployment: jit.save / save_inference_model -> the frozen-program Predictor
# ---------------------------------------------------------------------------

DEPLOY_CLS_RUNS = ((32, 128), (4, 512))  # ernie_finetune's batch, then PaddleNLP's longest
DEPLOY_LLAMA_LAYERS = 4  # weights inside the artifact: 2.27 GB at 4 layers (vocabulary 32000)
DEPLOY_LLAMA_BATCHES = (4, 2)  # the -1 batch dim run at static_llama_capture's batch and half


def _artifact_bytes(prefix) -> dict:
    return {ext: os.path.getsize(prefix + ext) for ext in (".pdmodel", ".pdiparams", ".pdmeta")
            if os.path.exists(prefix + ext)}


def _predictor_run(pred, inputs):
    """Predictor.run on numpy inputs through the handles (the outputs stay
    on the card until fetched)."""
    for name, a in zip(pred.get_input_names(), inputs):
        pred.get_input_handle(name).copy_from_cpu(a)
    pred.run()


def _predictor_fetch(pred):
    """The first output as an f32 CPU tensor (a bf16 output is exact in f32)."""
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    return torch.from_numpy(np.asarray(out, dtype=np.float32))


def _predictor_logits(pred, inputs):
    _predictor_run(pred, inputs)
    return _predictor_fetch(pred)


def _predictor_split_ms(pred, model, inputs, iters=10) -> dict:
    """One Predictor run's host-clock ms in parts, each ended by a
    synchronize, the median of `iters` rounds that take the parts in turn:
    staging the numpy inputs in the handles (`stage_ms`); run(), which
    copies them to the card and runs the program (`run_ms`); the first
    output's copy to the host (`fetch_ms`); the program alone on inputs
    already on the card (`program_ms`) and the eager forward on the same
    (`eager_ms`)."""
    dev_ins = [torch.from_numpy(a).cuda() for a in inputs]
    handles = [pred.get_input_handle(n) for n in pred.get_input_names()]
    out = pred.get_output_handle(pred.get_output_names()[0])
    parts = {k: [] for k in ("stage_ms", "run_ms", "fetch_ms", "program_ms", "eager_ms")}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        parts[key].append((time.perf_counter() - t0) * 1e3)

    def stage():
        for h, a in zip(handles, inputs):
            h.copy_from_cpu(a)

    with torch.no_grad():
        for i in range(iters + 1):
            timed("stage_ms", stage)
            timed("run_ms", pred.run)
            timed("fetch_ms", out.copy_to_cpu)
            timed("program_ms", lambda: pred._module(*dev_ins))
            timed("eager_ms", lambda: model(*dev_ins))
    return {k: float(np.median(v[1:])) for k, v in parts.items()}  # round 0 warms up


def _one_run(ta, fn, what, want_b1):
    """fn() with every launch count read around it: exactly `want_b1` B1
    launches and no other kernel."""
    before = dict(ta.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    delta = {k: ta.LAUNCHES[k] - before[k] for k in ta.LAUNCHES}
    want = {k: (want_b1 if k == "flash_fwd" else 0) for k in delta}
    if delta != want:
        raise AssertionError(f"{what}: launches {delta}, expected {want}")
    return out


def flash_dispatch_us(ta, b, s, h, d, calls=200, turns=4):
    """Host microseconds a B1 call spends before its launch, through the
    registered op (the eager path's entry) and through the ctypes wrapper
    directly, in turns (A B B A ...) at one shape: the op's dispatch cost is
    the difference. Each block is `calls` enqueued calls ended by a
    synchronize, timed on the host clock."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    fns = {"op": lambda: torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, False, scale, 0.0, 0),
           "direct": lambda: ta._flash_cuda(q, k, v, False, scale, 0.0, 0)}
    times = {"op": [], "direct": []}
    for name in fns.values():
        name()
    torch.cuda.synchronize()
    for i in range(turns):
        for key in (("op", "direct") if i % 2 == 0 else ("direct", "op")):
            fn = fns[key]
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[key].append((time.perf_counter() - t0) * 1e6 / calls)
            torch.cuda.synchronize()
    op_us, direct_us = float(np.median(times["op"])), float(np.median(times["direct"]))
    return dict(shape=[b, s, h, d], op_us=op_us, direct_us=direct_us,
                dispatch_us=op_us - direct_us, op_us_all=times["op"],
                direct_us_all=times["direct"])


def deploy_ernie(ptt, ta, state):
    """PaddleNLP's deployment of BASELINE configs[1]: the ernie_finetune
    model (ErnieForSequenceClassification(ernie_3_0_base()), 116.76 M, full
    width and depth) in bf16, eval; jit.save with two [-1, -1] int64
    InputSpecs, create_predictor(Config(prefix + ".pdmodel")), runs at B32
    S128 then B4 S512 (unpadded: no attention_mask, so attention is B1): B1
    exactly 12 a run, the logits within TOL["bf16"] of the eager forward
    (bit-equality reported). A second artifact saved with the CPU as the
    device must launch B1 12 times a run on the card too (the kernel, not
    the plain chain, is in the artifact). Then jit.load's TranslatedLayer
    once and a clone() once; the registered op's dispatch cost."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification, ernie_3_0_base
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.static import io as sio

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ptt.seed(0)
    model = ErnieForSequenceClassification(ernie_3_0_base(), num_classes=2).to(torch.bfloat16)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    L = ERNIE_BASE["num_hidden_layers"]
    spec = [InputSpec([-1, -1], "int64", "input_ids"), InputSpec([-1, -1], "int64", "token_type_ids")]
    rng = np.random.RandomState(21)
    batches = [(rng.randint(1, ERNIE_BASE["vocab_size"], (b, s)).astype(np.int64),
                rng.randint(0, 2, (b, s)).astype(np.int64)) for b, s in DEPLOY_CLS_RUNS]
    with torch.no_grad():
        eager = [model(*(torch.from_numpy(a).cuda() for a in ins)).float().cpu()
                 for ins in batches]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        prefix = os.path.join(tmp, "ernie_cls")
        t0 = time.perf_counter()
        ptt.jit.save(model, prefix, input_spec=spec)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(prefix + ".pdmodel"))
        load_s = time.perf_counter() - t0
        graph_b1 = sio.graph_ops(pred._module).count("paddle_tpu_torch.flash_fwd.default")
        if graph_b1 != L:
            raise AssertionError(f"deploy_ernie: the exported graph names B1 {graph_b1} times, "
                                 f"not {L}")
        # the CPU-saved artifact of the same weights
        cpu_prefix = os.path.join(tmp, "ernie_cls_cpu")
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        ptt.jit.save(cpu_model, cpu_prefix, input_spec=spec)
        cpu_save_s = time.perf_counter() - t0
        del cpu_model
        t0 = time.perf_counter()
        cpu_pred = inference.create_predictor(inference.Config(cpu_prefix + ".pdmodel"))
        cpu_load_s = time.perf_counter() - t0
        for ins in batches:  # warm-up: the first call of each shape
            _predictor_logits(pred, ins)
        # the main path: every count 0 before it, read after it
        ta.reset_launch_counts()
        got = [_one_run(ta, lambda ins=ins: _predictor_logits(pred, ins),
                        f"deploy_ernie B{ins[0].shape[0]} S{ins[0].shape[1]}", L)
               for ins in batches]
        got_cpu = _one_run(ta, lambda: _predictor_logits(cpu_pred, batches[0]),
                           "deploy_ernie CPU-saved artifact B32 S128", L)
        launches = {k: v for k, v in ta.LAUNCHES.items() if v}
        runs = []
        for (b, s), g, e, ins in zip(DEPLOY_CLS_RUNS, got, eager, batches):
            cmp = compare(f"deploy_ernie B{b} S{s} logits vs eager", g, e, TOL["bf16"])
            runs.append(dict(batch=b, seq=s, bit_equal_to_eager=bool(torch.equal(g, e)),
                             **_predictor_split_ms(pred, model, ins), **cmp))
        cmp_cpu = compare("deploy_ernie CPU-saved artifact vs eager", got_cpu, eager[0], TOL["bf16"])
        translated = ptt.jit.load(prefix)
        with torch.no_grad():
            tl_out = _one_run(ta, lambda: translated(*(torch.from_numpy(a).cuda()
                                                       for a in batches[1])).float().cpu(),
                              "deploy_ernie TranslatedLayer B4 S512", L)
        cmp_tl = compare("deploy_ernie TranslatedLayer vs eager", tl_out, eager[1], TOL["bf16"])
        clone = pred.clone()
        cl_out = _one_run(ta, lambda: _predictor_logits(clone, batches[0]),
                          "deploy_ernie clone B32 S128", L)
        if not torch.equal(cl_out, got[0]):
            raise AssertionError("deploy_ernie: the clone's logits differ from the predictor's")
        nbytes_art = _artifact_bytes(prefix)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dispatch = [flash_dispatch_us(ta, 32, 128, 12, 64), flash_dispatch_us(ta, 1, 1024, 32, 128)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    state["deploy_ernie_launches"] = launches
    log("deploy_ernie", card=state.get("smi"), params=n_params, dtype="bfloat16", layers=L,
        save_s=save_s, load_s=load_s, artifact_bytes=nbytes_art, graph_b1_nodes=graph_b1,
        runs=runs, cpu_saved=dict(save_s=cpu_save_s, load_s=cpu_load_s,
                                  bit_equal_to_eager=bool(torch.equal(got_cpu, eager[0])),
                                  **cmp_cpu),
        translated_layer=dict(bit_equal_to_eager=bool(torch.equal(tl_out, eager[1])), **cmp_tl),
        clone_equal=True, launches=launches, peak_mem_gb=peak, flash_dispatch=dispatch)
    del model, pred, cpu_pred, translated, clone
    torch.cuda.empty_cache()


def deploy_llama_static(ptt, ta, state):
    """static_llama_capture's Program at Llama-3-8B width, depth cut to
    DEPLOY_LLAMA_LAYERS (the weights travel inside the artifact), ids
    [-1, 512]: save_inference_model -> load_inference_model ->
    Executor.run at batch 4 and 2, and create_predictor over the same
    files. B1 exactly once a layer a run; the exported graph's B1 nodes
    equal fuse_attention's matches; the logits within serve_bf16's
    cached-logits limit of the eager forward (bit-equality reported)."""
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.static import io as sio
    from paddle_tpu_torch.static import passes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L = DEPLOY_LLAMA_LAYERS
    ptt.seed(0)
    model = LlamaForCausalLM(**dict(LLAMA3_8B, num_hidden_layers=L), device="cuda",
                             dtype="bfloat16").eval()
    seq = STATIC_IDS[1]
    main = static.Program()
    with static.program_guard(main, static.Program()):
        ids = static.data("ids", [-1, seq], "int64")
        logits = model(ids)
    rng = np.random.RandomState(0)
    feeds = [rng.randint(0, LLAMA3_8B["vocab_size"], (b, seq)).astype(np.int64)
             for b in DEPLOY_LLAMA_BATCHES]
    with torch.no_grad():
        eager = [model(torch.from_numpy(x).cuda()).float().cpu() for x in feeds]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        prefix = os.path.join(tmp, "llama")
        t0 = time.perf_counter()
        static.save_inference_model(prefix, [ids], [logits], program=main)
        save_s = time.perf_counter() - t0
        matches = passes.LAST_RESULT[0].matches["fuse_attention"]
        t0 = time.perf_counter()
        prog, feed_names, fetch = static.load_inference_model(prefix)
        load_s = time.perf_counter() - t0
        graph_b1 = sio.graph_ops(prog._module).count("paddle_tpu_torch.flash_fwd.default")
        if not graph_b1 == matches == L:
            raise AssertionError(f"deploy_llama_static: B1 nodes {graph_b1}, fuse_attention "
                                 f"matches {matches}, layers {L}")
        exe = static.Executor()

        def run_on_card(x):
            return exe.run(prog, feed={"ids": x}, fetch_list=fetch, return_numpy=False)[0]

        def run(x):
            return run_on_card(x).float().cpu()

        for x in feeds:  # warm-up
            run(x)
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(prefix))
        pred_load_s = time.perf_counter() - t0
        # the main path: every count 0 before it, read after it
        ta.reset_launch_counts()
        got = [_one_run(ta, lambda x=x: run(x), f"deploy_llama_static Executor B{x.shape[0]}", L)
               for x in feeds]
        got_pred = _one_run(ta, lambda: _predictor_logits(pred, [feeds[0]]),
                            "deploy_llama_static Predictor B4", L)
        launches = {k: v for k, v in ta.LAUNCHES.items() if v}
        runs = []
        for x, g, e in zip(feeds, got, eager):
            rel = ((g - e).norm(dim=-1) / e.norm(dim=-1).clamp_min(1e-30)).max().item()
            if not (rel <= LOGIT_REL_BOUND and torch.isfinite(g).all()):
                raise AssertionError(f"deploy_llama_static B{x.shape[0]}: logits rel err {rel} > "
                                     f"{LOGIT_REL_BOUND}")
            ids_dev = torch.from_numpy(x).cuda()
            with torch.no_grad():
                eager_ms = wall_ms(lambda: model(ids_dev))
            # the run to a synchronize, logits left on the card; then their copy to the host
            runs.append(dict(batch=x.shape[0], seq=seq, logits_max_row_rel_err=rel,
                             bit_equal_to_eager=bool(torch.equal(g, e)),
                             run_ms=wall_ms(lambda x=x: run_on_card(x)), eager_ms=eager_ms,
                             fetch_ms=wall_ms(lambda x=x: run(x)) - wall_ms(
                                 lambda x=x: run_on_card(x))))
        if not torch.equal(got_pred, got[0]):
            raise AssertionError("deploy_llama_static: the Predictor's logits differ from "
                                 "Executor.run's")
        pred_ms = wall_ms(lambda: _predictor_run(pred, [feeds[0]]))
        nbytes_art = _artifact_bytes(prefix)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    state["deploy_llama_launches"] = launches
    log("deploy_llama_static", card=state.get("smi"), layers=L, seq=seq, dtype="bfloat16",
        weights_gb=sum(nbytes(p) for p in model.parameters()) / 1e9, save_s=save_s,
        load_s=load_s, predictor_load_s=pred_load_s, artifact_bytes=nbytes_art,
        fuse_attention_matches=matches, graph_b1_nodes=graph_b1, runs=runs,
        predictor_run_ms=pred_ms, predictor_equals_executor=True, rel_err_bound=LOGIT_REL_BOUND,
        launches=launches, peak_mem_gb=peak)
    del model, main, prog, pred
    torch.cuda.empty_cache()


def deploy_parity(ptt, ta, state):
    """The tiny f32 Llama (save_inference_model, ids [-1, 64]) and the tiny
    ERNIE classifier (jit.save, [-1, -1] inputs) exported on the card and on
    the CPU from one set of weights, each loaded and run where it was
    saved: outputs within TOL["f32"], the exported graphs' op lists equal."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification, ErnieModel
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.static import io as sio

    ptt.seed(5)
    ptt.set_device("cpu")
    llama_ref = LlamaForCausalLM(**TINY_LLAMA, device="cpu").eval().state_dict()
    ernie_ref = ErnieForSequenceClassification(ErnieModel(**TINY_ERNIE), num_classes=3).state_dict()
    rng = np.random.RandomState(6)
    ids = rng.randint(0, TINY_LLAMA["vocab_size"], (3, 64)).astype(np.int64)
    cls_in = [rng.randint(1, TINY_ERNIE["vocab_size"], (4, 48)).astype(np.int64),
              rng.randint(0, 2, (4, 48)).astype(np.int64)]
    runs = {}
    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        for dev in ("cuda", "cpu"):
            ptt.set_device(dev)
            llama = LlamaForCausalLM(**TINY_LLAMA, device="meta")
            llama.load_state_dict({k: t.to(dev) for k, t in llama_ref.items()}, assign=True)
            llama.eval()
            main = static.Program()
            with static.program_guard(main, static.Program()):
                fi = static.data("ids", [-1, 64], "int64")
                out = llama(fi)
            static.save_inference_model(os.path.join(tmp, f"llama_{dev}"), [fi], [out],
                                        program=main)
            prog, _, fetch = static.load_inference_model(os.path.join(tmp, f"llama_{dev}"))
            ernie = ErnieForSequenceClassification(ErnieModel(**TINY_ERNIE), num_classes=3)
            ernie.load_state_dict({k: t.to(dev) for k, t in ernie_ref.items()})
            prefix = os.path.join(tmp, f"ernie_{dev}")
            ptt.jit.save(ernie, prefix, input_spec=[InputSpec([-1, -1], "int64"),
                                                    InputSpec([-1, -1], "int64")])
            tl = ptt.jit.load(prefix)
            # the main path (the card's two artifact runs): counts 0 before, read after
            ta.reset_launch_counts()
            (logits,) = static.Executor().run(prog, feed={"ids": ids}, fetch_list=fetch,
                                              return_numpy=False)
            cls = tl(*cls_in)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in ta.LAUNCHES.items() if v}
            runs[dev] = dict(llama=logits.float().cpu(), ernie=cls.float().cpu(),
                             llama_ops=sio.graph_ops(prog._module), ernie_ops=sio.graph_ops(tl.program))
    finally:
        ptt.set_device("cuda")
        shutil.rmtree(tmp, ignore_errors=True)
    card, cpu = runs["cuda"], runs["cpu"]
    for key in ("llama_ops", "ernie_ops"):
        if card[key] != cpu[key]:
            raise AssertionError(f"deploy_parity: {key} differ card vs CPU: "
                                 f"{sorted(set(card[key]) ^ set(cpu[key]))}")
    n_b1 = TINY_LLAMA["num_hidden_layers"] + TINY_ERNIE["num_hidden_layers"]
    if launches != {"flash_fwd": n_b1}:
        raise AssertionError(f"deploy_parity: launches {launches}, expected B1 {n_b1}")
    cmp = {m: compare(f"deploy_parity {m} card vs CPU", card[m], cpu[m], TOL["f32"])
           for m in ("llama", "ernie")}
    state["deploy_parity_launches"] = launches
    log("deploy_parity", tiny_llama=dict(TINY_LLAMA), tiny_ernie=dict(TINY_ERNIE), dtype="float32",
        ops_equal=True, n_ops={k: len(card[k]) for k in ("llama_ops", "ernie_ops")},
        launches=launches, **cmp)


# ---------------------------------------------------------------------------
# static.nn and the rest of paddle.static: ResNet-50 as a static.nn Program
# ---------------------------------------------------------------------------

# 2 warm-up steps, 5 timed, then more to resnet50_train's 16 (2 + 10 + 4), at
# which its loss has fallen below the first step's: at lr 0.1 from a random
# init the loss of the one batch climbs back over the first at steps 5-7
STATIC_RESNET_WARMUP, STATIC_RESNET_STEPS, STATIC_RESNET_TOTAL = 2, 5, 16
STATIC_RESNET_EMA = 0.9999
STATIC_RESNET_EVAL_RUNS = 3


def _timed_ms(fn):
    """(result, ms) of one call of `fn`, to a synchronize on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _topk_acc(logits, labels, k):
    return (logits.topk(k, dim=-1).indices == labels.reshape(-1, 1)).any(dim=-1).float().mean()


def static_resnet50_train(ptt, ta, state):
    """resnet50_train's step (bench.py:1982-2006: B64 3x224x224, 1000
    classes, Momentum 0.1 wd 1e-4, O1 bf16) as PaddleClas writes it in
    static mode: ResNet-50 from static.nn builders (tests/
    torch_static_resnet.py) over static.data("image", [-1, 3, 224, 224]),
    the loss and static.accuracy at k 1 and 5 fetched, Momentum.minimize,
    run through CompiledProgram(prog, BuildStrategy()), an
    ExponentialMovingAverage(0.9999) updated after each step. The weights
    are the port's seed-0 vision.models.resnet50, mapped in call order with
    a shape check. 16 static steps (2 warm-up, 5 timed), then the eager
    model the same steps from the same weights: each loss within 1e-3, the
    last below the first, the running
    buffers within TOL["bf16"], accuracy the top-k of the fetched logits,
    no hand-written kernel launched. Then prog.clone(for_test=True) at B64
    under ema.apply(): the logits within TOL["bf16"] of the eager model in
    eval() with the EMA weights and the program's buffers, the buffers
    unchanged by its runs."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.vision.models import resnet50

    sr = _tests_module("torch_static_resnet")
    nn = ptt.nn
    B, steps = RESNET_BATCH, STATIC_RESNET_TOTAL
    timed = range(STATIC_RESNET_WARMUP, STATIC_RESNET_WARMUP + STATIC_RESNET_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ptt.set_flags({"FLAGS_fused_optimizer": False})
    ptt.seed(0)
    model = resnet50(num_classes=1000)
    rng = np.random.RandomState(0)
    imgs = ptt.to_tensor(rng.randn(B, 3, 224, 224).astype(np.float32))
    labels = ptt.to_tensor(rng.randint(0, 1000, (B,)).astype(np.int64))
    params, bn_buffers = sr.eager_call_order(model, imgs[:2], nn.Conv2D, nn.BatchNorm2D,
                                             nn.Linear)
    t0 = time.perf_counter()
    main, fetch, ema = sr.train_program(ptt, -1, 224, amp="O1", ema_decay=STATIC_RESNET_EMA)
    capture_s = time.perf_counter() - t0
    sr.check_shapes(main.all_parameters(), params)
    with torch.no_grad():
        for p, q in zip(main.all_parameters(), params):
            p.copy_(q)
    prog_buffers = sr.program_bn_buffers(main)
    if len(prog_buffers) != len(bn_buffers):
        raise AssertionError(f"static_resnet50_train: {len(prog_buffers)} batch norms recorded, "
                             f"the eager model calls {len(bn_buffers)}")
    compiled = static.CompiledProgram(main, static.BuildStrategy())
    exe = static.Executor()
    feed = {"image": imgs, "label": labels.reshape(-1, 1)}
    fetch_list = [fetch[k] for k in ("loss", "logits", "acc1", "acc5")]
    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    static_losses, step_ms, ema_ms, acc = [], [], [], []
    for i in range(steps):
        out, ms = _timed_ms(lambda: exe.run(compiled, feed=feed, fetch_list=fetch_list,
                                            return_numpy=False))
        _, ems = _timed_ms(ema.update)
        loss, logits, a1, a5 = out
        static_losses.append(loss.item())
        acc.append([a1.item(), a5.item(), _topk_acc(logits, labels, 1).item(),
                    _topk_acc(logits, labels, 5).item()])
        if i in timed:
            step_ms.append(ms)
            ema_ms.append(ems)
    launches = dict(ta.LAUNCHES)
    static_peak = torch.cuda.max_memory_allocated() / 1e9
    static_ms = float(np.mean(step_ms))
    # the buffers after the compared steps (the profile below trains on)
    trained_buffers = [tuple(t.clone() for t in pb) for pb in prog_buffers]
    static_prof = profile_train(lambda: exe.run(compiled, feed=feed, fetch_list=[fetch["loss"]],
                                                return_numpy=False), static_ms)
    # the same steps eagerly, from the same weights (the eager model is the copy)
    opt = ptt.optimizer.Momentum(0.1, parameters=model.parameters(), weight_decay=1e-4)

    def eager_step():
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = ptt.nn.functional.cross_entropy(model(imgs), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    eager_losses, eager_step_ms = [], []
    for i in range(steps):
        loss, ms = _timed_ms(eager_step)
        eager_losses.append(loss.item())
        if i in timed:
            eager_step_ms.append(ms)
    eager_ms = float(np.mean(eager_step_ms))
    launches_after = dict(ta.LAUNCHES)
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(static_losses, eager_losses)]
    if any(launches_after.values()):
        raise AssertionError(f"static_resnet50_train: a hand-written kernel launched: "
                             f"{launches_after}")
    if not (all(math.isfinite(x) for x in static_losses) and static_losses[-1] < static_losses[0]
            and max(rel) <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"static_resnet50_train: static losses {static_losses} vs eager "
                             f"{eager_losses}: rel err {rel} > {TRAIN_LOSS_RTOL}, or not falling")
    if any(a[0] != a[2] or a[1] != a[3] for a in acc):
        raise AssertionError(f"static_resnet50_train: static.accuracy is not the top-k of the "
                             f"fetched logits: {acc}")
    buf = {}
    for kind, i in (("mean", 0), ("variance", 1)):
        got = torch.cat([pb[i].reshape(-1) for pb in trained_buffers])
        want = torch.cat([eb[i].reshape(-1) for eb in bn_buffers])
        buf[kind] = compare(f"static_resnet50_train running {kind} against eager", got, want,
                            TOL["bf16"])
    # the eval clone under the EMA weights
    test_prog = main.clone(for_test=True)
    saved = [tuple(t.clone() for t in pb) for pb in prog_buffers]
    with ema.apply():
        eval_ms = []
        for _ in range(STATIC_RESNET_EVAL_RUNS):
            (eval_logits,), ms = _timed_ms(lambda: exe.run(test_prog, feed=feed,
                                                           fetch_list=[fetch["logits"]],
                                                           return_numpy=False))
            eval_ms.append(ms)
        moved = [k for k, (pb, sb) in enumerate(zip(prog_buffers, saved))
                 if not (torch.equal(pb[0], sb[0]) and torch.equal(pb[1], sb[1]))]
        with torch.no_grad():
            for p, q in zip(params, main.all_parameters()):
                p.copy_(q)
            for (em, ev), (pm, pv) in zip(bn_buffers, prog_buffers):
                em.copy_(pm)
                ev.copy_(pv)
        model.eval()
        with torch.no_grad(), ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            eager_eval = model(imgs)
        model.train()
    if moved:
        raise AssertionError(f"static_resnet50_train: the eval clone wrote the buffers of batch "
                             f"norms {moved[:8]}")
    eval_cmp = compare("static_resnet50_train eval clone against eager eval()", eval_logits,
                       eager_eval, TOL["bf16"])
    flops = resnet_flops_per_image(ptt, model)
    state["static_resnet_launches"] = launches

    def figures(ms, peak, prof):
        ips = B / (ms / 1e3)
        return dict(ms_per_step=ms, images_per_sec=ips, mfu=ips * flops / PEAK_FLOPS[torch.bfloat16],
                    peak_mem_gb=peak, device_busy_ms=prof["device_busy_ms"] if prof else None,
                    device_idle_share=prof["device_idle_share"] if prof else None)

    log("static_resnet50_train", batch=B, image=[3, 224, 224], classes=1000, layers=50,
        params_m=sum(p.numel() for p in main.all_parameters()) / 1e6, capture_s=capture_s,
        n_ops_recorded=len(main.ops), n_batch_norms=len(prog_buffers), steps=steps,
        losses_static=static_losses, losses_eager=eager_losses, loss_rel_err=rel,
        loss_rel_bound=TRAIN_LOSS_RTOL, accuracy_top1_top5=[a[:2] for a in acc],
        ema_decay=STATIC_RESNET_EMA, ema_update_ms=float(np.mean(ema_ms)),
        eval_ms=eval_ms, flops_per_image=flops, launches=launches,
        static=figures(static_ms, static_peak, static_prof),
        eager=figures(eager_ms, torch.cuda.max_memory_allocated() / 1e9, None),
        buffers=buf, eval_clone=eval_cmp)
    log("static_resnet50_train profile", static=static_prof)
    del main, compiled, test_prog, exe, model, opt, ema
    torch.cuda.empty_cache()


def _fetch_outs(out):
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return [o for o in outs if o is not None]


def static_nn_run(ptt, static, dev, build, feeds, params=None):
    """One static.nn case captured and run on `dev` (seed 0 before the
    capture: nce's noise seed); its parameters from `params` (CPU tensors,
    in all_parameters order) when given. Returns (outputs on the CPU, the
    parameters on the CPU, the program)."""
    ptt.set_device(dev)
    ptt.seed(0)
    main = static.Program()
    with static.program_guard(main, static.Program()):
        xs = [static.data(n, list(a.shape), str(a.dtype)) for n, a in feeds]
        outs = _fetch_outs(build(ptt, static, *xs))
    mine = main.all_parameters()
    if params is None:
        params = [p.detach().cpu().clone() for p in mine]
    else:
        _tests_module("torch_static_resnet").check_shapes(mine, params)
        with torch.no_grad():
            for p, q in zip(mine, params):
                p.copy_(q)
    feed = {n: torch.from_numpy(np.array(a)).to(dev) for n, a in feeds}
    got = static.Executor().run(main, feed=feed, fetch_list=outs, return_numpy=False)
    return [g.detach().cpu() for g in got], params, main


def _hold_f32(name, got, want):
    if not want.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: card and CPU differ: {got} != {want}")
        return 0.0
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} on the card, "
                             f"{want.dtype}{tuple(want.shape)} on the CPU")
    d = want.shape[-1] if want.dim() else 1
    return compare(name, got.reshape(-1, d), want.reshape(-1, d), TOL["f32"])["worst_elem_ratio"]


def static_nn_parity(ptt, ta):
    """Every case of tests/torch_static_nn_table.py (each static.nn builder,
    the sequence ops, control flow, jit.cond on both branches, gradients
    under capture, Print, accuracy, auc, ctr_metric_bundle, nce) captured
    and run on the CPU and on the card from the CPU's parameters: floats
    within TOL["f32"], integers exact; the eager sequence lengths exact;
    an EMA over one program's parameters, card against CPU."""
    from paddle_tpu_torch import static

    table = _tests_module("torch_static_nn_table")
    cases = table.BUILDERS + table.SEQUENCE + table.EXTRAS
    worst, n_out = {}, 0
    try:
        for cid, build, feeds in cases:
            want, params, _ = static_nn_run(ptt, static, "cpu", build, feeds)
            got, _, _ = static_nn_run(ptt, static, "cuda", build, feeds, params)
            if len(got) != len(want):
                raise AssertionError(f"static_nn_parity {cid}: {len(got)} outputs on the card, "
                                     f"{len(want)} on the CPU")
            worst[cid] = max(_hold_f32(f"static_nn_parity {cid}[{i}]", g, w)
                             for i, (g, w) in enumerate(zip(got, want)))
            n_out += len(got)
        # eager: the lengths sequence_pad gives and sequence_unpad reads
        x = table.randn(3, 6, 2)
        lens = np.array([2, 4, 1], np.int64)
        eager = {}
        for dev in ("cpu", "cuda"):
            ptt.set_device(dev)
            _, ln = static.nn.sequence_pad(ptt.to_tensor(x), 0.0, maxlen=8)
            un = static.nn.sequence_unpad(ptt.to_tensor(x), ptt.to_tensor(lens))
            eager[dev] = (ln.cpu(), un.cpu())
        if not (torch.equal(eager["cpu"][0], eager["cuda"][0])
                and eager["cuda"][0].tolist() == [6, 6, 6]):
            raise AssertionError(f"static_nn_parity: sequence_pad lengths {eager}")
        _hold_f32("static_nn_parity sequence_unpad", eager["cuda"][1], eager["cpu"][1])
        # EMA: three updates over the fc case's parameters, applied
        ema_vals = {}
        for dev in ("cpu", "cuda"):
            ptt.set_device(dev)
            ptt.seed(0)
            main = static.Program()
            with static.program_guard(main, static.Program()):
                static.nn.fc(static.data("x", [2, 4]), 3)
                ema = static.ExponentialMovingAverage(0.9)
            ps = main.all_parameters()
            for k in range(3):
                with torch.no_grad():
                    for j, p in enumerate(ps):
                        p.copy_(torch.from_numpy(table.randn(*p.shape, seed=10 * k + j)))
                ema.update()
            with ema.apply():
                ema_vals[dev] = [p.detach().cpu().clone() for p in ps]
        for j, (g, w) in enumerate(zip(ema_vals["cuda"], ema_vals["cpu"])):
            worst[f"ema[{j}]"] = _hold_f32(f"static_nn_parity ema[{j}]", g, w)
    finally:
        ptt.set_device("cuda")
    log("static_nn_parity", cases=len(cases), outputs=n_out, tol=TOL["f32"],
        worst_elem_ratio=max(worst.values()),
        worst_case=max(worst, key=worst.get), by_case={k: round(v, 4) for k, v in worst.items()})



# ---------------------------------------------------------------------------
# the training guardian, the profiler and the compile cache on the card
# ---------------------------------------------------------------------------

GUARD_STEPS = 10
GUARD_NAN_AT = 3  # loop index of the injected NaN: after the first snapshot (step 2)
GUARD_PAIRS = 3  # plain/guarded step pairs timed in turns (A B B A)
GUARD_FLOP_RTOL = 0.10
DIGEST_CPU_ELEMS = 1 << 24  # elements of each flat moment digested again on the CPU


def llama_step_flops(cfg, batch, seq) -> float:
    """The analytic FLOPs of one training step of LlamaForCausalLM that
    counting_flops() counts: 6 FLOPs a weight a token for every Linear
    (forward, dX, dW: the q, k, v, o, gate, up and down projections of each
    layer and the LM head; the embedding lookup is no matmul), and the
    flash kernels' model FLOPs, 12 b h d a causal (query, key) pair a layer
    (forward 4, backward 8; ops.attention.flash_flops)."""
    from paddle_tpu_torch.ops.attention import attended_pairs

    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    kv = cfg.get("num_key_value_heads") or heads
    d = h // heads
    per_layer = h * h + 2 * h * kv * d + h * h + 3 * h * cfg["intermediate_size"]
    n_mm = cfg["num_hidden_layers"] * per_layer + h * cfg["vocab_size"]
    attn = 12.0 * batch * heads * d * attended_pairs(seq, seq, True) * cfg["num_hidden_layers"]
    return 6.0 * n_mm * batch * seq + attn


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def guarded_train_bf16(ptt, ta, state, steps=GUARD_STEPS):
    """train_bf16's configuration (Llama-3-8B layer shape, 4 layers, S4096,
    B1, O1 bf16, fused AdamW with a bf16 moment2) under FLAGS_check_nan_inf
    and TrainingGuardian(policy="rollback") with FLAGS_lkg_interval 2 and
    FLAGS_lkg_ring 2: 10 steps inside a Profiler (one record window,
    export_chrome_tracing) and profiler.benchmark(), a FaultPlan injecting
    guardian.grad_nan once after the first snapshot. Limits: the injected
    step rolls back and the state equals the snapshot bit for bit (the
    digest, card against CPU too), exact launches (no B5 for the rolled
    back step), finite losses, the trace holds the hand-written kernels'
    device events, perf_report() validates, and the counted FLOPs are
    within 10% of llama_step_flops."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed.resilience import fault_injection as fi
    from paddle_tpu_torch.framework import guardian as G
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.profiler import perf_attribution as pa

    cfg = dict(LLAMA3_8B, num_hidden_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    ptt.set_flags({"FLAGS_fused_optimizer": True, "FLAGS_check_nan_inf": True,
                   "FLAGS_lkg_interval": 2, "FLAGS_lkg_ring": 2})
    ptt.seed(0)
    torch.cuda.reset_peak_memory_stats()
    pa.reset()
    model = LlamaForCausalLM(**cfg, device="cuda")
    opt = ptt.optimizer.AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                              moment2_dtype="bfloat16")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg["vocab_size"],
                                                            (1, TRAIN_SEQ))).cuda()
    work = tempfile.mkdtemp(prefix="guarded_train_")
    guardian = ptt.TrainingGuardian(opt, policy="rollback", crash_dir=os.path.join(work, "crash"))
    rollback_ms = []
    rollback = guardian.rollback

    def timed_rollback():
        out, ms = _synced_ms(rollback)
        rollback_ms.append(ms)
        return out

    guardian.rollback = timed_rollback

    def fwd_bwd():
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        return loss

    trace_dir = os.path.join(work, "trace")
    sched = profiler.make_scheduler(closed=5, ready=1, record=2, repeat=1)
    bench = profiler.benchmark()
    for stat in (bench.reader_cost, bench.batch_cost, bench.ips_stat):
        stat.skip_n = 2  # its default skips 10 warm-up steps: the whole run
    verdicts, losses, step_ms, per_step, step_peak, pre_digest = [], [], [], [], [], None
    # the main path: every count 0 before it, read after it
    ta.reset_launch_counts()
    with profiler.Profiler(scheduler=sched,
                           on_trace_ready=profiler.export_chrome_tracing(trace_dir)) as prof:
        for i in range(steps):
            fi.install_plan(fi.FaultPlan(seed=0).add("guardian.grad_nan", "corrupt")
                            if i == GUARD_NAN_AT else None)
            before = dict(ta.LAUNCHES)
            if i == GUARD_NAN_AT:
                pre_digest = G.digest_arrays(guardian.snapshot_tensors())

            def one():
                loss = fwd_bwd()
                verdict = guardian.step(loss)
                opt.clear_grad()
                return loss, verdict

            torch.cuda.reset_peak_memory_stats()
            (loss, verdict), ms = _synced_ms(one)
            step_peak.append(torch.cuda.max_memory_allocated() / 1e9)
            fi.install_plan(None)
            prof.step(num_samples=TRAIN_SEQ)
            verdicts.append(verdict)
            losses.append(loss.item())
            step_ms.append(ms)
            per_step.append({k: ta.LAUNCHES[k] - before[k] for k in TRAIN_PER_STEP})
            if i == GUARD_NAN_AT:
                snap = guardian.snapshots[-1]
                post = G.digest_arrays(guardian.state_tensors())
                hosts_ok = all(h[k] == v for h, k, v in snap["slots"]
                               if not isinstance(v, torch.Tensor))
                if not (verdict == "rolled_back" and post.tolist() == pre_digest.tolist()
                        and hosts_ok and opt._step_count == snap["step"]):
                    raise AssertionError(
                        f"guarded_train_bf16: step {i} verdict {verdict}, state digest equal "
                        f"{post.tolist() == pre_digest.tolist()}, host state equal {hosts_ok}, "
                        f"@step {opt._step_count} vs the snapshot's {snap['step']}")
                # the digest is integer math: the card's equals the CPU's
                flat = [t for t, _ in opt._fused_state_entries()]
                probe = [next(model.parameters())] + [t[:DIGEST_CPU_ELEMS] for t in flat]
                card, cpu = (G.digest_arrays(probe).tolist(),
                             G.digest_arrays([t.cpu() for t in probe]).tolist())
                if card != cpu:
                    raise AssertionError(f"guarded_train_bf16: digest card {card} != cpu {cpu}")
                rolled_back_to = snap["step"]
                del snap, probe, flat  # the ring alone holds snapshots: it evicts this one later
    launches = dict(ta.LAUNCHES)
    peak = max(step_peak)  # the guarded run's, the ring included
    expect = ["rolled_back" if i == GUARD_NAN_AT else "ok" for i in range(steps)]
    clean = verdicts.count("ok")
    want_launches = {k: steps * TRAIN_LAYERS for k in ("flash_fwd", "flash_bwd_dq",
                                                        "flash_bwd_dkdv")}
    want_launches["fused_adamw"] = clean * TRAIN_PER_STEP["fused_adamw"]
    if verdicts != expect or {k: launches[k] for k in want_launches} != want_launches:
        raise AssertionError(f"guarded_train_bf16: verdicts {verdicts} (want {expect}), launches "
                             f"{launches} (want {want_launches})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"guarded_train_bf16: losses not finite: {losses}")
    # the exported record window holds the hand-written kernels' device events
    (trace_file,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    trace = json.load(open(trace_file))
    dev = [e for e in trace["traceEvents"] if e.get("pid") == 1]
    kern = {k: sum(1 for e in dev if k in e["name"])
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "fused_adamw")}
    # on the host spans' clock: every device event inside the recorded steps
    host = [e for e in trace["traceEvents"] if e.get("pid") == 0 and e.get("cat") == "ProfileStep"]
    lo, hi = min(e["ts"] for e in host), max(e["ts"] + e["dur"] for e in host)
    outside = sum(1 for e in dev if not lo <= e["ts"] <= hi)
    if not all(kern.values()) or outside:
        raise AssertionError(f"guarded_train_bf16: the trace's device events miss a kernel "
                             f"({kern} of {len(dev)} device events) or {outside} lie outside the "
                             f"recorded steps")
    report = pa.perf_report()
    pa.validate_report(json.loads(json.dumps(report, default=str)))
    window = [i for i in range(steps) if sched(i).name.startswith("RECORD")]
    # clean steps that took no snapshot (@step odd after them), not the first
    plain_idx = [i for i in range(1, steps) if verdicts[i] == "ok" and i % 2 == 0]
    quiet = [i for i in plain_idx if i not in window]
    profiled_ms = float(np.mean([step_ms[i] for i in window if i in plain_idx]))
    quiet_ms = float(np.mean([step_ms[i] for i in quiet]))

    # plain against guarded steps in turns (A B B A ...), no snapshot due
    ptt.set_flags({"FLAGS_lkg_interval": 10 ** 9})

    def plain():
        fwd_bwd()
        opt.step()
        opt.clear_grad()

    def guarded():
        loss = fwd_bwd()
        if guardian.step(loss) != "ok":
            raise AssertionError("guarded_train_bf16: a paired guarded step was not clean")
        opt.clear_grad()

    pairs = {"plain": [], "guarded": []}
    for k in range(GUARD_PAIRS):
        for name in (("plain", "guarded") if k % 2 == 0 else ("guarded", "plain")):
            pairs[name].append(_synced_ms(plain if name == "plain" else guarded)[1])
    loss = fwd_bwd()
    grads = [p.grad for p in model.parameters()]
    params = list(model.parameters())
    check_ms = [_synced_ms(lambda: G.check_arrays(grads, params + [loss.detach()]))[1]
                for _ in range(5)]
    check_bytes = nbytes(*grads, *params)
    del grads, params, loss
    opt.clear_grad()
    snap_ms = [_synced_ms(guardian.snapshot)[1] for _ in range(2)]
    snap_gb = nbytes(*guardian.snapshot_tensors()) / 1e9
    census, census_ms = _synced_ms(lambda: pa.live_array_census(set_gauges=False))
    with pa.counting_flops() as count:
        loss = fwd_bwd()
        opt.step()
        opt.clear_grad()
    torch.cuda.synchronize()
    want_flops = llama_step_flops(cfg, 1, TRAIN_SEQ)
    if not abs(count.total - want_flops) <= GUARD_FLOP_RTOL * want_flops:
        raise AssertionError(f"guarded_train_bf16: counted FLOPs {count.total:.4e} vs the "
                             f"analytic {want_flops:.4e}: off by more than {GUARD_FLOP_RTOL}")
    roof = pa.roofline(count.total, 0.0, float(np.median(pairs["guarded"])) / 1e3)
    state["guarded_launches"] = launches
    log("guarded_train_bf16", layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=1, steps=steps,
        verdicts=verdicts, losses=losses, step_ms=step_ms, launches=launches,
        launches_per_step=per_step, rollback_ms=rollback_ms, rolled_back_to=rolled_back_to,
        state_digest_equal=True, digest_card_eq_cpu=True,
        plain_step_ms=pairs["plain"], guarded_step_ms=pairs["guarded"],
        check_ms=check_ms, check_bytes_gb=check_bytes / 1e9,
        check_bound_ms=check_bytes / PEAK_BYTES * 1e3, snapshot_ms=snap_ms, snapshot_gb=snap_gb,
        census_ms=census_ms, census_tensors=census["count"], census_gb=census["bytes"] / 1e9,
        profiled_step_ms=profiled_ms, unprofiled_step_ms=quiet_ms,
        profiler_overhead=profiled_ms / quiet_ms - 1.0, record_window=window,
        trace_device_events=len(dev), trace_kernel_events=kern,
        trace_window_ms=(hi - lo) / 1e3,
        benchmark=bench.step_info(unit="tokens/s"), benchmark_batch_cost_s=bench.batch_cost.avg,
        flops_counted=count.total, flops_dispatched=count.dispatched,
        flops_kernels=count.kernels, flops_analytic=want_flops,
        flops_rel_err=count.total / want_flops - 1.0, mfu=roof["mfu"],
        perf_report_programs=len(report["programs"]), peak_mem_gb=peak,
        step_peak_gb=step_peak)
    ptt.set_flags({"FLAGS_check_nan_inf": False, "FLAGS_lkg_interval": 100, "FLAGS_lkg_ring": 2})
    shutil.rmtree(work, ignore_errors=True)
    guardian.rollback = rollback
    del model, opt, guardian
    gc.collect()
    torch.cuda.empty_cache()


COLD_START_PROMPT_LEN = 64
COLD_START_NEW = 4
COLD_START_CONSISTENCY = 0.05


def cold_start_child(out_path: str) -> int:
    """One cold-start process (run by cold_start): serve_bf16's engine built
    from seed-0 weights, one prompt through it for 4 new tokens, with the
    kernels built into an empty $PADDLE_TPU_KERNEL_BUILD_DIR, or restored
    from $PADDLE_TPU_COMPILE_CACHE_DIR. Writes its ids, launches, build
    stats, ledger dump and the compile-cache error counters to out_path."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import compile_cache as cc
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import attention as ta
    from paddle_tpu_torch.ops.kernels import build

    ptt.set_device("cuda")
    ptt.seed(0)
    model = LlamaForCausalLM(**LLAMA3_8B, device="cuda", dtype="bfloat16").eval()
    prompt = np.random.RandomState(3).randint(1, LLAMA3_8B["vocab_size"],
                                              COLD_START_PROMPT_LEN).tolist()
    torch.cuda.synchronize()
    cc.ledger.reset()
    ta.reset_launch_counts()
    t0 = time.perf_counter()
    engine = InferenceEngine(model, max_seq_len=512, block_size=16, max_batch=1)
    ids = engine.generate([prompt], max_new_tokens=COLD_START_NEW)[0]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    dump = cc.ledger.dump_json(out_path + ".ledger.json")
    fam = telemetry.default_registry().get("paddle_tpu_compile_cache_errors_total")
    errors = {dict(c.labels)["reason"]: c.value for c in fam.children()} if fam else {}
    libs = sorted(p for p in os.listdir(build.BUILD_DIR) if p.endswith(".so"))
    json.dump({"ids": ids, "launches": dict(ta.LAUNCHES), "build": dict(build.BUILD_STATS),
               "ledger": dump, "errors": errors, "libs": libs, "total_s": total_s,
               "steps": dict(engine.step_counts)}, open(out_path, "w"))
    return 0


def cold_start(ptt, ta, state):
    """Two processes on one empty PADDLE_TPU_COMPILE_CACHE_DIR, each from a
    build directory holding no kernel library (cold: nvcc, then persist;
    warm: restore, no nvcc), then a third after one payload byte of the
    flash forward's entry is flipped (a counted CRC rejection, that library
    rebuilt, the rest restored). Each builds serve_bf16's engine (32
    layers) and serves one prompt for 4 tokens (prefill and decode). Limits:
    equal ids, the restored libraries byte-equal to the built ones, no nvcc
    in the warm run, and each run's `python -m paddle_tpu_torch.compile_cache
    report` components summing to its engine-load -> first-token wall within
    5%."""
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="cold_start_")
    cache = os.path.join(work, "cache")
    runs = {}
    for name in ("cold", "warm", "corrupt"):
        if name == "corrupt":
            entries = [e for e in os.listdir(cache) if not e.startswith(".")]
            metas = {e: json.load(open(os.path.join(cache, e, "meta.json"))) for e in entries}
            (victim,) = [e for e, m in metas.items() if m["name"] == "flash_fwd"]
            pay = os.path.join(cache, victim, "payload.bin")
            raw = bytearray(open(pay, "rb").read())
            raw[len(raw) // 2] ^= 0x01
            open(pay, "wb").write(bytes(raw))
        bdir = os.path.join(work, f"build_{name}")
        os.makedirs(bdir)
        out = os.path.join(work, f"{name}.json")
        env = dict(os.environ, PADDLE_TPU_COMPILE_CACHE_DIR=cache, PADDLE_TPU_KERNEL_BUILD_DIR=bdir)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cold-start-child",
                               out], env=env, capture_output=True, text=True, timeout=600)
        wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cold_start: the {name} process failed:\n{proc.stderr[-4000:]}")
        res = json.load(open(out))
        cli = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.compile_cache", "report",
                              "--input", res["ledger"], "--json"], capture_output=True, text=True,
                             timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
        if cli.returncode != 0:
            raise AssertionError(f"cold_start: report CLI failed on the {name} run: {cli.stderr}")
        res["report"] = json.loads(cli.stdout)
        res["process_s"] = wall_s
        res["lib_bytes"] = {lib: open(os.path.join(bdir, lib), "rb").read() for lib in res["libs"]}
        runs[name] = res
    cold, warm, bad = runs["cold"], runs["warm"], runs["corrupt"]
    n_libs = len(cold["libs"])
    problems = []
    if not (cold["ids"] == warm["ids"] == bad["ids"] and len(cold["ids"]) == COLD_START_NEW):
        problems.append(f"ids differ: {cold['ids']} {warm['ids']} {bad['ids']}")
    if not (cold["build"]["nvcc_runs"] == n_libs and cold["build"]["restored"] == 0):
        problems.append(f"cold build {cold['build']}")
    if not (warm["build"]["nvcc_runs"] == 0 and warm["build"]["restored"] == n_libs):
        problems.append(f"warm build {warm['build']} (no nvcc, {n_libs} restores)")
    if warm["lib_bytes"] != cold["lib_bytes"]:
        problems.append("the restored libraries differ from the built ones")
    if not (bad["build"]["nvcc_runs"] == 1 and bad["build"]["restored"] == n_libs - 1
            and bad["errors"].get("crc_mismatch") == 1):
        problems.append(f"corrupt run: build {bad['build']}, errors {bad['errors']}")
    for name, res in runs.items():
        rep = res["report"]
        outcomes = rep.get("outcomes", {})
        want = ({"miss": n_libs, "persist": n_libs} if name == "cold" else
                {"restore": n_libs} if name == "warm" else
                {"miss": 1, "persist": 1, "restore": n_libs - 1})
        if not (rep.get("available") and abs(rep["consistency"] - 1.0) <= COLD_START_CONSISTENCY
                and outcomes == want):
            problems.append(f"{name} report {rep} (outcomes want {want})")
    if problems:
        raise AssertionError("cold_start: " + "; ".join(problems))
    launches = {}
    for res in runs.values():
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    state["cold_start_launches"] = launches
    comp = {name: res["report"]["components"] for name, res in runs.items()}
    log("cold_start", layers=LLAMA3_8B["num_hidden_layers"], prompt_len=COLD_START_PROMPT_LEN,
        new_tokens=COLD_START_NEW, ids=cold["ids"],
        wall_s={n: r["report"]["wall_s"] for n, r in runs.items()},
        consistency={n: r["report"]["consistency"] for n, r in runs.items()},
        components=comp, nvcc_s=cold["build"]["nvcc_s"], restore_s=warm["build"]["restore_s"],
        corrupt_run_nvcc_s=bad["build"]["nvcc_s"], libs=n_libs,
        lib_mb=sum(len(b) for b in cold["lib_bytes"].values()) / 1e6,
        process_s={n: r["process_s"] for n, r in runs.items()},
        engine_to_ids_s={n: r["total_s"] for n, r in runs.items()},
        steps=cold["steps"], launches=launches, errors_corrupt_run=bad["errors"])
    shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Input, vision and hapi (io/, io/streaming/, vision/{transforms,datasets},
# vision/models/mobilenet*, hapi/): PaddleClas's MobileNetV3-Large trained
# through hapi.Model.fit on the DataLoader, bench.py's streaming-input
# config, and the MobileNets card against CPU. No hand-written kernel lies
# on these paths: the convs are cuDNN's, as ResNet-50's are.
# ---------------------------------------------------------------------------

MBV3_TRAIN, MBV3_EVAL, MBV3_HW, MBV3_CROP = 1280, 256, 256, 224
MBV3_BATCH, MBV3_EPOCHS, MBV3_CLASSES = 64, 2, 1000
# ImageNet's channel means and stds on 0-255, PaddleClas's NormalizeImage
IMAGENET_MEAN, IMAGENET_STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
# the optimizer family of PaddleClas's MobileNetV3_large_x1_0.yaml (Momentum
# 0.9, cosine decay after a linear warm-up, L2Decay), at this run's batch
# and length: lr 0.1, warm-up 5 steps, cosine over the 40 steps, L2 4e-5
MBV3_LR, MBV3_WARMUP, MBV3_L2 = 0.1, 5, 4e-5
MBV3_NOISE = 24  # each pixel: its class's colour plus uniform noise in [-24, 24]


class ColourClassImages:
    """Seeded synthetic ImageNet-shaped data: `n` uint8 HWC images of
    MBV3_HW x MBV3_HW x 3 whose class (of MBV3_CLASSES) sets the mean
    colour (a seeded colour a class) under seeded noise, written once to
    `path` (.npy) and read back through a memory map, so a spawned
    DataLoader worker unpickles a path, not the images. A sample is the
    transformed image and its label as int64 [1]. A worker process that
    finds CUDA initialised raises: workers must stay host-only."""

    def __init__(self, path, n, seed, transform=None):
        rng = np.random.RandomState(seed)
        colours = np.random.RandomState(1234).randint(40, 216, (MBV3_CLASSES, 3)).astype(np.int16)
        self.labels = rng.randint(0, MBV3_CLASSES, n).astype(np.int64)
        if not os.path.exists(path):
            imgs = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                             shape=(n, MBV3_HW, MBV3_HW, 3))
            for i in range(n):
                noise = rng.randint(-MBV3_NOISE, MBV3_NOISE + 1, (MBV3_HW, MBV3_HW, 3),
                                    dtype=np.int16)
                imgs[i] = np.clip(colours[self.labels[i]] + noise, 0, 255)
            imgs.flush()
            del imgs
        self.path, self.transform, self._images = path, transform, None

    def __getstate__(self):
        return dict(self.__dict__, _images=None)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        import multiprocessing

        if multiprocessing.current_process().name != "MainProcess" and torch.cuda.is_initialized():
            raise RuntimeError("a DataLoader worker initialised CUDA")
        if self._images is None:
            self._images = np.load(self.path, mmap_mode="r")
        img = np.asarray(self._images[i])
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[i]], np.int64)


def report_worker(out_dir, worker_id):
    """worker_init_fn: each worker's pid and torch.cuda.is_initialized()."""
    with open(os.path.join(out_dir, f"worker{worker_id}.json"), "w") as f:
        json.dump({"pid": os.getpid(), "cuda_initialized": torch.cuda.is_initialized()}, f)


class ReaderTimed:
    """`loader` with each batch's arrival timed by profiler.benchmark()'s
    reader hooks (which feed io.streaming's wait statistics, the
    `paddle_tpu_input_wait_seconds` family); keeps the first `cache`
    batches (device tensors) for a replay."""

    def __init__(self, loader, bench, cache=0):
        self.loader, self.bench, self.cache_n, self.cache = loader, bench, cache, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            self.bench.before_reader()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.bench.after_reader()
            if len(self.cache) < self.cache_n:
                self.cache.append(batch)
            yield batch


def busy_ms_per_step(step, steps=3) -> float:
    """Device busy time a call of `step` (the CUDA kernels' own time in a
    torch.profiler trace over `steps` calls)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps


def mobilenetv3_fit(ptt, ta, state):
    """PaddleClas's MobileNetV3-Large (scale 1.0, 1000 classes, seed 0)
    trained through hapi: Model(net, InputSpec) .prepare(Momentum 0.9,
    LinearWarmup over CosineAnnealingDecay, L2Decay, CrossEntropyLoss,
    Accuracy(topk=(1, 5)), amp_configs="O1") .fit(2 epochs over the
    DataLoader: 1280 synthetic 256x256 images, batch 64, shuffled,
    RandomResizedCrop(224), RandomHorizontalFlip, Normalize, Transpose in
    spawned persistent workers) with the eval loader (256 images,
    CenterCrop) after each epoch, then evaluate and predict; the first
    epoch's batches again from memory (the device step alone);
    Model.save(training=False) and jit.load against the live model."""
    import functools

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.io.streaming import stats as instats
    from paddle_tpu_torch.static import InputSpec

    T = ptt.vision.transforms
    work = tempfile.mkdtemp(prefix="mbv3_")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_tf = T.Compose([T.RandomResizedCrop(MBV3_CROP), T.RandomHorizontalFlip(),
                          T.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="HWC"),
                          T.Transpose()])
    eval_tf = T.Compose([T.CenterCrop(MBV3_CROP),
                         T.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="HWC"),
                         T.Transpose()])
    train_ds = ColourClassImages(os.path.join(work, "train.npy"), MBV3_TRAIN, 0, train_tf)
    eval_ds = ColourClassImages(os.path.join(work, "eval.npy"), MBV3_EVAL, 1, eval_tf)
    data_s = time.perf_counter() - t0
    workers = min(8, (os.cpu_count() or 2) - 1)
    reports = os.path.join(work, "workers")
    os.makedirs(reports)
    np.random.seed(0)
    train_loader = ptt.io.DataLoader(train_ds, batch_size=MBV3_BATCH, shuffle=True, drop_last=True,
                                     num_workers=workers, persistent_workers=True,
                                     worker_init_fn=functools.partial(report_worker, reports))
    eval_loader = ptt.io.DataLoader(eval_ds, batch_size=MBV3_BATCH, num_workers=2)
    steps_per_epoch = len(train_loader)

    ptt.seed(0)
    net = ptt.vision.models.mobilenet_v3_large(scale=1.0, num_classes=MBV3_CLASSES)
    params_m = sum(p.numel() for p in net.parameters()) / 1e6
    macs = ptt.flops(net, [1, 3, MBV3_CROP, MBV3_CROP])
    total = MBV3_EPOCHS * steps_per_epoch
    sched = ptt.optimizer.lr.LinearWarmup(
        ptt.optimizer.lr.CosineAnnealingDecay(MBV3_LR, T_max=total), MBV3_WARMUP, 0.0, MBV3_LR)
    opt = ptt.optimizer.Momentum(sched, momentum=0.9, parameters=net.parameters(),
                                 weight_decay=ptt.regularizer.L2Decay(MBV3_L2))
    model = ptt.Model(net, inputs=[InputSpec([-1, 3, MBV3_CROP, MBV3_CROP], "float32", "image")],
                      labels=[InputSpec([-1, 1], "int64", "label")])
    model.prepare(opt, ptt.nn.CrossEntropyLoss(), ptt.metric.Accuracy(topk=(1, 5)),
                  amp_configs="O1")

    bench = profiler.benchmark()
    fed = ReaderTimed(train_loader, bench, cache=steps_per_epoch)
    clock = dict(losses=[[] for _ in range(MBV3_EPOCHS)], walls=[], waits=[], epoch=0, t=None)

    class FitClock(ptt.callbacks.Callback):
        """Each step's wall (batch end to batch end, the loss read to the
        host inside train_batch ends it), its input wait (take_step_wait,
        as the guardian takes it) and its loss."""

        def on_epoch_begin(self, epoch, logs=None):
            clock["epoch"], clock["t"] = epoch, time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            now = time.perf_counter()
            clock["walls"].append(now - clock["t"])
            clock["waits"].append(instats.take_step_wait() or 0.0)
            clock["losses"][clock["epoch"]].append(float(logs["loss"]))
            clock["t"] = now
            bench.step(num_samples=MBV3_BATCH)
            if len(clock["walls"]) == 1:
                # the first step waited for the workers' spawn: the input
                # pipeline's window (the verdict) starts after it, as the
                # step-time means below do
                instats.reset()
                instats.take_step_wait()

    instats.reset()
    instats.take_step_wait()
    ta.reset_launch_counts()  # the main path: every count 0 before it, read after it
    bench.begin()
    t0 = time.perf_counter()
    history = model.fit(fed, eval_data=eval_loader, epochs=MBV3_EPOCHS, verbose=0,
                        callbacks=[FitClock()])
    fit_s = time.perf_counter() - t0
    ev = model.evaluate(eval_loader, verbose=0)
    preds = model.predict(eval_loader, stack_outputs=True, verbose=0)
    torch.cuda.synchronize()
    bench.end()
    launches = no_kernel_launched(ta, "mobilenetv3_fit")
    pipeline = profiler.perf_report()["input_pipeline"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    worker_reports = [json.load(open(os.path.join(reports, f))) for f in sorted(os.listdir(reports))]
    train_loader._shutdown_workers()

    # the device step alone: the first epoch's batches again, from memory
    cached = fed.cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in cached:
        model.train_batch([x], [y])
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / len(cached)
    busy = busy_ms_per_step(lambda: model.train_batch([cached[0][0]], [cached[0][1]]))

    # inference export: save(training=False) -> jit.load against the live model
    prefix = os.path.join(work, "mobilenetv3_large")
    t0 = time.perf_counter()
    model.save(prefix, training=False)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ptt.jit.load(prefix)
    load_s = time.perf_counter() - t0
    x_eval = next(iter(eval_loader))[0]
    net.eval()
    with torch.no_grad():
        live = net(x_eval)
    export_rec = compare("mobilenetv3_fit jit.load", loaded(x_eval), live, TOL["f32"])

    walls, waits = np.array(clock["walls"]) * 1e3, np.array(clock["waits"]) * 1e3
    step_ms = float(np.mean(walls[1:]))  # the first step carries the workers' first batch
    means = [float(np.mean(l)) for l in clock["losses"]]
    flat = [x for l in clock["losses"] for x in l]
    preds = preds[0] if isinstance(preds, list) else preds
    if not (all(math.isfinite(x) for x in flat) and means[1] < means[0]):
        raise AssertionError(f"mobilenetv3_fit: losses not finite and falling: {clock['losses']}")
    if len(worker_reports) != workers or any(r["cuda_initialized"] for r in worker_reports):
        raise AssertionError(f"mobilenetv3_fit: a worker initialised CUDA: {worker_reports}")
    if tuple(preds.shape) != (MBV3_EVAL, MBV3_CLASSES) or not np.isfinite(
            np.asarray(preds, np.float32)).all():
        raise AssertionError(f"mobilenetv3_fit: predict gave {preds.shape}")
    if pipeline.get("verdict") not in ("starved", "input_limited", "compute"):
        raise AssertionError(f"mobilenetv3_fit: no input-pipeline verdict: {pipeline}")
    flops_per_image = 6.0 * macs  # forward 1x, backward 2x, 2 FLOPs a MAC
    images_per_sec = MBV3_BATCH / (step_ms / 1e3)
    state["mobilenetv3_launches"] = launches
    log("mobilenetv3_fit", model="MobileNetV3-Large x1.0", classes=MBV3_CLASSES,
        params_m=params_m, batch=MBV3_BATCH, image=[3, MBV3_CROP, MBV3_CROP],
        train_images=MBV3_TRAIN, eval_images=MBV3_EVAL, epochs=MBV3_EPOCHS,
        steps=len(flat), cpu_count=os.cpu_count(), workers=workers, data_s=data_s, fit_s=fit_s,
        epoch_mean_loss=means, first_last_loss=[flat[0], flat[-1]],
        history_last=history, evaluate=ev, predict_shape=list(preds.shape),
        ms_per_step=step_ms, ms_per_step_p50=float(np.median(walls[1:])),
        images_per_sec=images_per_sec, input_wait_ms_mean=float(np.mean(waits[1:])),
        input_wait_ms_p99=float(np.percentile(waits[1:], 99)),
        input_wait_share=float(waits[1:].sum() / walls[1:].sum()),
        first_step_ms=float(walls[0]), input_pipeline=pipeline,
        benchmark=bench.step_info("images/s"),
        device_step_ms_from_memory=replay_ms, device_busy_ms=busy,
        device_idle_share_fed=1.0 - busy / step_ms,
        device_idle_share_from_memory=1.0 - busy / replay_ms,
        macs_per_image=macs, flops_per_image=flops_per_image,
        mfu=images_per_sec * flops_per_image / PEAK_FLOPS[torch.bfloat16],
        peak_mem_gb=peak, save_s=save_s, load_s=load_s, export_vs_live=export_rec,
        worker_cuda_initialized=[r["cuda_initialized"] for r in worker_reports],
        launches=launches)
    del model, net, opt, loaded, cached, fed
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


# bench.py's _build_input_stream (bench.py:1535-1688) at its sizes, the
# defaults of its _input_dims (bench.py:1517-1532)
STREAM = dict(n_samples=4096, global_batch=64, features=1024, hidden=2048, classes=128,
              reader_work=100_000, steps=24, seed=7)
STREAM_WARMUP = 3  # bench.py's warm-up steps (the ring's fill)
STREAM_LOSS_RTOL = 1e-5
STREAM_CHECK_BATCHES = (5, 10)  # resume after 5 batches; compare up to batch 10
STREAM_HELD_BATCHES = 16  # read once for the checks: 10 and the rings' read-ahead
STREAM_CHECK_SLEEP_S = 0.05  # the donation check's consumer a step: the rings fill meanwhile


class HeavyReader:
    """bench.py's HeavyReader (bench.py:1573-1586) at STREAM's sizes:
    deterministic per-sample host work (a seeded normal draw and np.sin
    over `reader_work` elements)."""

    def __len__(self):
        return STREAM["n_samples"]

    def __getitem__(self, i):
        rng = np.random.RandomState((STREAM["seed"] * 1_000_003 + i) % 2 ** 31)
        w = rng.standard_normal(STREAM["reader_work"]).astype(np.float32)
        f = STREAM["features"]
        feat = np.sin(w[: (w.size // f) * f]).reshape(f, -1).mean(axis=1)
        return feat.astype(np.float32), np.int64(i % STREAM["classes"])


class HeldReader:
    """HeavyReader's samples at `indices` read once and served from memory
    (a reader far faster than the step, so the prefetch rings fill); any
    other index is read as HeavyReader reads it."""

    def __init__(self, indices):
        self.reader = HeavyReader()
        self.items = {int(i): self.reader[int(i)] for i in indices}

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, i):
        i = int(i)
        return self.items[i] if i in self.items else self.reader[i]


def stream_step(ptt):
    """bench.py's build_step: the seeded MLP, SGD 0.01 and a to_static
    train step returning the loss."""
    ptt.seed(STREAM["seed"])
    model = ptt.nn.Sequential(ptt.nn.Linear(STREAM["features"], STREAM["hidden"]), ptt.nn.ReLU(),
                              ptt.nn.Linear(STREAM["hidden"], STREAM["classes"]))
    opt = ptt.optimizer.SGD(0.01, parameters=model.parameters())

    @ptt.jit.to_static
    def train_step(x, y):
        loss = ptt.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return train_step


def stream_loader(dataset, depth, donate, source):
    from paddle_tpu_torch.io.streaming import StreamingLoader

    return StreamingLoader(dataset, STREAM["global_batch"], seed=STREAM["seed"], shuffle=True,
                           drop_last=True, prefetch_depth=depth, donate=donate, source=source)


def stream_measure(ptt, prefetch_depth):
    """bench.py's measure: a fresh step fed by a StreamingLoader over
    HeavyReader (donating when it prefetches), STREAM_WARMUP steps, then
    STREAM['steps'] timed ones -> (mean step s, p99 wait s, mean wait s,
    the final loss), the waits from io.streaming's own accumulator (the
    guardian's input_wait_s)."""
    from paddle_tpu_torch.io.streaming import stats as instats

    train_step = stream_step(ptt)
    loader = stream_loader(HeavyReader(), prefetch_depth, prefetch_depth > 0, "bench_input")
    it = iter(loader)
    walls, waits, loss = [], [], None

    def nxt():
        nonlocal it
        try:
            return next(it)
        except StopIteration:  # epoch rolled: keep streaming
            it = iter(loader)
            return next(it)

    for _ in range(STREAM_WARMUP):
        x, y = nxt()
        float(train_step(x, y).numpy())
    instats.take_step_wait()  # drop the warm-up's waits
    for _ in range(STREAM["steps"]):
        t0 = time.perf_counter()
        x, y = nxt()
        loss = float(train_step(x, y).numpy())
        walls.append(time.perf_counter() - t0)
        waits.append(instats.take_step_wait() or 0.0)
    it.close()
    return float(np.mean(walls)), float(np.percentile(waits, 99)), float(np.mean(waits)), loss


def stream_result(ptt):
    """bench.py's result of _build_input_stream: prefetch 2 against 0."""
    from paddle_tpu_torch.io.streaming import stats as instats

    dt_on, p99_on, mean_on, loss_on = stream_measure(ptt, 2)
    verdict_on = instats.starvation_verdict()  # before the off-run's waits
    dt_off, p99_off, mean_off, loss_off = stream_measure(ptt, 0)
    step_delta, wait_delta = dt_off - dt_on, mean_off - mean_on
    per = lambda dt, p99, mean, loss: dict(
        ms_per_step=dt * 1e3, samples_per_sec=STREAM["global_batch"] / dt,
        p99_input_wait_ms=p99 * 1e3, mean_input_wait_ms=mean * 1e3, final_loss=loss)
    return dict(per(dt_on, p99_on, mean_on, loss_on), prefetch_depth=2,
                prefetch_off=per(dt_off, p99_off, mean_off, loss_off),
                wait_attribution=dict(step_delta_ms=step_delta * 1e3,
                                      wait_delta_ms=wait_delta * 1e3,
                                      explained_fraction=wait_delta / step_delta
                                      if step_delta > 0 else None),
                overlap_efficiency=max(0.0, min(1.0, 1.0 - mean_on / mean_off))
                if mean_off > 0 else None,
                verdict=verdict_on)


def stream_donation_run(ptt, dataset, donate, n):
    """n batches of a prefetch-2 loader into stream_step's step; the
    consumer keeps the previous batch across the next take and sleeps
    STREAM_CHECK_SLEEP_S a step, so the rings are full at each take. ->
    (the device bytes over the model's own after each take and after each
    sleep, the batches' bytes, whether each previous batch's storage was 0
    bytes after the next take)."""
    step = stream_step(ptt)
    warm = stream_loader(dataset, 0, False, "smoke_check")
    x, y = next(iter(warm))
    float(step(x, y).numpy())
    del x, y, warm
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    over, got, freed, prev = [], [], [], None
    it = iter(stream_loader(dataset, 2, donate, "smoke_check"))
    for _ in range(n):
        x, y = next(it)
        over.append(torch.cuda.memory_allocated() - base)
        if prev is not None:
            freed.append(all(t.untyped_storage().nbytes() == 0 for t in prev))
        got.append((x.cpu().numpy().tobytes(), y.cpu().numpy().tobytes()))
        float(step(x, y).numpy())
        time.sleep(STREAM_CHECK_SLEEP_S)
        over.append(torch.cuda.memory_allocated() - base)
        prev = (x, y)
    it.close()
    return over, got, freed


def input_stream(ptt, ta, state):
    """bench.py's _build_input_stream with the port (StreamingLoader
    prefetch depth 2 with donation against depth 0 over HeavyReader, a
    to_static MLP step on the card); then, over HeavyReader's samples held
    in memory: every streamed batch against its host batch, a mid-epoch
    resume (state_dict after 5 batches, restored into a new loader)
    against an unbroken run, and the donation bound on
    torch.cuda.memory_allocated with full rings, against the same run
    without donation."""
    from paddle_tpu_torch.io import _collate_np
    from paddle_tpu_torch.io.streaming import stats as instats

    instats.reset()
    ta.reset_launch_counts()  # the main path: every count 0 before it, read after it
    t0 = time.perf_counter()
    res = stream_result(ptt)
    bench_s = time.perf_counter() - t0
    launches = no_kernel_launched(ta, "input_stream")
    on, off = res["final_loss"], res["prefetch_off"]["final_loss"]
    if not (math.isfinite(on) and abs(on - off) <= STREAM_LOSS_RTOL * abs(off)):
        raise AssertionError(f"input_stream: final losses {on} and {off} differ")
    if res["verdict"].get("verdict") not in ("starved", "input_limited", "compute"):
        raise AssertionError(f"input_stream: no verdict: {res['verdict']}")

    depth, n_resume, n_total = 2, *STREAM_CHECK_BATCHES
    plan = stream_loader(HeavyReader(), depth, True, "smoke_check")._plan()
    held = HeldReader(np.concatenate([plan.global_batch(b)
                                      for b in range(STREAM_HELD_BATCHES)]))
    host = []
    for b in range(n_total):
        hx, hy = _collate_np([held[int(i)] for i in plan.global_batch(b)])
        host.append((hx.tobytes(), hy.tobytes()))
    over, got, freed = stream_donation_run(ptt, held, True, n_total)
    kept_over, _, _ = stream_donation_run(ptt, held, False, n_total)
    if got != host:
        raise AssertionError("input_stream: a streamed batch differs from its host batch")
    first = stream_loader(held, depth, True, "smoke_check")
    it = iter(first)
    head = [(x.cpu().numpy().tobytes(), y.cpu().numpy().tobytes())
            for x, y in (next(it) for _ in range(n_resume))]
    saved = first.state_dict()
    it.close()
    resumed = stream_loader(held, depth, True, "smoke_check")
    resumed.load_state_dict(saved)
    tail = []
    for x, y in resumed:
        tail.append((x.cpu().numpy().tobytes(), y.cpu().numpy().tobytes()))
        if len(tail) == n_total - n_resume:
            break
    if head + tail != got:
        raise AssertionError("input_stream: the resumed stream differs from the unbroken one")
    batch_bytes = STREAM["global_batch"] * (STREAM["features"] * 4 + 8)
    allowed = (depth + 2) * batch_bytes + 16 * 512  # + the step's scalars, 512-byte blocks
    donation = dict(depth=depth, batch_bytes=batch_bytes, allowed_bytes=allowed,
                    max_over_model_bytes=max(over), batches_held_max=max(over) / batch_bytes,
                    undonated_max_over_model_bytes=max(kept_over),
                    undonated_batches_held_max=max(kept_over) / batch_bytes,
                    previous_freed=sum(freed), takes=len(freed))
    if not all(freed):
        raise AssertionError(f"input_stream: a donated batch kept its storage: {donation}")
    if max(over) > allowed:
        raise AssertionError(f"input_stream: donation bound broken: {donation}")
    if max(kept_over) <= allowed:  # the rings did not fill: the bound was not tested
        raise AssertionError(f"input_stream: without donation the same run stays within the "
                             f"bound: {donation}")
    state["input_stream_launches"] = launches
    log("input_stream", sizes=STREAM, bench_s=bench_s,
        ms_per_step=res["ms_per_step"], samples_per_sec=res["samples_per_sec"],
        mean_input_wait_ms=res["mean_input_wait_ms"], p99_input_wait_ms=res["p99_input_wait_ms"],
        prefetch_off=res["prefetch_off"], wait_attribution=res["wait_attribution"],
        explained_fraction=res["wait_attribution"]["explained_fraction"],
        overlap_efficiency=res["overlap_efficiency"], verdict=res["verdict"],
        final_losses=[on, off],
        resume=dict(saved_cursor=saved["cursor"], batches=n_total, equal=True),
        batches_equal_host=n_total, donation=donation, launches=launches)


# MobileNets card against CPU (f32, TF32 off). A MobileNet at a small scale
# amplifies f32 rounding: on the CPU, the port's f32 run against its own
# f64 run (the same ReLU/ReLU6/hardswish/hardsigmoid decisions) puts logits
# 1e-6 to 3e-5 apart and some batch norm weight grads 2e-3 to 5e-3 (their
# sums cancel), over resnet_parity's limits. So each tensor of the card run
# is held to resnet_parity's limit or to VISION_NOISE_RATIO times the CPU
# run's own f32-vs-f64 distance of that tensor, whichever is larger (two
# independent roundings of equal size differ by sqrt(2)x); a grad that is 0
# but for rounding (the f64 norm under 1e-6 of all grads': a batch norm
# bias that feeds only another batch norm) within 1e-5 of all grads' norm.
VISION_PARITY = (("mobilenet_v1", dict(scale=0.25)), ("mobilenet_v2", dict(scale=0.35)),
                 ("mobilenet_v3_small", dict(scale=0.5)))
VISION_BATCH, VISION_HW = 4, 96  # the last stage's maps are 3x3
VISION_NOISE_RATIO, VISION_ZERO, VISION_ZERO_ABS = 2.0, 1e-6, 1e-5


def vision_parity_run(ptt, arch, kw, ref_state, dev, dtype, imgs, labels, decisions, force):
    """One train-mode forward and backward of arch(num_classes=10, **kw)
    from `ref_state` on `dev` in `dtype` (dropout off): logits, loss, grads
    (CPU f64) and the kink decisions' disagreements."""
    model = getattr(ptt.vision.models, arch)(num_classes=10, **kw)
    model.load_state_dict(ref_state)
    model.to(device=dev, dtype=dtype).train()
    for m in model.modules():
        if isinstance(m, ptt.nn.Dropout):
            m.training = False
    with kink_decisions(ptt, decisions, force) as seen:
        logits = model(imgs.to(dev, dtype))
        loss = ptt.nn.functional.cross_entropy(logits, labels.to(dev))
        loss.backward()
    return dict(logits=logits.detach().double().cpu(), loss=loss.item(),
                grads={n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
                seen=dict(seen))


def vision_parity(ptt):
    """MobileNetV1, V2 and V3-Small (small scales, B4 3x96x96), each built
    once from seed 5: the card's f32 run against the CPU's with the card's
    kink decisions, and the CPU's in f64 for the noise each tensor carries."""
    rng = np.random.RandomState(6)
    imgs = torch.from_numpy(rng.randn(VISION_BATCH, 3, VISION_HW, VISION_HW).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, (VISION_BATCH,)).astype(np.int64))
    tol = RESNET_F32_TOL
    rec = {}
    for arch, kw in VISION_PARITY:
        ptt.set_device("cpu")
        ptt.seed(5)
        ref_state = getattr(ptt.vision.models, arch)(num_classes=10, **kw).state_dict()
        ptt.set_device("cuda")
        decisions = []
        card = vision_parity_run(ptt, arch, kw, ref_state, "cuda", torch.float32, imgs, labels,
                                 decisions, False)
        ptt.set_device("cpu")
        cpu = vision_parity_run(ptt, arch, kw, ref_state, "cpu", torch.float32, imgs, labels,
                                decisions, True)
        f64 = vision_parity_run(ptt, arch, kw, ref_state, "cpu", torch.float64, imgs, labels,
                                decisions, True)
        ptt.set_device("cuda")
        noise = lambda a: _rel(a, f64["logits"])
        logit_err, logit_noise = _rel(card["logits"], cpu["logits"]), noise(cpu["logits"])
        loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        loss_noise = abs(cpu["loss"] - f64["loss"]) / abs(f64["loss"])
        scale = math.sqrt(sum(g.pow(2).sum().item() for g in cpu["grads"].values()))
        truth = math.sqrt(sum(g.pow(2).sum().item() for g in f64["grads"].values()))
        worst, worst_zero = (0.0, ""), 0.0
        for n, g in cpu["grads"].items():
            err = (card["grads"][n] - g).norm().item()
            if f64["grads"][n].norm().item() < VISION_ZERO * truth:
                worst_zero = max(worst_zero, err / scale)
            else:
                limit = max(tol["grad"], VISION_NOISE_RATIO * _rel(g, f64["grads"][n]))
                worst = max(worst, (err / g.norm().item() / limit, n))
        r = dict(logits_rel=logit_err, logits_cpu_f32_vs_f64=logit_noise, loss_rel=loss_err,
                 loss_cpu_f32_vs_f64=loss_noise,
                 worst_grad_over_limit=worst, worst_zero_grad_over_scale=worst_zero,
                 decision_calls=cpu["seen"]["calls"], decisions_disagree=cpu["seen"]["disagree"],
                 decisions_worst_over_rms=cpu["seen"]["worst_over_rms"])
        rec[arch] = r
        ok = (logit_err <= max(tol["loss"], VISION_NOISE_RATIO * logit_noise)
              and loss_err <= max(tol["loss"], VISION_NOISE_RATIO * loss_noise)
              and worst[0] <= 1.0 and worst_zero <= VISION_ZERO_ABS
              and cpu["seen"]["worst_over_rms"] <= DECISION_TIE)
        if not ok:
            raise AssertionError(f"vision_parity: {arch} card and CPU runs disagree: {r}")
    log("vision_parity", batch=VISION_BATCH, image=[3, VISION_HW, VISION_HW],
        models={b: kw for b, kw in VISION_PARITY}, tol=dict(
            tol, noise_ratio=VISION_NOISE_RATIO, zero=VISION_ZERO, zero_abs=VISION_ZERO_ABS,
            decision_tie=DECISION_TIE), **rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,serve_bf16,serve_int8,telemetry_ab,"
                                        "fleet_parity,fleet_bf16,qos_bf16,predictor_f32,"
                                        "train_parity,train_bf16,train_recompute,"
                                        "train_fp16_scaler,train_o2_resume,amp_parity,"
                                        "rms_norm_entry,ernie_parity,ernie_seq128,ernie_seq4096,"
                                        "static_llama_capture,static_parity,static_ernie_train,"
                                        "deploy_ernie,deploy_llama_static,deploy_parity,"
                                        "static_nn_parity,static_resnet50_train,"
                                        "resnet_parity,resnet50_train,ocr_parity,ppocr_e2e,"
                                        "ocr_train,ppyoloe,op_surface,ernie_cls_parity,"
                                        "ernie_finetune,nn_surface,transformer_parity,"
                                        "transformer_base,guarded_train_bf16,cold_start,"
                                        "vision_parity,input_stream,mobilenetv3_fit",
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--cold-start-child", metavar="OUT", default=None,
                    help=argparse.SUPPRESS)  # one cold_start process (cold_start runs it)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    if args.cold_start_child:
        return cold_start_child(args.cold_start_child)
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import attention as ta
    from paddle_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    log("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32 (the default)
    torch.backends.cudnn.allow_tf32 = False  # f32 convs too (torch's default is TF32)
    ptt.set_device("cuda")

    t0 = time.perf_counter()
    logs = build.build(force=True)
    log("build", seconds=time.perf_counter() - t0,
        ptxas={k: ptxas_summary(v) for k, v in logs.items()})

    state: dict = {"smi": smi}
    records = {}
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        bf = torch.bfloat16
        timed = [check_flash(ta, gen, f"bf16 causal B1 S{s} H32/8 D128{note}", 1, s, s, 32, 8, 128,
                             bf, True, timed=True)
                 for s, note in ((1024, " (serve prefill)"), (2048, ""), (4096, " (train)"))]
        fwd_keys = ("case", "variant", "ms", "graph_ms", "plain_ms", "library_ms",
                    "library_graph_ms", "bound_ms", "max_abs_err")
        records["flash_fwd"] = dict(timed[0], by_shape=[{k: r[k] for k in fwd_keys} for r in timed])
        check_flash(ta, gen, "bf16 causal B2 Sq300 Sk777 H32/8 D128 (ragged tiles)", 2, 300, 777,
                    32, 8, 128, bf, True)
        check_flash(ta, gen, "bf16 causal B2 S2048 H32/8 D128", 2, 2048, 2048, 32, 8, 128, bf, True)
        check_flash(ta, gen, "bf16 dropout p=0.1 seed 1234 S256 H8/2 D128 causal", 1, 256, 256, 8, 2,
                    128, bf, True, dropout_p=0.1)
        for causal in (True, False):
            check_flash(ta, gen, f"bf16 {'causal' if causal else 'non-causal'} B2 S512 H12/12 D64 "
                        "(ERNIE heads)", 2, 512, 512, 12, 12, 64, bf, causal, timed=causal)
        ernie = [check_flash(ta, gen, "bf16 non-causal B64 S128 H12 D64 (ERNIE seq128)", 64, 128,
                             128, 12, 12, 64, bf, False, timed=True),
                 check_flash(ta, gen, "bf16 non-causal B3 S4096 H6 D128 dropout p=0.1 (ERNIE "
                             "seq4096)", 3, 4096, 4096, 6, 6, 128, bf, False, dropout_p=0.1,
                             timed=True),
                 # the same without dropout: what the in-kernel dropout costs
                 check_flash(ta, gen, "bf16 non-causal B3 S4096 H6 D128 (ERNIE seq4096, no "
                             "dropout)", 3, 4096, 4096, 6, 6, 128, bf, False, timed=True)]
        if any(r["variant"] != "wgmma" for r in ernie):
            raise AssertionError("the ERNIE shapes' flash forward did not run the wgmma variant")
        records["flash_fwd"]["by_shape"] += [{k: r[k] for k in fwd_keys} for r in ernie]
        check_flash(ta, gen, "bf16 causal S256 H8/2 D96 (a head dim of the CUDA-core variant only)",
                    1, 256, 256, 8, 2, 96, bf, True)
        check_flash(ta, gen, "f32 S40 H4/4 D64 non-causal", 2, 40, 40, 4, 4, 64, torch.float32, False)
        check_flash(ta, gen, "f32 dropout p=0.1 seed 1234 S256 H8/2 D128 causal", 1, 256, 256, 8, 2,
                    128, torch.float32, True, dropout_p=0.1)
        records["paged_attn"] = paged_checks(ta, gen)
        records["flash_bwd_dq"], records["flash_bwd_dkdv"] = check_flash_bwd(
            ta, gen, "bf16 causal B1 S4096 H32/8 D128 (train)", 1, 4096, 4096, 32, 8, 128,
            torch.bfloat16, True, timed=True)
        bwd_cases = [("bf16 causal B1 S4096 H32/8 D128 (train)",
                      (records["flash_bwd_dq"], records["flash_bwd_dkdv"]))]
        bwd_cases += [(case, check_flash_bwd(ta, gen, case, *shape, bf, False, dropout_p=p,
                                             timed=True))
                      for case, shape, p in (
                          ("bf16 non-causal B64 S128 H12 D64 (ERNIE seq128)",
                           (64, 128, 128, 12, 12, 64), 0.0),
                          ("bf16 non-causal B3 S4096 H6 D128 dropout p=0.1 (ERNIE seq4096)",
                           (3, 4096, 4096, 6, 6, 128), 0.1),
                          ("bf16 non-causal B3 S4096 H6 D128 (ERNIE seq4096, no dropout)",
                           (3, 4096, 4096, 6, 6, 128), 0.0))]
        for i, kname in enumerate(("flash_bwd_dq", "flash_bwd_dkdv")):
            if any(recs[i]["variant"] != "wgmma" for _, recs in bwd_cases):
                raise AssertionError(f"an ERNIE shape's {kname} did not run the wgmma variant")
            records[kname] = dict(records[kname], by_shape=[
                dict(case=case, **{k: recs[i][k] for k in ("variant", "ms", "graph_ms", "plain_ms",
                                                          "library_ms", "bound_ms",
                                                          "max_abs_err")})
                for case, recs in bwd_cases])
        check_flash_bwd(ta, gen, "bf16 causal B1 Sq300 Sk777 H32/8 D128 (ragged tiles)", 1, 300,
                        777, 32, 8, 128, bf, True)
        check_flash_bwd(ta, gen, "bf16 causal B1 Sq301 Sk777 H32/8 D128 (Sq % 4 != 0)", 1, 301,
                        777, 32, 8, 128, bf, True)
        check_flash_bwd(ta, gen, "bf16 causal B2 S2048 H32/8 D128", 2, 2048, 2048, 32, 8, 128, bf,
                        True)
        check_flash_bwd(ta, gen, "bf16 dropout p=0.1 S256 H8/2 D128 causal", 1, 256, 256, 8, 2, 128,
                        bf, True, dropout_p=0.1)
        check_flash_bwd(ta, gen, "bf16 causal S256 H8/2 D128, loss on out and lse", 1, 256, 256, 8, 2,
                        128, bf, True, use_lse=True)
        for causal in (True, False):
            check_flash_bwd(ta, gen, f"bf16 {'causal' if causal else 'non-causal'} B2 S512 H12/12 "
                            "D64 (ERNIE heads)", 2, 512, 512, 12, 12, 64, bf, causal, timed=causal)
        check_flash_bwd(ta, gen, "bf16 dropout p=0.1 B1 S333 H4/4 D64 causal", 1, 333, 333, 4, 4, 64,
                        bf, True, dropout_p=0.1)
        check_flash_bwd(ta, gen, "bf16 causal S256 H8/2 D96 (a head dim of the CUDA-core variant "
                        "only)", 1, 256, 256, 8, 2, 96, bf, True)
        check_flash_bwd(ta, gen, "f32 dropout p=0.1 S256 H8/2 D128 causal", 1, 256, 256, 8, 2, 128,
                        torch.float32, True, dropout_p=0.1)
        check_flash_bwd(ta, gen, "f32 S40 H4/4 D64 non-causal", 2, 40, 40, 4, 4, 64, torch.float32,
                        False)
        check_flash_bwd(ta, gen, "f32 causal S128 H4/2 D64, loss on out and lse", 1, 128, 128, 4, 2,
                        64, torch.float32, True, use_lse=True)
        records.update({k + "[float16]": r for k, r in fp16_flash_checks(ta, gen).items()})
        torch.cuda.empty_cache()
        from paddle_tpu_torch.incubate.nn import functional as IF
        from paddle_tpu_torch.ops import fused_optimizer as fo

        check_fused_adamw(fo, gen)
        n_train = train_bucket_elems(dict(LLAMA3_8B, num_hidden_layers=TRAIN_LAYERS))
        records["fused_adamw"] = check_adamw_bucket(
            fo, gen, f"bf16 m2, AdamW wd 0.01, the {TRAIN_LAYERS}-layer training bucket", n_train,
            timed=True)
        torch.cuda.empty_cache()
        # the ERNIE buckets of ernie_seq128 (max positions 512) and
        # ernie_seq4096 (max positions 4096)
        ernie_b5 = [check_adamw_bucket(fo, gen, f"bf16 m2, AdamW wd 0.01, the ERNIE-3.0-base MLM "
                                       f"bucket at max positions {max_pos}",
                                       ernie_bucket_elems(ERNIE_BASE, max_pos), timed=True)
                    for max_pos in (512, 4096)]
        torch.cuda.empty_cache()
        # train_o2_resume's bucket: 1 layer at the Llama-3-8B width, bf16 P (amp.decorate O2)
        o2_b5 = check_adamw_bucket(fo, gen, "bf16 P (O2), bf16 m2, AdamW wd 0.01, the 1-layer O2 "
                                   "bucket", train_bucket_elems(dict(LLAMA3_8B, num_hidden_layers=1)),
                                   timed=True, p_dtype=torch.bfloat16)
        records["fused_adamw"]["by_shape"] = [
            {k: r[k] for k in ("case", "n", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
            for r in (records["fused_adamw"], *ernie_b5, o2_b5)]
        torch.cuda.empty_cache()
        n_large = train_bucket_elems(dict(LLAMA3_8B, num_hidden_layers=LARGE_BUCKET_LAYERS))
        check_adamw_bucket(fo, gen, f"bf16 m2, AdamW wd 0.01, a {LARGE_BUCKET_LAYERS}-layer bucket "
                           "(past 2^31 elements): the slices across 2^31 and the last",
                           n_large, starts=[2 ** 31 - ADAMW_SLICE // 2, 2 ** 31 + ADAMW_SLICE // 2,
                                            fo.pad_to_tile(n_large) - ADAMW_SLICE])
        torch.cuda.empty_cache()
        rms = [check_rms_norm(IF, gen, "bf16 R4096 D4096, f32 weight (the entry point's types)",
                              4096, 4096, torch.bfloat16, False, w_dtype=torch.float32, timed=True),
               check_rms_norm(IF, gen, "bf16 R4096 D4096", 4096, 4096, torch.bfloat16, False,
                              timed=True)]
        records["rms_norm"] = dict(rms[0], by_shape=[
            {k: r[k] for k in ("case", "ms", "eager_ms", "plain_ms", "library_ms",
                               "library_eager_ms", "bound_ms", "max_abs_err")} for r in rms])
        check_rms_norm(IF, gen, "bf16 R4096 D4096 bias", 4096, 4096, torch.bfloat16, True, timed=True)
        check_rms_norm(IF, gen, "f32 R4096 D4096", 4096, 4096, torch.float32, False)
        check_rms_norm(IF, gen, "bf16 R333 D1032 (ragged R)", 333, 1032, torch.bfloat16, True)
        check_rms_norm(IF, gen, "bf16 R64 D16392 bias (wide rows)", 64, 16392, torch.bfloat16,
                       True)
        torch.cuda.empty_cache()
    if "serve_bf16" in phases or "static_llama_capture" in phases:
        model = serve_bf16(ptt, ta, state) if "serve_bf16" in phases else llama_8b(ptt)
    if "serve_bf16" in phases:
        if "serve_int8" in phases:
            serve_int8(ta, model, state)
        if "telemetry_ab" in phases:
            telemetry_ab(ptt, model)
        if "fleet_parity" in phases:
            fleet_parity(ptt, ta, state)
        if "fleet_bf16" in phases:
            fleet_bf16(ptt, ta, model, state)
        if "qos_bf16" in phases:
            qos_bf16(ptt, ta, model, state)
            qos_predictor(ptt)
    if "static_llama_capture" in phases:
        static_llama_capture(ptt, ta, model, state)
    if "serve_bf16" in phases or "static_llama_capture" in phases:
        del model
        torch.cuda.empty_cache()
    if "predictor_f32" in phases:
        predictor_f32(ptt)
    if "train_parity" in phases:
        for cfg in (TINY_LLAMA, TINY_LLAMA_D64):
            train_parity(ptt, ta, cfg)
    if "train_bf16" in phases:
        train_bf16(ptt, ta, state)
    if "guarded_train_bf16" in phases:  # train_bf16 under the guardian and the profiler
        guarded_train_bf16(ptt, ta, state)
    if "train_recompute" in phases:  # bench.py:461-467's recompute and micro-batch rungs
        train_recompute(ptt, ta, state)
    if "train_fp16_scaler" in phases:
        train_fp16_scaler(ptt, ta, state)
    if "train_o2_resume" in phases:
        train_o2_resume(ptt, ta, state)
    if "amp_parity" in phases:
        amp_parity(ptt, ta)
    if "rms_norm_entry" in phases:
        from paddle_tpu_torch.incubate.nn import functional as IF

        rms_norm_entry(ta, IF, state)
    if "ernie_parity" in phases:
        ernie_parity(ptt, ta)
    if "ernie_seq128" in phases:  # bench.py:2302, the headline
        ernie_train(ptt, ta, state, "ernie_seq128", (64,), 128, 12, 512, 0.0)
    if "ernie_seq4096" in phases:  # bench.py:2151-2159
        ernie_train(ptt, ta, state, "ernie_seq4096", (3, 2), 4096, 6, 4096, 0.1)
    if "static_parity" in phases:
        static_parity(ptt, ta)
    if "static_ernie_train" in phases:  # ernie_seq128 as a static Program
        static_ernie_train(ptt, ta, state)
    if "deploy_ernie" in phases:  # BASELINE configs[1] deployed: jit.save -> Predictor
        deploy_ernie(ptt, ta, state)
    if "deploy_llama_static" in phases:
        deploy_llama_static(ptt, ta, state)
    if "deploy_parity" in phases:
        deploy_parity(ptt, ta, state)
    if "static_nn_parity" in phases:
        static_nn_parity(ptt, ta)
    if "static_resnet50_train" in phases:  # resnet50_train as PaddleClas's static Program
        static_resnet50_train(ptt, ta, state)
    if "resnet_parity" in phases:
        resnet_parity(ptt)
    if "resnet50_train" in phases:  # bench.py:1974-2006
        resnet50_train(ptt, ta, state)
    if "ocr_parity" in phases:
        ocr_parity(ptt)
    if "ppocr_e2e" in phases:  # bench.py:2041-2093, BASELINE configs[2]
        ppocr_e2e(ptt, ta, state)
    if "ocr_train" in phases:
        ocr_train(ptt, ta, state)
    if "ppyoloe" in phases:  # BASELINE configs[3] on one card
        ppyoloe(ptt, ta, state)
    if "op_surface" in phases:
        op_surface(ptt)
    if "ernie_cls_parity" in phases:
        ernie_cls_parity(ptt, ta)
    if "ernie_finetune" in phases:  # BASELINE configs[1]
        ernie_finetune(ptt, ta, state)
    if "nn_surface" in phases:
        nn_surface(ptt)
    if "transformer_parity" in phases:
        transformer_parity(ptt, ta)
    if "transformer_base" in phases:  # Vaswani et al. 2017 base, PaddleNLP's recipe
        transformer_base(ptt, ta, state)
    if "cold_start" in phases:  # serve_bf16's engine load through the compile cache
        cold_start(ptt, ta, state)
    if "vision_parity" in phases:
        vision_parity(ptt)
    if "input_stream" in phases:  # bench.py:1560-1688, the streaming data tier
        input_stream(ptt, ta, state)
    if "mobilenetv3_fit" in phases:  # PaddleClas's MobileNetV3-Large through hapi.Model.fit
        mobilenetv3_fit(ptt, ta, state)
    for kname, rows in state.get("transformer_by_shape", {}).items():
        rec = records.setdefault(kname, {})
        rec["by_shape"] = rec.get("by_shape", []) + rows

    k = "paddle_tpu_torch/ops/kernels/"
    sources = {
        "flash_fwd": (k + "flash_fwd.cu", "paddle_tpu/ops/pallas.py:427"),
        "paged_attn": (k + "paged_attn.cu", "paddle_tpu/ops/pallas.py:961"),
        "flash_bwd_dq": (k + "flash_bwd.cu", "paddle_tpu/ops/pallas.py:609 (pallas_call :649)"),
        "flash_bwd_dkdv": (k + "flash_bwd.cu", "paddle_tpu/ops/pallas.py:609 (pallas_call :687)"),
        "fused_adamw": (k + "fused_adamw.cu", "paddle_tpu/ops/fused_optimizer.py:140"),
        "rms_norm": (k + "rms_norm.cu", "paddle_tpu/incubate/nn/functional/__init__.py:67"),
    }
    by_path = {"serve_bf16": state.get("launches", {}),
               "fleet_parity": state.get("fleet_parity_launches", {}),
               "fleet_bf16": state.get("fleet_launches", {}), "qos_bf16": state.get("qos_launches", {}),
               "train_bf16": state.get("train_launches", {}),
               "train_recompute": state.get("recompute_launches", {}),
               # its flash launches are the float16 rows' (below)
               "train_fp16_scaler": {k: v for k, v in state.get("fp16_launches", {}).items()
                                     if k == "fused_adamw"},
               "train_o2_resume": state.get("o2_launches", {}),
               "fused_rms_norm": state.get("rms_norm_launches", {}),
               **state.get("ernie_launches", {}), "resnet50_train": state.get("resnet_launches", {}),
               "ppocr_e2e": state.get("ppocr_launches", {}),
               "ocr_train": state.get("ocr_train_launches", {}),
               "ppyoloe": state.get("ppyoloe_launches", {}),
               "transformer_base": state.get("transformer_launches", {}),
               "static_llama_capture": state.get("static_llama_launches", {}),
               "static_ernie_train": state.get("static_ernie_launches", {}),
               "deploy_ernie": state.get("deploy_ernie_launches", {}),
               "deploy_llama_static": state.get("deploy_llama_launches", {}),
               "deploy_parity": state.get("deploy_parity_launches", {}),
               "static_resnet50_train": state.get("static_resnet_launches", {}),
               "guarded_train_bf16": state.get("guarded_launches", {}),
               "static_ernie_train_checked": state.get("static_ernie_checked_launches", {}),
               "cold_start": state.get("cold_start_launches", {}),
               "input_stream": state.get("input_stream_launches", {}),
               "mobilenetv3_fit": state.get("mobilenetv3_launches", {})}
    # the float16 variants of B1-B3: their own rows, launched on train_fp16_scaler's path
    fp16_counts = {}
    for key, n in state.get("fp16_variants", {}).items():
        kname, dtype, _ = key.split()
        if dtype == "float16":
            fp16_counts[kname + "[float16]"] = fp16_counts.get(kname + "[float16]", 0) + n
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        sources[kname + "[float16]"] = sources[kname]
    kernels = []
    for name, (src, replaces) in sources.items():
        rec = records.get(name, {})
        if name.endswith("[float16]"):
            counts = ({"train_fp16_scaler": fp16_counts[name]} if name in fp16_counts else {})
        else:
            counts = {path: c[name] for path, c in by_path.items() if name in c}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(counts.values()) if counts else None, launches_by_path=counts,
            max_abs_err=rec.get("max_abs_err"), ms=rec.get("ms"), plain_ms=rec.get("plain_ms"),
            bound_ms=rec.get("bound_ms"), bound_by=rec.get("bound_by"),
            library_ms=rec.get("library_ms"), variant=rec.get("variant", "cuda_core"),
            **({"by_shape": rec["by_shape"]} if "by_shape" in rec else {})))
    log("phase_seconds", **phase_seconds())
    print(f"device: {smi}", flush=True)  # again beside the numbers, for a reader of the tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
