"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the five CUDA kernels (and the empty launch-floor kernel) from
   `src/repro_torch/csrc/`, one nvcc each, in parallel, and prints the
   seconds, ptxas's register and spill lines of every instance, and the
   HMMA/HGMMA/IMMA (tensor-core) instructions in each kernel's SASS;
3. times the launch floor (an empty 256-thread block), then holds each
   kernel against its plain PyTorch version on the card, at the shapes of
   BERT-base 8x128 encoding and of 8-slot decode, with its tolerance, its
   time, its bound and, where one PyTorch call computes the same function,
   that call's time (`torch._int_mm` on decode rows zero-padded to 32;
   `scaled_dot_product_attention` beside the exact-exp flash rows);
   `pwl_eval` and `nvu_softmax` also bit for bit against their walks in
   torch ops (`pwl_eval` in its vector and scalar (unaligned) instance,
   `nvu_softmax` f32 and, with the encoder's scale 0.125, bf16 out);
   flash's blocked mode and its dense mode (the decode path's attention:
   decode steps over 256, 1024, 2048 and 16384 keys, a 128-token prefill,
   and GLM4-9B's (8, 32 over 2, 1, 128) step and (1, 32 over 2, 128, 128)
   prefill); at GLM4-9B's other shapes RMSNorm (8, 4096) and (1024, 4096),
   `pwl_eval` SiLU (8, 13696) and every other table at (8, 3072), bit for
   bit against the walk, and `quant_matmul` at a step's q/o, k/v, gate/up,
   down and head products and at the longest prompt's (120 rows) gate/up,
   down and head products; the dense mode's window, causal switch and soft
   cap at Gemma3-27B's shapes (a step over a 1024-row ring with every row
   valid and with 300, a 2048-token prefill with window 1024, a step
   soft-capped at 50) and StarCoder2-3B's (a 12:1 step over a 4096-row
   ring), Hymba-1.5B's (a 5:1 step over a 32-row ring) and Whisper-base's
   (a cross step over 1500 rows with causality off, the causal encoder over
   1500 frames), PWL and exact,
   `scaled_dot_product_attention` with the same mask beside the exact rows
   without a cap; `quant_matmul` at RWKV6-3B's, Hymba's (x_proj's N = 132
   too) and Whisper's products, the layernorm kernel and the new PWL tables
   (the decay, Mamba's exp, the group norm's rsqrt) at their shapes; beside
   `pwl_eval`, `nvu_softmax` and `nvu_layernorm` a yardstick of the same
   bytes with exact math, not the same function (`F.gelu`,
   `torch.softmax`, `F.layer_norm`), and beside `nvu_softmax` a copy of its
   bytes; the encoder rows of those three and flash's decode rows once
   more with the L2 flushed before each launch; and the training path's
   backward passes at BERT-base 8 x 128 against their plain backward
   passes: `pwl_eval`'s derivative mode (the GELU's, (1024, 3072) bf16, bit
   for bit), `nvu_softmax`'s backward kernel ((12288, 128), scale 0.125, dy
   bf16) and `nvu_layernorm`'s ((1024, 768) bf16, dx, dgamma and dbeta),
   within 2e-5 of their result's largest value, and the first and last at
   the decoders' shapes too (`PWL_GRAD_ROWS`: StarCoder2-3B's GELU (4096,
   12288), Granite's expert SiLU (40960, 512); `LN_GRAD_ROWS`: StarCoder2's
   LayerNorm (4096, 3072), Granite's RMSNorm (4096, 1024)), each beside
   torch's own backward of F.gelu, F.silu, torch.softmax and F.layer_norm
   (the same bytes, not the same function), and the MMU's scale path (one more `quant_matmul` launch
   with unit scales for the int32 product, then torch reductions) at every
   product of a layer and the head, beside `torch._int_mm`; and the
   backward of flash attention's dense mode (`dense_attention_grad`, bf16,
   from the row statistics of the forward kernel on the same operands) at
   the decoders' training shapes (StarCoder2 (4, 24 over 2, 1024, 128)
   causal, PWL and exact; Granite (4, 16 over 8, 1024, 64); GLM4 (1, 32
   over 2, 1024, 128); Gemma3 (1, 32 over 16, 2048, 128) with window 1024,
   with and without a soft cap of 50; Whisper's cross (8, 8, 448 over 1500,
   64)), each held to its plain backward by `attn_grad_check` (the gate of
   `flash_attention.dense_attention_grad_gates`) beside PyTorch's SDPA
   backward (exact softmax, `enable_gqa`, the same mask; none with a cap),
   and the training forward at StarCoder2's and Granite's shapes with its
   row statistics; each dense-mode row's bound the larger of its
   tensor-core products and its pairs' CUDA-core chain
   (`dense_chain_instr`), and its time before the redesign printed beside
   (`PREVIOUS_MS`);
4. serves the encoder: full-width BERT-base (L=12, D=768, V=30720, bf16)
   through `BertServer`, 8 requests x 128 tokens a batch, in float, NPE-8
   and NPE-16; counts the kernel launches of one NPE-8 forward (checked: 73
   quant_matmul, 25 nvu_layernorm, 12 nvu_softmax, 12 pwl_eval); holds every
   launch of one NPE-8 forward to its plain version on its own operands;
   checks that the NPE-8 logits are bit for bit those of the scale and the
   cast as torch ops around the softmax, and prints the launches that
   folding them saves; profiles one NPE-8 forward; and holds the kernel
   route at full width (2 layers, float32) against the port's plain route
   on the CPU;
5. serves KV-cache decode: full-width BERT-base through `launch.serve.Server`,
   8 slots, prompts of up to 128 tokens, 64 greedy tokens, a 256-row cache,
   in float, NPE-8 and NPE-16; counts the launches of one decode step and of
   one one-slot prefill in each mode (checked exactly); holds every launch of
   one NPE-8 step to its plain version; profiles one NPE-8 step; prints the
   top-1 agreement of each mode with float, all fed the float route's
   tokens, through the dense mode and, as it was before it, the blocked
   flash route; and holds the kernel route (float32, 2 layers, full width,
   prefill plus 4 steps; prompts of up to 128 tokens over 256 rows, and of
   1100 and 300 tokens over 1152) against the port's plain route on the CPU;
6. runs the npec compiler and functional executor (`repro_torch.npec`) at
   full width and depth, BERT-base in float32 from [4]'s seed: (a) the
   executor's kernel options, held and timed in [3] with the other rows:
   the MMU with one activation scale a row ((8, 768) @ (768, 768) and
   @ (768, 64)) bit for bit to its plain version and, with equal scales, to
   the per-tensor call, and `nvu_softmax` with a key limit ((96, 256) a
   decode step's 12 heads x 8 slots, (12288, 128) causal by limit) bit for
   bit to its walk; (b) executes the compiled
   8 x 128 encoder stream in float, NPE-8 and NPE-16 against the port's
   models/bert (float at 12 layers and NPE at 2 layers within 1e-2, NPE at
   12 layers within twice the model's change under 1-ulp weights), counts
   the launches of one NPE-8 execute against the graph's, and prints host
   ms and the stream's overlay instructions and model cycles; (c) prefills
   [5]'s 8 prompts through `compile_prefill`, loads them into the 8-slot
   `compile_decode(256, batch=8)` stream and runs 4 steps in each mode
   (float greedy, the others fed its tokens), held against 8 per-sequence
   streams on the same tokens (NPE-8 bit for bit, else the reason and
   5e-3; float and NPE-16 within twice the stream's change under 1-ulp
   weights), with top-1 agreement, host ms a step and the launches of the
   NPE-8 run against the graphs';
7. serves from compiled streams through `NPEEngine` (`repro_torch.npec.runtime`)
   at full width and depth, [6]'s weights: (a) the NPE-8 engine (8 slots,
   capacity 64, 8 tokens) on 12 EOS-aware requests, so slots are recycled:
   its launches by kind checked exactly against the prefill and decode
   graphs it ran, each request's tokens bit for bit those of its own
   per-request streams (`compile_prefill` loaded into a batch=1
   `compile_decode(64)`), host ms per engine step and one step's device
   busy and idle share (torch.profiler), and the report's p50/p99 and
   tokens/s, which are the FPGA overlay model's at 200 MHz, not card time;
   (b) the float engine with `prefill_chunk=16` against whole-prompt
   prefill: the same tokens, or a difference at a top-2 logit margin below
   twice [6](c)'s float change under 1-ulp weights; (c) the cost-only engine
   and fleet rebuild the bert rows of `results/npec_serve_cycles.json`
   (kind "engine") and `results/npec_tensor_cycles.json` exactly;
8. serves full-width, 40-layer GLM4-9B (bf16, 9.40 B parameters drawn from a
   torch generator) through `launch.serve.Server`: 8 slots, [5]'s prompts,
   16 greedy tokens, a 256-row cache, in float, NPE-8 and NPE-16, printing
   prefill ms per slot, decode ms per step and tokens/s; checks the launches
   of one step and of one one-slot prefill exactly (NPE-8 281 quant_matmul,
   81 nvu_layernorm, 40 pwl_eval, 40 flash_attention, 0 nvu_softmax);
   holds every launch of one NPE-8 step and of the 8 one-slot NPE-8
   prefills (33 to 120 rows) to its plain version; profiles one
   NPE-8 step and counts the device launches of one step in each mode;
   prints teacher-forced top-1 agreement with float (not
   gated); and holds the kernel route (float32, 2 layers, full width,
   prefill plus 2 steps, float and NPE-8) against the port's plain route
   on the CPU;
9. serves full-width Gemma3-27B cut to 6 of its 62 layers (one whole
   local:global period: 5 local layers over 1024-row rings, 1 global;
   bf16, about 3.9 B parameters) through `launch.serve.Server`:
   8 slots, prompts of 7 to 16 tokens prefilled one token a call, 8 greedy
   tokens, in float and NPE-8, NPE-16 for one step and one prefill; checks
   the launches of a step, a prefill and the served run exactly (NPE-8 85
   quant_matmul, 49 nvu_layernorm, 12 pwl_eval, 12 flash_attention a
   step); holds every launch of one NPE-8 step to its plain version;
   profiles one; runs one slot in float to position 1040, past the ring's
   wrap, through the first 6 layers (one local:global period), and holds
   that step's launches to their plain versions and to the count before
   the wrap; and holds the kernel route (2 layers, one
   local and one global, window 16, float32, float) against the CPU;
10. serves full-width, 24-layer Granite-3.0-1B-A400M (32 experts, top-8)
   through `Server`: [5]'s prompts in one prefill each, 16 tokens, in
   float, NPE-8 and NPE-16; launches checked exactly (NPE-8 97 quant_matmul,
   49 nvu_layernorm, 24 pwl_eval, 24 nvu_softmax, 24 flash_attention); every
   launch of one NPE-8 step and of the 8 NPE-8 prefills held to its plain
   version, with the token-slots capacity dropped in each prefill; one step
   profiled; teacher-forced agreement with float (not gated); the route
   check at 2 layers in every mode;
11. runs the npec compiler and executor for the dense and MoE families on
   the card: (a) GLM4-9B at full width, 4 of its 40 layers (float32 weights from
   [8]'s seed through `param_tree_from_model`): [5]'s 8 prompts through one
   compiled 16-row chunked prefill slice over 256-row banks, loaded into
   the 8-slot `compile_decode(256, batch=8)` stream, 8 steps, float and
   NPE-8 (fed float's tokens): compile seconds, host ms a slice and a step,
   the NPE-8 run's launches against the graphs', every kernel call of one
   NPE-8 step held to its plain version, one step profiled, NPE-8's top-1
   agreement with float; (b) the executor against the port's
   models/transformer on the card (its plain attention, float32) on the
   same weights at 2 layers: 2 slots, prefill and 4 steps, float and NPE-8, logits within the
   gate and the same greedy tokens; (c) Granite-3.0-1B-A400M at full width
   and depth, float32: `compile_model` prefill streams at S = 64 and 120,
   float and NPE-8, against models/transformer.apply on the card (given
   the executor's expert ids, `models/moe.ForcedRouting`), every layer's routing
   on the card (ids, gates, dispatch bit for bit against models/moe.route,
   capacity `moe_capacity`, dropped token-slots reported), the launches of
   an NPE-8 execute against the graph's and each of its kernel calls held
   to its plain version;
12-14. serve the last families at full width through `Server`
   (`family_phase`; bf16, random weights from a torch generator): [12]
   RWKV6-3B at 8 of its 32 layers (`FAMILY_LAYERS`), [13]
   Hymba-1.5B at 16 of 32 (15 local over rings of min(1024, 32) rows and 1
   global, an SSM head in each), [14] Whisper-base (6 + 6 layers; first, in
   each mode, the encoder and cross K/V over 8 seeded frame batches of
   (1500, 512), its launches checked, host and busy ms printed, its NPE-8
   launches audited): 8 slots, prompts of 7 to 16 tokens one a call, 16
   greedy tokens, a 32-row cache, in float and NPE-8, NPE-16 for one step
   and one prefill; the launches of a step, a prefill and the served run
   checked exactly (`family_launches`; NPE-8 at 32 layers 257/66/192/0/0
   and 321/129/160/0/32, Whisper 49/19/6/0/12 for quant_matmul/
   nvu_layernorm/pwl_eval/nvu_softmax/flash_attention); every launch of one NPE-8 step audited; one step
   profiled; NPE-8's teacher-forced agreement with float and the NPE-8
   and NPE-16 logits' correlation with float (RWKV6, Hymba), reported; the
   route check (float32, 2 layers, float and NPE-8, prompts of 4 and 2
   tokens; a differing top-1 passes at a top-2 margin within twice the
   max-abs difference); Whisper's cross cache on the card against the CPU;
15. trains full-width, 12-layer BERT-base (float32 masters, bf16 compute,
   remat "block", AdamW as SGD without weight decay, `TRAIN_OPT`) through
   `launch.train.Trainer` on SyntheticLM(30720, 128, 8): float for 50
   steps with a crash injected at step 3 and recovered from the checkpoint
   of step 0 (once, checked), its mean loss of the last 5 steps below that
   of the first 5 and below the first step's (gated); NPE-16 (bf16 moments)
   and NPE-8 for 2 steps each, finite losses; in each mode host ms and
   device-busy ms a step (torch.profiler), idle share, tokens/s, peak
   memory; in NPE-16 the checkpoint's save and restore seconds with the
   restored tensors (float32 and bf16) bit for bit those saved; the
   launches of one NPE-8 train step by kernel, forward (each layer's twice,
   remat) and backward, checked exactly (218 quant_matmul, 49
   nvu_layernorm, 24 nvu_softmax and pwl_eval, 12 pwl_eval_grad and
   nvu_softmax_grad, 25 nvu_layernorm_grad), every launch held to its plain
   version (`Audit`, `GradAudit`); and the route check: one train step on
   the card's kernel route against the port's plain route on the CPU (full
   width, 2 layers, 512 positions, float32, 2 x 128 tokens, float, NPE-16
   and NPE-8): the loss, every gradient, the updated parameters and both
   moments within twice the plain route's change under 1-ulp weights, in
   the NPE modes at least 5e-3 of each leaf's largest value, a parameter
   within what AdamW's first step makes of its gradient's gate
   (`train_route_compare`; the worst share of the 1-ulp gate alone is
   printed too), and in NPE-8 the same nonzero gradient entries;
16. trains the decoders at full width and depth through `launch.train.
   Trainer` (float32 masters and moments, bf16 compute, remat "block",
   no checkpoints: [15] covers them): (a) StarCoder2-3B (30 layers, 3.18 B
   parameters) on SyntheticLM(49152, 1024, 4), (b) Granite-3.0-1B-A400M
   (24 MoE layers) on SyntheticLM(49408, 1024, 4); float for DEC_TRAIN's
   steps with the loss gated on falling (the last 5 below the first 5 and
   below step 0; AdamW as DEC_TRAIN sets it, from probes), NPE-16 and NPE-8 for
   a step or two with finite losses; host ms a step, tokens/s, peak memory,
   in float device-busy ms and idle share; one NPE-8 step's launches checked exactly
   (`dec_train_launch_counts`) and each held to its plain version (`Audit`,
   `GradAudit`: the dense mode's backward by `attn_grad_check`); Granite's
   router gradients (nonzero in every layer in float) and capacity drops;
   and the route check at 2 layers, full width, bf16 compute against the
   CPU's plain route in float and NPE-8 (`train_route_compare`'s
   gates, the plain route's change under one bf16 ulp of every master;
   Granite routed as the CPU routed, its own differing choices counted);
17. prints the kernel list (the backward kernels too), one JSON line of
   per-kernel numbers (launches on the encoder, decode, npec, engine, GLM4,
   Gemma3, Granite, npec GLM4, npec Granite, RWKV6, Hymba, Whisper,
   Whisper-encoder and training paths, [16]'s two models' train steps
   among them; the npec instances of quant_matmul and nvu_softmax; the
   rows at each model's shapes and at the decoder executor's; the MMU's
   scale-path rows; a row for each backward kernel with its training
   launches, flash_attention_grad's with each of its rows), the card, and
   last `{"ok": true, "device": {...}}`.

Every route check's CPU half (the port's plain route on the CPU, and its
change under 1-ulp weights; [15]'s and [16]'s train steps too, their trees
handed over through npz files in a temporary directory) runs in a second
process (`CpuRoutes`, 6 threads), started after the build, while the
card's phases run; the check itself waits for its half.  Any failure exits
non-zero before the last line, and the second process is stopped.  Details go to
`chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import multiprocessing
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.checkpoint.ckpt import Checkpointer  # noqa: E402
from repro_torch.config import (SMOKE_MESH, FaultConfig, OptimizerConfig,  # noqa: E402
                                RunConfig, ShapeConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import nvu as nvu_mod  # noqa: E402
from repro_torch.core.quant import quantize  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, SyntheticRequests  # noqa: E402
from repro_torch.kernels import KERNELS, build, launches, ops, reset_launches  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import nvu_layernorm as ln_mod  # noqa: E402
from repro_torch.kernels import nvu_softmax as sm_mod  # noqa: E402
from repro_torch.kernels import pwl_eval as pe_mod  # noqa: E402
from repro_torch.kernels import quant_matmul as qm_mod  # noqa: E402
from repro_torch.core.pwl import _FUNCS, get_table  # noqa: E402
from repro_torch.launch.serve import Server, slot_view  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve_bert import MODES, BertServer, card_info, serve  # noqa: E402
from repro_torch.launch.steps import build_train_step, trainable  # noqa: E402
from repro_torch.models import bert, registry  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import common as cm_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.bert import Bert  # noqa: E402
from repro_torch.models.convert import param_tree_from_model  # noqa: E402
from repro_torch import npec  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# H100 SXM data sheet, dense: HBM 3.35 TB/s, int8 tensor cores 1979 TOP/s,
# bf16 tensor cores 989 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
# instructions a second of the CUDA cores, one a lane a cycle (the 67 TFLOP/s
# count an FMA as two operations): the rate of a chain of compares, selects,
# loads and single adds or multiplies, such as the PWL table searches
F32_INSTR_PER_S = 33.5e12
L2_FLUSH_BYTES = 2 * 50 * 2 ** 20   # twice the H100's 50 MB L2



def every_kernel(counts):
    """`counts` with a 0 for each kernel it does not name (the backward
    kernels, in a serving path)."""
    return {k: counts.get(k, 0) for k in KERNELS}


BATCH, SEQ, BATCHES = 8, 128, 3
EXPECTED_LAUNCHES = every_kernel({"quant_matmul": 73, "nvu_layernorm": 25, "nvu_softmax": 12,
                                  "pwl_eval": 12, "flash_attention": 0})
# decode serving: 8 slots, prompts of up to 128 tokens, 64 steps, 256 rows
SLOTS, MAX_PROMPT, GEN, MAX_SEQ = 8, 128, 64, 256
# launches of one decode step, and of one one-slot prefill, in each mode
DECODE_LAUNCHES = {mode: every_kernel(counts) for mode, counts in {
    "npe-8bit": {"quant_matmul": 73, "pwl_eval": 12, "nvu_layernorm": 25,
                 "nvu_softmax": 0, "flash_attention": 12},
    "npe-16bit": {"quant_matmul": 0, "pwl_eval": 12, "nvu_layernorm": 25,
                  "nvu_softmax": 0, "flash_attention": 12},
    "float": {"quant_matmul": 0, "pwl_eval": 0, "nvu_layernorm": 0,
              "nvu_softmax": 0, "flash_attention": 12},
}.items()}
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative to the value
NPE16_TOL = 5e-3               # the reference's NPE-mode gate
FLOAT_TOL = 1e-3               # float32 route on the card vs the CPU, 2 layers
NOISE_FACTOR, TOP1_MARGIN = 2.0, 0.02
# GLM4-9B decode serving: 8 slots, prompts of up to 128 tokens, 16 steps, 256 rows
GLM4_GEN = 16
# launches of one GLM4-9B decode step, and of one one-slot prefill: 40 layers
# of q/k/v/o/gate/up/down and the head; two RMSNorms a layer and the final one;
# the SiLU of each gate; one dense attention a layer
GLM4_LAUNCHES = {mode: every_kernel(counts) for mode, counts in {
    "npe-8bit": {"quant_matmul": 281, "nvu_layernorm": 81, "pwl_eval": 40,
                 "flash_attention": 40, "nvu_softmax": 0},
    "npe-16bit": {"quant_matmul": 0, "nvu_layernorm": 81, "pwl_eval": 40,
                  "flash_attention": 40, "nvu_softmax": 0},
    "float": {"quant_matmul": 0, "nvu_layernorm": 0, "pwl_eval": 0,
              "flash_attention": 40, "nvu_softmax": 0},
}.items()}
# (K, N) of a GLM4-9B decode step's products: q/o, k/v, gate/up, down, head
GLM4_PRODUCTS = [(4096, 4096), (4096, 256), (4096, 13696), (13696, 4096), (4096, 151552)]
GLM4_PREFILL_ROWS = 120     # the longest of [5]'s prompts: M of the tiled instance
# Gemma3-27B decode serving: 8 slots, prompts of up to 16 tokens prefilled one
# token a call (the ring), 8 steps, 32 rows (rings of min(1024, 32)); the
# wrap: one slot to position 1040 over a 1048-row cache (1024-row rings),
# through the first 6 layers (one local:global period: 5 local, 1 global),
# since 1040 one-token steps of all 62 take about 90 s of host launches
GEMMA3_MAX_PROMPT, GEMMA3_GEN, GEMMA3_MAX_SEQ = 16, 8, 32
GEMMA3_WRAP_POS, GEMMA3_WRAP_SEQ, GEMMA3_WRAP_LAYERS = 1040, 1048, 6
# served depth: 6 of the 62 layers, one whole local:global period (5
# local, 1 global), which keeps the whole script inside its time budget
# (12 layers took [9] 62.3-77.3 s on an H100 80GB HBM3 at 700 W)
GEMMA3_LAYERS = 6
# launches of one Gemma3-27B decode step (a prefill: one such step a prompt
# token) at L layers: q/k/v/o/gate/up/down a layer and the tied head; two
# RMSNorms and the q and k norms a layer and the final one; the GELU of each
# gate; one dense attention a layer (25 over a ring, 5 global at L = 30)
GEMMA3_LAUNCHES = {mode: every_kernel(counts) for mode, counts in {
    "npe-8bit": {"quant_matmul": 7 * GEMMA3_LAYERS + 1, "nvu_layernorm": 4 * GEMMA3_LAYERS + 1,
                 "pwl_eval": GEMMA3_LAYERS, "flash_attention": GEMMA3_LAYERS, "nvu_softmax": 0},
    "npe-16bit": {"quant_matmul": 0, "nvu_layernorm": 4 * GEMMA3_LAYERS + 1,
                  "pwl_eval": GEMMA3_LAYERS, "flash_attention": GEMMA3_LAYERS, "nvu_softmax": 0},
    "float": {"quant_matmul": 0, "nvu_layernorm": 0, "pwl_eval": 0,
              "flash_attention": GEMMA3_LAYERS, "nvu_softmax": 0},
}.items()}
# Granite-3.0-1B-A400M decode serving: [5]'s 8 prompts (33 to 120 tokens, one
# multi-token prefill each), 16 steps, 256 rows
GRANITE_GEN = 16
# launches of one Granite step, and of one one-slot prefill: 24 layers of
# q/k/v/o and the tied head (the expert products are plain products, as in the
# reference); two RMSNorms a layer and the final one; the SiLU of the
# experts' gates and the router's softmax a layer; one dense attention a layer
GRANITE_LAUNCHES = {mode: every_kernel(counts) for mode, counts in {
    "npe-8bit": {"quant_matmul": 97, "nvu_layernorm": 49, "pwl_eval": 24,
                 "flash_attention": 24, "nvu_softmax": 24},
    "npe-16bit": {"quant_matmul": 0, "nvu_layernorm": 49, "pwl_eval": 24,
                  "flash_attention": 24, "nvu_softmax": 24},
    "float": {"quant_matmul": 0, "nvu_layernorm": 0, "pwl_eval": 0,
              "flash_attention": 24, "nvu_softmax": 0},
}.items()}
REPLACES = {
    "pwl_eval": "src/repro/kernels/pwl_eval.py:79",
    "quant_matmul": "src/repro/kernels/quant_matmul.py:73",
    "nvu_softmax": "src/repro/kernels/nvu_softmax.py:76",
    "nvu_layernorm": "src/repro/kernels/nvu_layernorm.py:70",
    "flash_attention": "src/repro/kernels/flash_attention.py:130",
}
# (atol, rtol) of each kernel against its plain version: the f32 values are
# those of tests/test_kernels.py (gather vs prefix-delta PWL, sums in another
# order); a bf16 result may round to the neighbouring bf16 value as well.
TOLS = {
    ("pwl_eval", torch.float32): (1e-5, 1e-5),
    ("pwl_eval", torch.bfloat16): (1e-5, BF16_RTOL),
    ("quant_matmul", torch.float32): (1e-5, 1e-5),
    ("quant_matmul", torch.bfloat16): (1e-5, BF16_RTOL),
    ("nvu_softmax", torch.float32): (2e-5, 2e-5),
    ("nvu_softmax", torch.bfloat16): (2e-5, BF16_RTOL),
    ("nvu_layernorm", torch.float32): (3e-5, 3e-5),
    ("nvu_layernorm", torch.bfloat16): (3e-5, BF16_RTOL),
    ("flash_attention", torch.float32): (2e-5, 2e-5),
    ("flash_attention", torch.bfloat16): (2e-5, BF16_RTOL),
    # the backward rows (GRAD_RTOL): pwl_eval_grad bit for bit; the others
    # within 2e-5 of their result's largest value, a bf16 result one rounding
    ("pwl_eval_grad", torch.bfloat16): (0.0, 0.0),
    ("nvu_softmax_grad", torch.float32): (2e-5, 0.0),
    ("nvu_layernorm_grad", torch.bfloat16): (2e-5, BF16_RTOL),
    ("quant_matmul_grad", torch.float32): (2e-5, 0.0),
    # the dense mode's backward: `attn_grad_check` (its check_fn) holds it
    ("flash_attention_grad", torch.bfloat16): (0.0, BF16_RTOL),
}


def say(*a):
    print(*a, flush=True)


def compare(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float):
    """(max-abs error, whether every element is within atol + rtol*|want|)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), bool((err <= atol + rtol * w.abs()).all())


STATS_RTOL = 1e-4   # the forward's row statistics against the plain version's


def recip_jump() -> float:
    """The NVU reciprocal's relative jump at a power of two (its table's
    ends do not meet: 1/x just below 2^e and at 2^e differ by about 6.5e-4
    of the value), which a row's PWL norm may take when the kernel's and
    the plain version's sums, added in other orders, lie on either side
    of a power of two."""
    one = torch.tensor([1.0])
    below = torch.nextafter(one, torch.tensor([0.0]))
    at = nvu_mod.nvu_reciprocal(one)
    return float((nvu_mod.nvu_reciprocal(below) - at).abs() / at)


def dense_compare(q, k, v, kw, got):
    """(max-abs error, ok) of the dense mode against its plain version: within
    atol + rtol*|want| as for flash (TOLS), plus 2^-7 of sum_j p_j |v_j|,
    since with sums in another order a probability can round to the
    neighbouring bf16 value before P.V (tests/test_torch_cuda_kernels.py).
    A call that also returned its row statistics (m, norm) is held by its
    output and by them: m within STATS_RTOL of max(|m|, 1) of the plain
    version's `row_stats`, since the scores differ by the order of their D
    products' sums; the norm within STATS_RTOL of its value, and in PWL mode
    also the reciprocal's jump at a power of two (`recip_jump`), since the
    row's sum may lie on the other side of one.  A call of more than 2^26
    scores runs the plain version a batch element at a time (a train step's
    audit holds it beside the step's state)."""
    kw = {key: val for key, val in kw.items() if key != "with_stats"}
    stats = got[1] if isinstance(got, tuple) else None
    got = got[0] if isinstance(got, tuple) else got
    atol, rtol = TOLS[("flash_attention", got.dtype)]
    norm_rtol = STATS_RTOL + (recip_jump() if kw.get("use_pwl", True) else 0.0)
    big = q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] > 1 << 26
    worst, ok = 0.0, True
    for lo, hi in ([(i, i + 1) for i in range(q.shape[0])] if big else [(0, q.shape[0])]):
        qi, ki, vi = q[lo:hi], k[lo:hi], v[lo:hi]
        want, want_stats = fa_mod.dense_attention_plain(qi, ki, vi, with_stats=True, **kw)
        spread = fa_mod.dense_attention_plain(qi, ki, vi.abs(), **dict(kw, out_dtype=torch.float32))
        err = (got[lo:hi].float() - want.float()).abs()
        worst = max(worst, float(err.max()))
        ok = ok and bool((err <= atol + rtol * want.float().abs() + 2.0 ** -7 * spread).all())
        if stats is not None:
            gate = torch.stack([STATS_RTOL * want_stats[..., 0].abs().clamp(min=1.0),
                                norm_rtol * want_stats[..., 1].abs()], -1)
            ok = ok and bool(((stats[lo:hi] - want_stats).abs() <= gate).all())
    return worst, ok


def _kernel_times(prof, with_counts: bool = False):
    """(name, device us) of every kernel and copy the card ran in the window
    (with `with_counts`, (name, device us, launches)).  Only device-side
    events count: an aten op also reports the device time of the kernels it
    launched, and counting both would count them twice."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out.append((e.key, us, e.count) if with_counts else (e.key, us))
    return out


def measure(fn, reps: int = 20):
    """(device ms per call from torch.profiler, or None if it saw no device
    time; ms per call between CUDA events).  A trace in which some kernel
    ran fewer times than there were calls has lost events (a call that
    launches two kernels can lose one of them): it is taken again, up to 3
    times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / reps
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = _kernel_times(prof, with_counts=True)
        if times and all(n >= reps for _, _, n in times):
            dev_us = sum(us for _, us, _ in times)
            return dev_us / 1e3 / reps, event_ms
    return None, event_ms


def measure_cold(fn, reps: int = 20):
    """(device ms per call from torch.profiler, or None if it saw none; ms
    per call between CUDA events around each launch), with the L2 cache
    flushed (a buffer twice its size overwritten) before each launch: the
    state in which a decode step finds the next layer's cache, and in which
    every byte of the bound comes from HBM.  The profiler's time is that of
    fn's own kernels (those a trace of fn alone shows), not the flush's or
    the sleep's.  A sleep kernel ahead of each flush keeps the host's
    queueing out of the events' interval."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed_calls():
        total = 0.0
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)   # the card waits while the host queues the rest
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    for _ in range(3):
        fn()
    event_ms = flushed_calls()
    own = set()
    for _ in range(3):   # the names of fn's kernels, from a trace of fn alone that lost none
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = _kernel_times(prof, with_counts=True)
        if sum(n for _, _, n in times) >= reps:
            own = {k for k, _, _ in times}
            break
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            flushed_calls()
        times = [t for t in _kernel_times(prof, with_counts=True) if t[0] in own]
        if own and sum(n for _, _, n in times) >= reps:
            return sum(us for _, us, _ in times) / 1e3 / reps, event_ms
    return None, event_ms


def bound(bytes_moved: float, *work):
    """The least time for the work: the larger of the bytes over the memory
    rate and, for each (operations, rate) pair, the operations over their
    rate.  (ms, "bytes" or "operations")"""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops / rate for ops, rate in work)
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def ptxas_table(log: str):
    """{mangled kernel: [registers, static smem bytes, spill store bytes,
    spill load bytes]} from nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = [0, 0, 0, 0]
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn][2:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            out[fn][:2] = [int(m.group(1)), int(m.group(2))]
    return out


def demangle(names):
    """{mangled: short readable name} by c++filt where it exists."""
    same = {n: n for n in names}
    tool = shutil.which("c++filt")
    if not tool or not names:
        return same
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or len(lines) != len(names):
        return same
    short = {}
    for n, d in zip(names, lines):
        d = d.replace("(anonymous namespace)::", "").removeprefix("void ")
        short[n] = d.split("(", 1)[0]
    return short


def sass_counts(lib: Path):
    """{kernel function: (HMMA, IMMA) instruction count} in the SASS of the
    built library, by cuobjdump from the CUDA toolkit, HMMA counting the
    warpgroup products (HGMMA) too; None where the tool is missing or
    fails."""
    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    try:
        res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        return None
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts.setdefault(fn, [0, 0])
        elif fn is not None:
            counts[fn][0] += "HMMA" in line or "HGMMA" in line
            counts[fn][1] += "IMMA" in line
    return counts


def pwl_ops(name: str) -> int:
    """Operations of one PWL evaluation by the walk: a compare and two adds
    for each interior knot, then a multiply and an add."""
    return 3 * (get_table(name, 16).num_segments - 1) + 2


def prefix_search_instr(name: str) -> int:
    """Instructions of one PWL evaluation by the prefix search
    (`npe_pwl_prefix_n`): each step of the binary search over the S-1
    interior knots an address add, a shared load, a compare and a select;
    then the 8-byte load of the segment's prefixes, a multiply and an add."""
    return 4 * (get_table(name, 16).num_segments - 1).bit_length() + 3


def dense_chain_instr(use_pwl: bool, cap: float, backward: bool = False) -> int:
    """CUDA-core instructions that the function needs for one visible
    (query, key) pair of the dense mode, each step once (the function's
    chain, not the kernels' repeated sweeps), counted from
    `csrc/flash_attention.cu` and `csrc/flash_attention_grad.cu`.  The
    mask's compares and selects are left out: the function needs them only
    at chunks that some row sees in part (the kernels skip them on chunks
    that every row of a tile sees).  Forward: the scale multiply, the max,
    the subtract, the exp (PWL: the -18 clamp, the search, the floor at 0;
    exact: ex2 and its multiply), the sum, the normalizing multiply (exact:
    a divide) and the rounding to bf16.  Backward (PWL): the scale,
    subtract, clamp, the exp's search and its slope's load, the floor, dp^'s
    rounding; the statistics' dr (multiply, add), sum, w (two multiplies,
    the floor's and the clip's compares and selects), sum dp^ w and sum w,
    the tie's compare and add; dS_ij's multiply, add and three multiplies,
    the max's share (compare, add), the scale; p^'s multiply and rounding.
    Exact: scale, subtract, exp (2), dp^'s rounding, p's divide, sum p dp^
    (2), dS_ij (three) and its scale, p^'s rounding.  dS's split into three
    bf16 pieces is the kernels' way to an exact product on the tensor
    cores, not the function's: it is in neither this chain nor the rows'
    product count (five products of one piece).  A soft cap adds its
    divide, clamp, tanh (PWL: a search; exact: four) and multiply, and in
    the backward the tanh slope's load, a multiply, the clip (three) and a
    divide."""
    if use_pwl:
        chain = (8 if not backward else 30) + prefix_search_instr("exp")
    else:
        chain = 8 if not backward else 13
    if cap:
        tanh = prefix_search_instr("tanh") if use_pwl else 4
        chain += 4 + tanh + (6 if backward else 0)
    return chain


def pwl_prefix_ops(name: str) -> int:
    """Operations of one PWL evaluation from a prefix table: the compares of
    the binary search over the S-1 interior knots, then a multiply and an add."""
    return (get_table(name, 16).num_segments - 1).bit_length() + 2


# --- phase 3: each kernel against its plain version -------------------------

def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal float32 bits, any NaN as one pattern."""
    g, w = got.float(), want.float()
    g = torch.where(torch.isnan(g), torch.full_like(g, float("nan")), g)
    w = torch.where(torch.isnan(w), torch.full_like(w, float("nan")), w)
    return torch.equal(g.view(torch.int32), w.view(torch.int32))


def launch_floor():
    """(device ms, event ms) of an empty 256-thread block, by `measure`."""
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    return measure(lambda: build.check(lib.npe_launch_floor(stream), "launch_floor"))


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t one element into its storage: its address is
    not 16-byte aligned, so the kernels take their scalar/block instances."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.copy_(t.reshape(-1)).view(t.shape)


# The dense mode's rows that its tensor-core instance and its backward run,
# device ms before their redesign (PERF.md section 6: this script's [3] on
# the H100 80GB HBM3 at 700 W, the backward rows at the parent tree of the
# redesign, the forward rows at the trees that added them, the decode
# instance's and the softmax backward's at the parent tree of theirs)
PREVIOUS_MS = {
    "dense prefill (1, 12, 128, 64) kv 128/256 pwl": 0.0070,
    "dense prefill (1, 12, 128, 64) kv 128/256": 0.0077,
    "dense decode (8, 32 over 2, 1, 128) kv 256/256 pwl": 0.0219,
    "dense decode (8, 32 over 2, 1, 128) kv 256/256": 0.0257,
    "dense decode (8, 32 over 2, 1, 128) kv 256/256 pwl cold L2": 0.0225,
    "dense prefill (1, 32 over 2, 128, 128) kv 128/256 pwl": 0.0199,
    "dense prefill (1, 32 over 2, 128, 128) kv 128/256": 0.0212,
    "ring decode (8, 24 over 2, 1, 128) kv 4096/4096 causal off pwl": 0.4858,
    "windowed prefill (1, 32 over 16, 2048, 128) kv 2048/2048 window 1024 pwl": 1.5341,
    "encoder (8, 8, 1500, 64) kv 1500/1500 pwl": 1.3273,
    "grad StarCoder2 (4, 24 over 2, 1024, 128) causal pwl": 6.4226,
    "grad StarCoder2 (4, 24 over 2, 1024, 128) causal exact": 5.7173,
    "grad Granite (4, 16 over 8, 1024, 64) causal pwl": 2.9457,
    "grad GLM4 (1, 32 over 2, 1024, 128) causal pwl": 3.0062,
    "grad Gemma3 (1, 32 over 16, 2048, 128) causal window 1024 pwl": 6.0590,
    "grad Gemma3 (1, 32 over 16, 2048, 128) causal window 1024 cap 50 pwl": 7.7935,
    "grad Whisper cross (8, 8, 448, 64) kv 1500 causal off pwl": 3.6949,
    # the decode instance (one block a (batch, kv head)) and the softmax
    # backward (a warp a row, the walks) at the parent tree of their redesign
    "dense decode (8, 12, 1, 64) kv 256/256 pwl": 0.0063,
    "dense decode (8, 12, 1, 64) kv 256/256": 0.0060,
    "dense decode (8, 12, 1, 64) kv 1024/1024 pwl": 0.0140,
    "dense decode (8, 12, 1, 64) kv 1024/1024": 0.0136,
    "dense decode (8, 12, 1, 64) kv 2048/2048 pwl": 0.0321,
    "dense decode (8, 12, 1, 64) kv 2048/2048": 0.0314,
    "dense decode (8, 12, 1, 64) kv 16384/16384 pwl": 0.4656,
    "dense decode (8, 12, 1, 64) kv 16384/16384": 0.4514,
    "ring decode (8, 32 over 16, 1, 128) kv 1024/1024 causal off pwl": 0.1307,
    "ring decode (8, 32 over 16, 1, 128) kv 1024/1024 causal off": 0.1286,
    "ring decode (8, 32 over 16, 1, 128) kv 300/1024 causal off pwl": 0.0416,
    "ring decode (8, 32 over 16, 1, 128) kv 300/1024 causal off": 0.0400,
    "soft-capped decode (8, 32 over 16, 1, 128) kv 1024/1024 cap 50 pwl": 0.2837,
    "soft-capped decode (8, 32 over 16, 1, 128) kv 1024/1024 cap 50": 0.2183,
    "ring decode (8, 25 over 5, 1, 64) kv 32/32 causal off pwl": 0.0130,
    "ring decode (8, 25 over 5, 1, 64) kv 32/32 causal off": 0.0119,
    "cross decode (8, 8, 1, 64) kv 1500/1500 causal off pwl": 0.0188,
    "cross decode (8, 8, 1, 64) kv 1500/1500 causal off": 0.0181,
    "(12288, 128) scale 0.125 dy bf16": 0.0300,
    # the layernorm backward and pwl_eval's derivative mode (their first
    # kernels) at the parent tree of their redesign, by
    # scripts/dense_attention_rows.py --part nvu_grad; keyed by kernel too,
    # since the forward rows share these shapes
    ("pwl_eval_grad", "(1024, 3072) gelu"): 0.0159,
    ("pwl_eval_grad", "(4096, 12288) gelu"): 0.2548,
    ("pwl_eval_grad", "(40960, 512) silu"): 0.1081,
    ("nvu_layernorm_grad", "(1024, 768)"): 0.0256,
    ("nvu_layernorm_grad", "(4096, 3072)"): 0.2062,
    ("nvu_layernorm_grad", "(4096, 1024) rms"): 0.0358,
}


def kernel_row(rows, floor_ms, kernel, shape, dtype, kernel_fn, plain_fn, bytes_moved, work,
               library_fn=None, library_name="torch._int_mm", cold=False,
               walk_fn=None, yardstick_fn=None, yardstick_name=None, check_fn=None,
               copy_fn=None, walk_name="walk", cell=None, plain_reps=20):
    """Hold one kernel call against its plain version, time it and append
    its row to `rows`.  `work`: (operations, rate) pairs of the bound.  With
    `cold`, the kernel, library, yardstick and copy times are taken with the
    L2 flushed before each launch, the plain version's as usual.  `walk_fn`:
    a result the kernel must equal bit for bit (`walk_name` in the line).
    `yardstick_fn`: a call on the same tensors that is timed only (not the
    same function).  `check_fn(got)`: (max-abs error, ok) in place of the
    TOLS comparison with plain_fn.  `copy_fn`: one torch copy that moves the
    kernel's bytes with no arithmetic, timed as the floor of its memory
    stream.  `cell`: the model whose shapes the row takes where it is not
    BERT ("glm4").  `plain_reps`: the plain version's timed calls."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    atol, rtol = TOLS[(kernel, dtype)]
    err, ok = check_fn(got) if check_fn else compare(got, want, atol, rtol)
    exact = same_bits(got, walk_fn()) if walk_fn else None
    timer = measure_cold if cold else measure
    ms, ev = timer(kernel_fn)
    lms, lev = timer(library_fn) if library_fn else (None, None)
    pms, pev = measure(plain_fn, plain_reps)
    yms, yev = timer(yardstick_fn) if yardstick_fn else (None, None)
    cms, cev = timer(copy_fn) if copy_fn else (None, None)
    bms, by = bound(bytes_moved, *work)
    r = dict(kernel=kernel, shape=shape, dtype=str(dtype).replace("torch.", ""),
             max_abs_err=err, atol=atol, rtol=rtol, ok=ok and exact is not False,
             bit_exact_walk=exact,
             ms=ms if ms is not None else ev,
             ms_source=("profiler" if ms else "events") + (", L2 flushed" if cold else ""),
             event_ms=ev, plain_ms=pms if pms is not None else pev,
             library_ms=(lms if lms is not None else lev) if library_fn else None,
             bound_ms=bms, bound_by=by, bound_share=bms / (ms if ms is not None else ev),
             library=library_name if library_fn else None,
             yardstick_ms=(yms if yms is not None else yev) if yardstick_fn else None,
             yardstick=yardstick_name, launch_floor_ms=floor_ms,
             copy_ms=(cms if cms is not None else cev) if copy_fn else None, cell=cell)
    rows.append(r)
    lib = f"  {library_name} {r['library_ms']:.4f}" if library_fn else ""
    extra = "" if exact is None else f", {walk_name} {'bit-exact' if exact else 'DIFFERS'}"
    if yardstick_fn:
        extra += (f"  [{yardstick_name} {r['yardstick_ms']:.4f}: same bytes, exact math, "
                  "not the same function]")
    if copy_fn:
        extra += f"  [a copy of the same bytes {r['copy_ms']:.4f}]"
    if shape.startswith("(8,"):
        extra += f"  over the launch floor {r['ms'] - floor_ms:+.4f}"
    prev = PREVIOUS_MS.get((kernel, shape), PREVIOUS_MS.get(shape))
    if prev is not None:
        r["previous_ms"] = prev
        extra += f"  [before the redesign: {prev:.4f}]"
    say(f"  {kernel:13s} {shape:28s} {r['dtype']:8s} err {err:.2e} "
        f"(atol {atol:g}, rtol {rtol:.3g}) {'ok' if ok else 'FAIL'}{extra}  "
        f"kernel {r['ms']:.4f} ms (events {ev:.4f})  plain {r['plain_ms']:.4f} "
        f"(not a yardstick)  bound {bms:.6f} ({by}, {r['bound_share']:.0%} of it){lib}")
    if not r["ok"]:
        raise SystemExit(f"{kernel} {shape} {dtype}: kernel disagrees with plain"
                         + (f" or the {walk_name}" if exact is False else ""))


def kernel_rows(dev, floor_ms):
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    row = functools.partial(kernel_row, rows, floor_ms)

    import torch.nn.functional as F
    # pwl_eval: the GELU of each FFN, (8*128, 3072) encoding, (8, 3072) a
    # decode step; once more unaligned (the scalar instance).  The encoder
    # rows are timed once more with the L2 flushed before each launch: warm,
    # their 12-25 MB stay in the 50 MB L2 and the HBM bound does not hold.
    gelu_tab = pe_mod.device_table("gelu", 16, dev)
    for m, dt, skew in ((1024, torch.bfloat16, False), (1024, torch.float32, False),
                        (8, torch.bfloat16, False), (8, torch.float32, False),
                        (1024, torch.bfloat16, True)):
        x = (torch.randn(m, 3072, generator=g, device=dev) * 4).to(dt)
        if skew:
            x = unaligned(x)
        for cold in (False, True) if m == 1024 and not skew else (False,):
            row("pwl_eval", f"({m}, 3072) gelu" + (" unaligned" if skew else "")
                + (" cold L2" if cold else ""), dt,
                lambda: pe_mod.pwl_eval(x, "gelu"),
                lambda: pe_mod.pwl_eval_plain(x, get_table("gelu", 16)),
                x.numel() * 2 * x.element_size(),
                [(x.numel() * pwl_prefix_ops("gelu"), F32_OPS_PER_S)],
                walk_fn=lambda: pe_mod.pwl_eval_walk(x, gelu_tab).to(x.dtype),
                yardstick_fn=lambda: F.gelu(x), yardstick_name="F.gelu", cold=cold)

    # quant_matmul: every NPE-8 projection and the logits head, bf16 out
    for m, k, n, act, dt in [(1024, 768, 768, None, torch.bfloat16),
                             (1024, 768, 3072, None, torch.bfloat16),
                             (1024, 3072, 768, None, torch.bfloat16),
                             (1024, 768, 30720, None, torch.bfloat16),
                             (1024, 768, 3072, "gelu", torch.float32),
                             (8, 768, 768, None, torch.bfloat16),
                             (8, 768, 3072, None, torch.bfloat16),
                             (8, 3072, 768, None, torch.bfloat16),
                             (8, 768, 30720, None, torch.bfloat16)]:
        xq = quantize(torch.randn(m, k, generator=g, device=dev), 8)
        wq = quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, 8, axis=1)
        a, b = xq.q.contiguous(), wq.q.contiguous()
        table = get_table(act, 16) if act else None
        out_bytes = torch.empty((), dtype=dt).element_size()
        # torch._int_mm takes M > 16 only: at decode rows it multiplies the
        # rows zero-padded to 32
        lib_a = a if m > 16 else torch.cat([a, a.new_zeros(32 - m, k)])
        row("quant_matmul", f"({m}, {k}) @ ({k}, {n})" + (" +gelu" if act else ""), dt,
            lambda: qm_mod.quant_matmul(a, b, xq.scale, wq.scale, act, out_dtype=dt),
            lambda: qm_mod.quant_matmul_plain(a, b, xq.scale, wq.scale, table, dt),
            m * k + k * n + 4 + 4 * n + m * n * out_bytes, [(2 * m * n * k, INT8_OPS_PER_S)],
            library_fn=None if act else (lambda: torch._int_mm(lib_a, b)),
            library_name="torch._int_mm" if m > 16 else "torch._int_mm, rows zero-padded to 32")

    # nvu_softmax: the attention scores, (B*H*S, S) float32, as the encoder
    # calls it (scale 0.125, bf16 out), f32 out, and causal; bit for bit
    # against the walk in torch ops; the encoder rows once more from a
    # flushed L2, beside torch.softmax (exact math, f32 out: a yardstick)
    # and a copy of the same bytes into the output's dtype
    x = torch.randn(12288, 128, generator=g, device=dev) * 3
    # scale, max, subtract, clamp, the search and its multiply-add, floor,
    # sum, multiply; one PWL 1/sum a row
    sm_ops = x.numel() * (pwl_prefix_ops("exp") + 7) + x.shape[0] * (pwl_ops("recip") + 6)
    for causal, scale, dt in ((0, 0.125, torch.bfloat16), (0, 1.0, torch.float32),
                              (128, 1.0, torch.float32)):
        y_copy = torch.empty(x.shape, dtype=dt, device=dev)   # f32 -> dt, no arithmetic
        for cold in (False, True) if not causal else (False,):
            row("nvu_softmax", "(12288, 128)" + (" causal" if causal else "")
                + (f" scale {scale:g}" if scale != 1.0 else "") + (" cold L2" if cold else ""), dt,
                lambda: sm_mod.nvu_softmax(x, causal_rows=causal, scale=scale, out_dtype=dt),
                lambda: sm_mod.nvu_softmax_plain(x, causal_rows=causal, scale=scale, out_dtype=dt),
                x.numel() * (4 + torch.empty((), dtype=dt).element_size()),
                [(sm_ops, F32_OPS_PER_S)],
                walk_fn=lambda: sm_mod.nvu_softmax_walk(x, causal_rows=causal, scale=scale,
                                                        out_dtype=dt),
                yardstick_fn=None if causal else (lambda: torch.softmax(x, dim=-1)),
                yardstick_name="torch.softmax", cold=cold,
                copy_fn=None if causal else (lambda: y_copy.copy_(x)))

    # nvu_layernorm: the embedding and both post-norms, (1024, 768), eps 1e-12
    gam = 1 + 0.1 * torch.randn(768, generator=g, device=dev)
    bet = 0.1 * torch.randn(768, generator=g, device=dev)
    # (the warp instance; once more unaligned, the block instance; the
    # encoder rows once more from a flushed L2, as for pwl_eval)
    for m, dt, skew in ((1024, torch.bfloat16, False), (1024, torch.float32, False),
                        (8, torch.bfloat16, False), (8, torch.float32, False),
                        (1024, torch.bfloat16, True)):
        x = (torch.randn(m, 768, generator=g, device=dev) * 3 + 0.7).to(dt)
        if skew:
            x = unaligned(x)
        gam_t, bet_t = gam.to(dt), bet.to(dt)
        for cold in (False, True) if m == 1024 and not skew else (False,):
            row("nvu_layernorm", f"({m}, 768)" + (" unaligned" if skew else "")
                + (" cold L2" if cold else ""), dt,
                lambda: ln_mod.nvu_layernorm(x, gam, bet, eps=1e-12),
                lambda: ln_mod.nvu_layernorm_plain(x, gam, bet, eps=1e-12),
                x.numel() * 2 * x.element_size() + 2 * 768 * 4,
                # sum, subtract, square-add, subtract, two multiplies, add; one PWL a row
                [(x.numel() * 8 + x.shape[0] * (pwl_ops("rsqrt") + 8), F32_OPS_PER_S)],
                yardstick_fn=lambda: F.layer_norm(x, (768,), gam_t, bet_t, eps=1e-12),
                yardstick_name="F.layer_norm", cold=cold)

    flash_rows(dev, g, row)
    dense_rows(dev, g, row)
    glm4_kernel_rows(dev, g, row)
    npec_kernel_rows(dev, floor_ms, rows)
    npec_decoder_kernel_rows(dev, floor_ms, rows)
    mask_rows(dev, row)
    family_kernel_rows(dev, g, row)
    grad_kernel_rows(dev, g, row)
    attn_grad_rows(dev, g, row)
    return rows


# --- phase 3 (training): the backward kernels against their plain backward --

GRAD_RTOL = 2e-5   # a backward kernel vs its plain backward, of the result's largest value


def grad_check(plain_fn, bf16=()):
    """check_fn of a backward row: each result within GRAD_RTOL of the
    largest value of its plain counterpart (sums in another order), plus,
    where the result is bf16, one bf16 rounding (BF16_RTOL of itself);
    (max-abs error, ok)."""
    def check(got):
        want = plain_fn()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst, ok = 0.0, True
        for a, b in zip(got, want):
            if b is None:
                continue
            a, b = a.float(), b.float()
            err = (a - b).abs()
            gate = GRAD_RTOL * float(b.abs().max()) + (BF16_RTOL * b.abs() if bf16 else 0.0)
            worst = max(worst, float(err.max()))
            ok = ok and bool((err <= gate).all())
        return worst, ok
    return check


def pwl_walk_ops(name: str) -> int:
    """Operations of one PWL derivative by the walk: a compare and an add
    for each interior knot, then two multiplies."""
    return 2 * (get_table(name, 16).num_segments - 1) + 2


# the softmax backward's rows: (rows, n, scale, dy dtype): the attention
# softmax of BERT-base 8 x 128 and Granite's router softmax (4096 tokens of a
# 4 x 1024 train step over 32 experts)
SOFTMAX_GRAD_ROWS = [(12288, 128, 0.125, "bf16"), (4096, 32, 1.0, "f32")]
# pwl_eval's derivative mode, bf16: (table, rows, n, cell): BERT-base's GELU
# (8 x 128 tokens, d_ff 3072), StarCoder2-3B's (a 4 x 1024 train step, d_ff
# 12288) and Granite's expert SiLU (32 experts x 4 sequences x 320 slots,
# the capacity int(1024 * 8 / 32 * 1.25), of d_ff 512)
PWL_GRAD_ROWS = [("gelu", 1024, 3072, None), ("gelu", 4096, 12288, "starcoder2"),
                 ("silu", 40960, 512, "granite")]
# the layernorm backward, bf16: (rows, n, eps, rms_only, cell): BERT-base's
# LayerNorm, StarCoder2-3B's (with beta) and Granite's RMSNorm, 4 x 1024 tokens
LN_GRAD_ROWS = [(1024, 768, 1e-12, False, None), (4096, 3072, 1e-5, False, "starcoder2"),
                (4096, 1024, 1e-6, True, "granite")]


def grad_kernel_rows(dev, g, row):
    """The training path's backward passes at BERT-base 8 x 128: the GELU's
    derivative (1024, 3072), the attention softmax's (12288, 128, scale
    0.125, dy bf16), the LayerNorm's (1024, 768) and the MMU's scale path at
    every product of a layer and the head; and at the decoders' shapes
    (`PWL_GRAD_ROWS`, `SOFTMAX_GRAD_ROWS`, `LN_GRAD_ROWS`).  Beside each a
    yardstick of the same bytes, torch's own backward of F.gelu, F.silu,
    torch.softmax and F.layer_norm (exact math, not the same function), and
    for the MMU torch._int_mm (the int8 product alone)."""
    for name, m, n, cell in PWL_GRAD_ROWS:
        x = (torch.randn(m, n, generator=g, device=dev) * 4).to(torch.bfloat16)
        dy = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        table = get_table(name, 16)
        yard = torch.ops.aten.gelu_backward if name == "gelu" else torch.ops.aten.silu_backward
        row("pwl_eval_grad", f"({m}, {n}) {name}", torch.bfloat16,
            lambda: pe_mod.pwl_eval_grad(x, dy, name),
            lambda: pe_mod.pwl_eval_grad_plain(x, dy, table),
            3 * x.numel() * 2, [(x.numel() * pwl_prefix_ops(name), F32_OPS_PER_S)],
            check_fn=lambda got: (float((got.float() - pe_mod.pwl_eval_grad_plain(
                x, dy, table).float()).abs().max()),
                torch.equal(got, pe_mod.pwl_eval_grad_plain(x, dy, table))),
            yardstick_fn=lambda: yard(dy, x), yardstick_name=f"aten.{name}_backward",
            cell=cell, plain_reps=20 if cell is None else 3)

    for rows_, n_, scale_, dy_ in SOFTMAX_GRAD_ROWS:
        dt_ = torch.bfloat16 if dy_ == "bf16" else torch.float32
        s = torch.randn(rows_, n_, generator=g, device=dev) * 3
        ds = torch.randn(rows_, n_, generator=g, device=dev).to(dt_)
        p_exact = torch.softmax(s * scale_, dim=-1)
        ds_f32 = ds.float()
        # the forward's exp and sum recomputed (one search of the exp table a
        # score, its value and slope), the reciprocal and its slope a row,
        # some twenty more a score
        sm_ops = s.numel() * (pwl_prefix_ops("exp") + 2 + 20) + s.shape[0] * (
            2 * pwl_prefix_ops("recip") + 20)
        kw_ = dict(scale=scale_) if scale_ != 1.0 else {}
        row("nvu_softmax_grad",
            f"({rows_}, {n_})" + (f" scale {scale_:g}" if scale_ != 1.0 else "")
            + (" dy bf16" if dt_ == torch.bfloat16 else " dy f32"),
            torch.float32,
            lambda: sm_mod.nvu_softmax_grad(s, ds, **kw_),
            lambda: sm_mod.nvu_softmax_grad_plain(s, ds, **kw_),
            s.numel() * (4 + ds.element_size() + 4), [(sm_ops, F32_OPS_PER_S)],
            check_fn=grad_check(lambda: sm_mod.nvu_softmax_grad_plain(s, ds, **kw_)),
            yardstick_fn=lambda: torch._softmax_backward_data(ds_f32, p_exact, -1,
                                                              torch.float32),
            yardstick_name="torch._softmax_backward_data", cell=None if n_ == 128 else "granite")

    for m, n, eps, rms, cell in LN_GRAD_ROWS:
        xn = (torch.randn(m, n, generator=g, device=dev) * 3 + 0.7).to(torch.bfloat16)
        dyn = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        gam = 1 + 0.1 * torch.randn(n, generator=g, device=dev)
        gam_t, bet_t = gam.to(torch.bfloat16), torch.zeros(n, dtype=torch.bfloat16, device=dev)
        _, mean, rstd = torch.ops.aten.native_layer_norm(xn, [n], gam_t, bet_t, eps)
        kw = dict(eps=eps, rms_only=rms)
        row("nvu_layernorm_grad", f"({m}, {n})" + (" rms" if rms else ""), torch.bfloat16,
            lambda: ln_mod.nvu_layernorm_grad(xn, dyn, gam, **kw),
            lambda: ln_mod.nvu_layernorm_grad_plain(xn, dyn, gam, **kw),
            # x, dy and dx; gamma, dgamma and (with beta) dbeta
            xn.numel() * 3 * 2 + (2 if rms else 3) * n * 4,
            [(xn.numel() * 30 + xn.shape[0] * (pwl_ops("rsqrt") + pwl_walk_ops("rsqrt") + 20),
              F32_OPS_PER_S)],
            check_fn=grad_check(lambda: ln_mod.nvu_layernorm_grad_plain(xn, dyn, gam, **kw),
                                bf16=True),
            yardstick_fn=lambda: torch.ops.aten.native_layer_norm_backward(
                dyn, xn, [n], mean, rstd, gam_t, bet_t, [True, True, not rms]),
            yardstick_name="aten.native_layer_norm_backward", cell=cell,
            plain_reps=20 if cell is None else 5)

    for m, k, n in [(1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768),
                    (1024, 768, 30720)]:
        xq = quantize(torch.randn(m, k, generator=g, device=dev), 8)
        wq = quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, 8, axis=1)
        a, b = xq.q.contiguous(), wq.q.contiguous()
        dyq = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        row("quant_matmul_grad", f"({m}, {k}) @ ({k}, {n}) scale path", torch.float32,
            lambda: qm_mod.quant_matmul_scale_grad(a, b, xq.scale, wq.scale, dyq),
            lambda: qm_mod.quant_matmul_scale_grad_plain(a, b, xq.scale, wq.scale, dyq),
            m * k + k * n + 2 * m * n + 4 * (n + 1),
            [(2 * m * n * k, INT8_OPS_PER_S), (3 * m * n, F32_OPS_PER_S)],
            check_fn=grad_check(lambda: qm_mod.quant_matmul_scale_grad_plain(
                a, b, xq.scale, wq.scale, dyq)),
            library_fn=lambda: torch._int_mm(a, b), library_name="torch._int_mm")


def attn_grad_check(q, k, v, do, kw, got):
    """(max-abs error, ok) of the dense mode's backward kernel's (dq, dk, dv)
    against its plain backward: each within its gate
    (`flash_attention.dense_attention_grad_gates`: GRAD_RTOL of its largest
    value, or twice the plain backward's change under a score scale
    ceil(sqrt(D)) float32 ulps up or down) plus one bf16 ulp of each
    entry of a bf16 result.  The plain backward recomputes its own row
    statistics: the kernel's (`stats` in kw) stay the kernel's.  The plain
    backward and its gates run a batch element at a time, so that a train
    step's audit at StarCoder2's (4, 24 over 2, 1024, 128) fits beside the
    step's state: the gate of the whole is the largest of the elements'
    (each is a largest value or a largest change)."""
    kw = {key: val for key, val in kw.items() if key != "stats"}
    with torch.no_grad():
        parts, part_gates = [], []
        for i in range(q.shape[0]):
            ops_i = [t[i:i + 1] for t in (q, k, v, do)]
            parts.append(fa_mod.dense_attention_grad_plain(*ops_i, **kw))
            part_gates.append(fa_mod.dense_attention_grad_gates(*ops_i, parts[-1], **kw))
        want = [torch.cat(ts) for ts in zip(*parts)]
        gates = [max(gs) for gs in zip(*part_gates)]
        del parts
    worst, ok = 0.0, True
    for a, b, gate in zip(got, want, gates):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        ulp = BF16_RTOL * torch.maximum(a.abs(), b.abs()) if got[0].dtype == torch.bfloat16 else 0
        worst = max(worst, float(err.max()))
        ok = ok and bool((err <= gate + ulp).all()) and bool(torch.isfinite(a).all())
    return worst, ok


# the dense mode's backward at the training path's shapes: (name, b, hq,
# hkv, sq, skv, d, causal, window, softcap, use_pwl, cell); bf16 q, k, v and
# cotangent, as a bf16 model hands them over
ATTN_GRAD_ROWS = [
    ("StarCoder2", 4, 24, 2, 1024, 1024, 128, True, 4096, 0.0, True, "starcoder2"),
    ("StarCoder2", 4, 24, 2, 1024, 1024, 128, True, 4096, 0.0, False, "starcoder2"),
    ("Granite", 4, 16, 8, 1024, 1024, 64, True, 0, 0.0, True, "granite"),
    ("GLM4", 1, 32, 2, 1024, 1024, 128, True, 0, 0.0, True, "glm4"),
    ("Gemma3", 1, 32, 16, 2048, 2048, 128, True, 1024, 0.0, True, "gemma3"),
    ("Gemma3", 1, 32, 16, 2048, 2048, 128, True, 1024, 50.0, True, "gemma3"),
    ("Whisper cross", 8, 8, 8, 448, 1500, 64, False, 0, 0.0, True, "whisper"),
]
ATTN_GRAD_MAIN_ROW = "grad StarCoder2 (4, 24 over 2, 1024, 128) causal pwl"
# the rows' cells that [16] trains on the card
TRAINED_CELLS = {"starcoder2": "starcoder2_3b", "granite": "granite_moe_1b_a400m"}


def attn_grad_rows(dev, g, row):
    """The backward of flash attention's dense mode (`dense_attention_grad`,
    two kernels) at the decoders' training shapes, from the row statistics
    of the forward kernel on the same operands (as the train step hands them
    over), held by `attn_grad_check`.  Bytes: q, k, v and the output's
    cotangent read once, dq, dk and dv written once (bf16).  Operations: the
    backward's five products (S = Q.K^T and dP = dO.V^T again, dV, dK, dQ),
    2 D a visible pair each, at the bf16 tensor-core rate, and each visible
    pair's CUDA-core chain (`dense_chain_instr(backward=True)`) at
    F32_INSTR_PER_S.  Library: PyTorch's SDPA backward (exact softmax,
    `enable_gqa`, the same mask; none for a soft cap), timed beside the
    kernel and never called by the port."""
    import torch.nn.functional as F
    for name, b, hq, hkv, sq, skv, d, causal, window, cap, pwl, cell in ATTN_GRAD_ROWS:
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        do = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        kw = dict(causal=causal, window=window, softcap=cap, use_pwl=pwl)
        _, stats = fa_mod.dense_attention(q, k, v, with_stats=True, **kw)
        pairs = b * hq * visible_pairs(sq, skv, causal, window)
        nbytes = 2 * (2 * q.numel() + 2 * do.numel() + 4 * k.numel())
        lib = None
        if cap == 0.0:
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            hides = window > 0 and visible_pairs(sq, skv, causal, window) < visible_pairs(
                sq, skv, causal, 0)
            mask = fa_mod.dense_mask(sq, skv, causal, window, dev) if hides else None
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 is_causal=causal and mask is None,
                                                 enable_gqa=hq != hkv)
            lib = (lambda out=out, leaves=leaves, do=do:  # noqa: E731
                   torch.autograd.grad(out, leaves, do, retain_graph=True))
        mode = ("causal" if causal else "causal off") + (
            f" window {window}" if window and window < skv else "") + (
            f" cap {cap:g}" if cap else "") + (" pwl" if pwl else " exact")
        row("flash_attention_grad", f"grad {name} ({b}, {heads(hq, hkv)}, {sq}, {d})"
            + (f" kv {skv}" if skv != sq else "") + f" {mode}", torch.bfloat16,
            lambda: fa_mod.dense_attention_grad(q, k, v, do, stats=stats, **kw),
            lambda: fa_mod.dense_attention_grad_plain(q, k, v, do, **kw),
            nbytes, [(pairs * 5 * 2 * d, BF16_OPS_PER_S),
                     (pairs * dense_chain_instr(pwl, cap, backward=True), F32_INSTR_PER_S)],
            check_fn=lambda got: attn_grad_check(q, k, v, do, kw, got),
            library_fn=lib,
            library_name="SDPA backward (exact softmax" + (", enable_gqa" if hq != hkv else "")
            + ", the same mask)", cell=cell, plain_reps=3)
        del lib


def glm4_kernel_rows(dev, g, row):
    """The kernels at GLM4-9B's shapes that BERT never reached (its dense
    rows are in DENSE_ROWS): RMSNorm rows of 4096 columns (the layernorm
    kernel's rms_only mode, eps 1e-6; past 2048 columns the block instance),
    a decode step's (8, 4096) and a prefill's (1024, 4096); the SiLU of the
    gate, (8, 13696), and every other table at (8, 3072) f32, bit for bit
    against the walk of the prefix search; the MMU at a decode step's
    projections (q/o, k/v, gate/up, down, head) and at the longest prompt's
    prefill (120 rows: gate/up, down, head)."""
    import torch.nn.functional as F
    row = functools.partial(row, cell="glm4")
    gam = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    rms = getattr(F, "rms_norm", None)
    for m in (8, 1024):
        x = (torch.randn(m, 4096, generator=g, device=dev) * 2).to(torch.bfloat16)
        gam_t = gam.to(torch.bfloat16)
        row("nvu_layernorm", f"({m}, 4096) rms_only", torch.bfloat16,
            lambda: ln_mod.nvu_layernorm(x, gam, None, eps=1e-6, rms_only=True),
            lambda: ln_mod.nvu_layernorm_plain(x, gam, None, eps=1e-6, rms_only=True),
            x.numel() * 2 * x.element_size() + 4096 * 4,
            # square-add, two multiplies; one PWL a row
            [(x.numel() * 4 + x.shape[0] * (pwl_ops("rsqrt") + 8), F32_OPS_PER_S)],
            yardstick_fn=(lambda: rms(x, (4096,), gam_t, eps=1e-6)) if rms else None,
            yardstick_name="F.rms_norm" if rms else None)
    tables = [("silu", 13696, torch.bfloat16)] + [
        (n, 3072, torch.float32) for n in sorted(_FUNCS) if n not in ("silu", "gelu")]
    for name, n, dt in tables:
        if name in ("recip", "rsqrt", "sqrt"):          # mantissas in [0.25, 1)
            x = (0.25 + 0.75 * torch.rand(8, n, generator=g, device=dev)).to(dt)
        else:
            x = (torch.randn(8, n, generator=g, device=dev) * 4).to(dt)
        tab = pe_mod.device_table(name, 16, dev)
        row("pwl_eval", f"(8, {n}) {name}", dt,
            lambda: pe_mod.pwl_eval(x, name),
            lambda: pe_mod.pwl_eval_plain(x, get_table(name, 16)),
            x.numel() * 2 * x.element_size(),
            [(x.numel() * pwl_prefix_ops(name), F32_OPS_PER_S)],
            walk_fn=lambda: pe_mod.pwl_eval_walk(x, tab).to(x.dtype),
            yardstick_fn=(lambda: F.silu(x)) if name == "silu" else None,
            yardstick_name="F.silu" if name == "silu" else None)
    products = [(8, k, n) for k, n in GLM4_PRODUCTS] + [
        (GLM4_PREFILL_ROWS, k, n) for k, n in GLM4_PRODUCTS[2:]]
    for m, k, n in products:
        xq = quantize(torch.randn(m, k, generator=g, device=dev), 8)
        wq = quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, 8, axis=1)
        a, b = xq.q.contiguous(), wq.q.contiguous()
        lib_a = torch.cat([a, a.new_zeros(32 - m, k)]) if m < 32 else a  # _int_mm: M > 16
        row("quant_matmul", f"({m}, {k}) @ ({k}, {n})", torch.bfloat16,
            lambda: qm_mod.quant_matmul(a, b, xq.scale, wq.scale, out_dtype=torch.bfloat16),
            lambda: qm_mod.quant_matmul_plain(a, b, xq.scale, wq.scale, None, torch.bfloat16),
            m * k + k * n + 4 + 4 * n + m * n * 2, [(2 * m * n * k, INT8_OPS_PER_S)],
            library_fn=lambda: torch._int_mm(lib_a, b),
            library_name="torch._int_mm" + (", rows zero-padded to 32" if m < 32 else ""))
        del xq, wq, a, b, lib_a


def visible_pairs(sq: int, kv_len: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, for one head."""
    n = 0
    for i in range(sq):
        p = kv_len - sq + i
        hi = p if causal else kv_len - 1
        lo = max(0, p - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


# flash rows: (name, b, hq, hkv, sq, skv, kv_len, causal, window, block_q,
# block_kv, PWL settings); operands bf16, as the decode path hands them over
FLASH_ROWS = [
    ("decode", 8, 12, 12, 1, 256, 192, True, 0, 256, 256, (True, False)),
    ("prefill", 1, 12, 12, 128, 256, 128, True, 0, 256, 256, (True, False)),
    ("several blocks", 2, 12, 12, 64, 512, 512, True, 0, 64, 256, (True, False)),
    ("gqa window", 2, 8, 2, 64, 256, 256, True, 48, 64, 64, (True,)),
]


def flash_rows(dev, g, row):
    """The flash kernel at the decode path's shapes: q (B, Hq, Sq, 64) and a
    (B, Hkv, max_seq, 64) cache, bf16 permuted views of (B, S, H, D) memory,
    bf16 out.  Bytes: q, the kv_len visible cache rows of k and v, and the
    output, once each.  Operations: for each visible (query, key) pair the
    4 x 64 of its Q.K^T and P.V products, at the bf16 tensor-core rate, and
    its exp (PWL: the table walk), mask, max, subtract and sum at the f32
    rate.  The decode rows are timed once more with the L2 flushed before
    each launch, as a decode step finds the cache of the next layer."""
    import torch.nn.functional as F
    for name, b, hq, hkv, sq, skv, kv_len, causal, window, bq, bkv, pwls in FLASH_ROWS:
        d = 64
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        pairs = b * hq * visible_pairs(sq, kv_len, causal, window)
        nbytes = 2 * (q.numel() + 2 * b * hkv * kv_len * d + q.numel())
        mask = fa_mod.dense_mask(sq, kv_len, causal, window, dev)
        kk, vv = k[:, :, :kv_len], v[:, :, :kv_len]
        for use_pwl in pwls:
            kw = dict(causal=causal, window=window, use_pwl=use_pwl, block_q=bq,
                      block_kv=bkv, kv_len=kv_len, out_dtype=torch.bfloat16)
            exp_ops = pwl_ops("exp") + 2 if use_pwl else 1
            lib = None
            if not use_pwl:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, kk, vv, attn_mask=mask, enable_gqa=hq != hkv)
            for cold in (False, True) if name == "decode" else (False,):
                row("flash_attention",
                    f"{name} ({b}, {hq}, {sq}, {d}) kv {kv_len}/{skv}" + (" pwl" if use_pwl else "")
                    + (" cold L2" if cold else ""),
                    torch.bfloat16,
                    lambda: fa_mod.flash_attention(q, k, v, **kw),
                    lambda: fa_mod.flash_attention_plain(q, k, v, **kw),
                    nbytes, [(pairs * 4 * d, BF16_OPS_PER_S), (pairs * (exp_ops + 4), F32_OPS_PER_S)],
                    library_fn=lib, library_name="scaled_dot_product_attention", cold=cold)


# dense rows: (name, b, hq, hkv, sq, skv, kv_len, d, cell); the decode
# path's shapes, bf16 q, cache and output, PWL and exact exp: BERT-base's
# (cell None), and GLM4-9B's (32 query heads over 2 kv heads, head dim 128)
DENSE_ROWS = [
    ("dense decode", 8, 12, 12, 1, 256, 256, 64, None),
    ("dense decode", 8, 12, 12, 1, 1024, 1024, 64, None),
    ("dense decode", 8, 12, 12, 1, 2048, 2048, 64, None),
    ("dense decode", 8, 12, 12, 1, 16384, 16384, 64, None),
    ("dense prefill", 1, 12, 12, 128, 256, 128, 64, None),
    ("dense decode", 8, 32, 2, 1, 256, 256, 128, "glm4"),
    ("dense prefill", 1, 32, 2, 128, 256, 128, 128, "glm4"),
]


def heads(hq: int, hkv: int) -> str:
    """A row's head count: `12`, or `32 over 2` under grouped-query attention."""
    return str(hq) if hq == hkv else f"{hq} over {hkv}"


def say_split(b, hq, hkv, sq, kv_len, d, window=0):
    """Print how the dense mode's decode instance splits a row's cache, as
    its launch computes it on this card, for a row it takes."""
    cs = fa_mod.dense_decode_cluster(b, hq, hkv, sq, kv_len, window, d)
    if cs:
        rows = hq // hkv * sq
        say(f"    decode instance: {min(r for r in (1, 2, 4, 8) if r >= rows)} rows, "
            f"a cluster of {cs} blocks a (batch, kv head)")


def dense_rows(dev, g, row):
    """The flash kernel's dense mode (the decode path's attention) at a decode
    step over 256, 1024 and 2048 keys (one pass) and 16384 keys (two
    segments of 8192: three passes over K), and a 128-token prefill.  Bytes
    as for `flash_rows` (each input read once, whatever the passes read
    again); operations: the Q.K^T and P.V products at the bf16 tensor-core
    rate and each visible pair's CUDA-core chain (`dense_chain_instr`) at
    F32_INSTR_PER_S.  The decode rows are timed once more with the L2
    flushed before each launch."""
    import torch.nn.functional as F
    for name, b, hq, hkv, sq, skv, kv_len, d, cell in DENSE_ROWS:
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        pairs = b * hq * visible_pairs(sq, kv_len, True, 0)
        nbytes = 2 * (q.numel() + 2 * b * hkv * kv_len * d + q.numel())
        mask = fa_mod.dense_mask(sq, kv_len, True, 0, dev)
        kk, vv = k[:, :, :kv_len], v[:, :, :kv_len]
        say_split(b, hq, hkv, sq, kv_len, d)
        for use_pwl in (True, False):
            kw = dict(kv_len=kv_len, use_pwl=use_pwl, out_dtype=torch.bfloat16)
            lib = None
            if not use_pwl:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, kk, vv, attn_mask=mask, enable_gqa=hq != hkv)
            for cold in (False, True) if name == "dense decode" else (False,):
                row("flash_attention",
                    f"{name} ({b}, {heads(hq, hkv)}, {sq}, {d}) kv {kv_len}/{skv}"
                    + (" pwl" if use_pwl else "") + (" cold L2" if cold else ""),
                    torch.bfloat16,
                    lambda: fa_mod.dense_attention(q, k, v, **kw),
                    lambda: fa_mod.dense_attention_plain(q, k, v, **kw),
                    nbytes, [(pairs * 4 * d, BF16_OPS_PER_S),
                             (pairs * dense_chain_instr(use_pwl, 0.0), F32_INSTR_PER_S)],
                    library_fn=lib, library_name="scaled_dot_product_attention", cold=cold,
                    check_fn=lambda got: dense_compare(q, k, v, kw, got), cell=cell)


# dense rows of the windowed and MoE slice: (name, b, hq, hkv, sq, skv, kv_len,
# d, cell, causal, window, softcap): Gemma3-27B's 1024-row ring with every row
# valid and with 300 before the wrap (causality off over kv_len keys), its
# windowed 2048-token prefill, a soft-capped step (the cap no config sets),
# and StarCoder2-3B's 12:1 ring of 4096 rows; then Hymba-1.5B's 5:1 step over a
# 32-row ring, Granite's 2:1 step over 1024 keys, Whisper-base's cross step
# over the 1500 encoder rows (causality off) and its causal encoder over 1500
# frames
MASK_ROWS = [
    ("ring decode", 8, 32, 16, 1, 1024, 1024, 128, "gemma3", False, 0, 0.0),
    ("ring decode", 8, 32, 16, 1, 1024, 300, 128, "gemma3", False, 0, 0.0),
    ("windowed prefill", 1, 32, 16, 2048, 2048, 2048, 128, "gemma3", True, 1024, 0.0),
    ("soft-capped decode", 8, 32, 16, 1, 1024, 1024, 128, "gemma3", True, 0, 50.0),
    ("ring decode", 8, 24, 2, 1, 4096, 4096, 128, "starcoder2", False, 0, 0.0),
    ("ring decode", 8, 25, 5, 1, 32, 32, 64, "hymba", False, 0, 0.0),
    ("decode", 8, 16, 8, 1, 1024, 1024, 64, "granite", True, 0, 0.0),
    ("cross decode", 8, 8, 8, 1, 1500, 1500, 64, "whisper", False, 0, 0.0),
    ("encoder", 8, 8, 8, 1500, 1500, 1500, 64, "whisper", True, 0, 0.0),
    # the train step's forward (and its remat) at [16]'s shapes, with the row
    # statistics the backward reads
    ("training forward", 4, 24, 2, 1024, 1024, 1024, 128, "starcoder2", True, 4096, 0.0),
    ("training forward", 4, 16, 8, 1024, 1024, 1024, 64, "granite", True, 0, 0.0),
]


def mask_rows(dev, row):
    """The dense mode's window, causal switch and soft cap (MASK_ROWS), PWL
    and exact, each held to `dense_attention_plain` on the same inputs with
    the dense gate (the training rows with their row statistics, as the
    train step's forward asks for them); bytes and operations as for
    `dense_rows` over the keys the mask lets through, the soft cap's steps
    in the chain.  The library call is
    `scaled_dot_product_attention` with the same mask, beside the exact
    rows without a cap (it has no soft cap).  A generator of its own keeps
    the other rows' inputs as they were."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(5)
    for name, b, hq, hkv, sq, skv, kv_len, d, cell, causal, window, cap in MASK_ROWS:
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(torch.bfloat16).permute(0, 2, 1, 3)
        if cap:
            q = q * 8                       # scores past the cap's knee
        pairs = b * hq * visible_pairs(sq, kv_len, causal, window)
        nbytes = 2 * (q.numel() + 2 * b * hkv * kv_len * d + q.numel())
        mask = fa_mod.dense_mask(sq, kv_len, causal, window, dev)
        kk, vv = k[:, :, :kv_len], v[:, :, :kv_len]
        if name != "training forward":
            say_split(b, hq, hkv, sq, kv_len, d, window)
        for use_pwl in (True, False):
            kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=cap,
                      use_pwl=use_pwl, out_dtype=torch.bfloat16)
            if name == "training forward":
                kw["with_stats"] = True
            lib = None
            if not use_pwl and not cap:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, kk, vv, attn_mask=mask, enable_gqa=hq != hkv)
            row("flash_attention",
                f"{name} ({b}, {heads(hq, hkv)}, {sq}, {d}) kv {kv_len}/{skv}"
                + ("" if causal else " causal off") + (f" window {window}" if window else "")
                + (f" cap {cap:g}" if cap else "") + (" pwl" if use_pwl else ""),
                torch.bfloat16,
                lambda: fa_mod.dense_attention(q, k, v, **kw),
                lambda: fa_mod.dense_attention_plain(q, k, v, **kw),
                nbytes, [(pairs * 4 * d, BF16_OPS_PER_S),
                         (pairs * dense_chain_instr(use_pwl, cap), F32_INSTR_PER_S)],
                library_fn=lib, library_name="scaled_dot_product_attention",
                check_fn=lambda got: dense_compare(q, k, v, kw, got), cell=cell,
                plain_reps=3 if name == "training forward" else 20)


# --- phase 4: full-width BERT-base ------------------------------------------

class Audit:
    """Wrap the kernel wrappers that the models call through `ops` so that
    every launch is also computed by its plain version on the same operands
    (the dense mode's launches count as flash_attention's, with or without
    gradients: `ops.dense_attention_kernel` is what `ops.dense_attention`
    and its autograd Function launch; the blocked mode serves no model)."""

    NAMES = ("pwl_eval", "quant_matmul", "nvu_softmax", "nvu_layernorm", "flash_attention")

    def __init__(self):
        self.stats = {k: [0, 0.0, True] for k in self.NAMES}
        self.saved = {}

    def counts(self):
        return every_kernel({k: st[0] for k, st in self.stats.items()})

    def _check(self, name, got, want, dtype):
        atol, rtol = TOLS[(name, dtype)]
        err, ok = compare(got, want, atol, rtol)
        st = self.stats[name]
        st[0] += 1
        st[1] = max(st[1], err)
        st[2] = st[2] and ok

    def __enter__(self):
        def pwl(x, name, segments=16):
            y = pe_mod.pwl_eval(x, name, segments)
            self._check("pwl_eval", y, pe_mod.pwl_eval_plain(x, get_table(name, segments)), x.dtype)
            return y

        def qm(xq, wq, xs, ws, activation=None, segments=16, out_dtype=torch.float32):
            y = qm_mod.quant_matmul(xq, wq, xs, ws, activation, segments, out_dtype)
            t = get_table(activation, segments) if activation else None
            self._check("quant_matmul", y,
                        qm_mod.quant_matmul_plain(xq, wq, xs, ws, t, out_dtype), out_dtype)
            return y

        def sm(x, segments=16, causal_rows=0, scale=1.0, out_dtype=None, limit=None):
            y = sm_mod.nvu_softmax(x, segments, causal_rows, scale, out_dtype, limit)
            self._check("nvu_softmax", y, sm_mod.nvu_softmax_plain(
                x, segments, causal_rows, scale, out_dtype, limit), y.dtype)
            return y

        def ln(x, gamma, beta, eps=1e-5, segments=16, rms_only=False):
            y = ln_mod.nvu_layernorm(x, gamma, beta, eps, segments, rms_only)
            self._check("nvu_layernorm", y, ln_mod.nvu_layernorm_plain(
                x, gamma, beta, eps, segments, rms_only), x.dtype)
            return y

        def dense(q, k, v, **kw):
            y = fa_mod.dense_attention(q, k, v, **kw)
            out = y[0] if isinstance(y, tuple) else y
            with torch.no_grad():
                err, ok = dense_compare(q, k, v, dict(kw, out_dtype=out.dtype), y)
            st = self.stats["flash_attention"]
            st[0] += 1
            st[1] = max(st[1], err)
            st[2] = st[2] and ok
            return y

        for attr, fn in [("pwl_eval", pwl), ("quant_matmul", qm),
                         ("nvu_softmax", sm), ("nvu_layernorm", ln),
                         ("dense_attention_kernel", dense)]:
            self.saved[attr] = getattr(ops, attr)
            setattr(ops, attr, fn)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(ops, attr, fn)


class SeparateScaleAndCast:
    """The encoder's NPE softmax with the score scale and the cast to bf16 as
    torch ops around an f32 launch, as the encoder computed them before the
    kernel took both: the same f32 multiply and the same rounding, two more
    launches a layer."""

    def __enter__(self):
        self.folded = ops.softmax

        def separate(x, segments=16, causal=False, scale=1.0, out_dtype=None):
            return self.folded(x * scale, segments, causal).to(out_dtype or x.dtype)

        ops.softmax = separate
        return self

    def __exit__(self, *exc):
        ops.softmax = self.folded


def blocked_attention_over_cache(cfg, q, cache_k, cache_v, pos):
    """The decode path's attention through the blocked flash route (KV blocks
    of min(256, max_seq), a running rescale, probabilities kept f32 in P.V),
    which the dense mode replaced: kept to show what the agreement was."""
    out = ops.flash_attention(q.permute(0, 2, 1, 3), cache_k.permute(0, 2, 1, 3),
                              cache_v.permute(0, 2, 1, 3), causal=True,
                              use_pwl=cfg.npe_pwl, segments=cfg.npe_pwl_segments,
                              kv_len=pos + q.shape[1], out_dtype=cache_v.dtype)
    return out.permute(0, 2, 1, 3)


class BlockedAttention:
    """Route the decode path's attention through `blocked_attention_over_cache`."""

    def __enter__(self):
        self.dense = cm_mod.attention_over_cache
        cm_mod.attention_over_cache = blocked_attention_over_cache
        return self

    def __exit__(self, *exc):
        cm_mod.attention_over_cache = self.dense


def device_launches(fn) -> int:
    """Kernels and copies the card ran in one call of fn, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(n for _, _, n in _kernel_times(prof, with_counts=True))


def nudge(model, toward: float = float("inf"), dtype=torch.float32):
    """A float32 copy of `model` on the CPU with every weight moved by one
    ulp of `dtype` (the value next to its `dtype` rounding), up (or toward
    `toward`)."""
    other = registry.build_model(model.cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(), other.named_parameters()):
            c = p.to(dtype)
            q.copy_(torch.nextafter(c, torch.full_like(c, toward)))
    return other


def route_check(dev, results):
    """The kernel route on the card against the port's plain route on the CPU,
    full width cut to 2 layers, float32, 2 x 128 tokens."""
    cfg = dataclasses.replace(get_config("bert_base"), num_layers=2, dtype="float32")
    cpu_model = Bert(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    card_model = Bert(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    noisy = nudge(cpu_model)
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=SEQ, seed=2)
    tok = BertServer(cfg, seq=SEQ, device="cpu", model=cpu_model).tokens(
        [reqs.request(i) for i in range(2)])
    out = {}
    for mode in ("float", "npe-16bit", "npe-8bit"):
        c = MODES[mode](cfg)
        want = bert.apply(c, cpu_model, tok)
        got = bert.apply(c, card_model, tok.to(dev)).cpu()
        err = float((got - want).abs().max())
        top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        if mode == "npe-8bit":
            ref2 = bert.apply(c, noisy, tok)
            noise = float((ref2 - want).abs().max())
            noise_top1 = float((ref2.argmax(-1) == want.argmax(-1)).float().mean())
            gate = max(NOISE_FACTOR * noise, NPE16_TOL)
            gate_top1 = noise_top1 - TOP1_MARGIN
        else:
            noise = noise_top1 = None
            gate, gate_top1 = (FLOAT_TOL if mode == "float" else NPE16_TOL), 0.99
        ok = err <= gate and top1 >= gate_top1 and bool(torch.isfinite(got).all())
        out[mode] = dict(max_abs=err, top1=top1, gate=gate, gate_top1=gate_top1,
                         noise_max_abs=noise, noise_top1=noise_top1, ok=ok)
        say(f"  {mode:10s} card kernels vs CPU plain route (float32, 2 layers): "
            f"max-abs {err:.3e} (gate {gate:.3e}), top-1 {top1:.4f} (gate {gate_top1:.4f})"
            + (f"; CPU plain route under 1-ulp weights: max-abs {noise:.3e}, "
               f"top-1 {noise_top1:.4f}" if noise is not None else "")
            + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"{mode}: the kernel route disagrees with the plain route")
    results["route_check"] = out


def profile_call(fn, host_ms):
    """Device busy ms, idle share against `host_ms`, the number of kernels
    by name, the 12 largest and the device launches (kernels and copies) of
    one more call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = sorted(((k[:90], us / 1e3) for k, us in _kernel_times(prof)),
                       key=lambda t: -t[1])
    busy = sum(ms for _, ms in by_kernel)
    return dict(host_ms=host_ms, device_busy_ms=busy,
                idle_share=(1 - busy / host_ms) if busy > 0 else None,
                kernels=len(by_kernel), top=by_kernel[:12],
                device_launches=sum(n for _, _, n in _kernel_times(prof, with_counts=True)))


def profile_forward(server, work, reps: int = 5):
    """Host ms of one forward (median of `reps`, no profiler), and the device
    busy ms and kernels of one more forward under torch.profiler."""
    server.answer(work)
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        server.answer(work)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    prof = profile_call(lambda: server.answer(work), sorted(host)[reps // 2])
    return dict(prof, host_ms_runs=host)


def serve_phase(dev, card, results):
    cfg = get_config("bert_base")
    say(f"  bert_base L={cfg.num_layers} D={cfg.d_model} H={cfg.num_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}, {BATCHES} batches of "
        f"{BATCH} x {SEQ}")
    timed, servers, work = serve(BATCH, SEQ, BATCHES, seed=0, device=dev)
    serve_out = {}
    for mode, (ms, agree) in timed.items():
        logits, _ = servers[mode].answer(work[0])
        if logits.shape != (BATCH, SEQ, cfg.vocab_size) or not bool(
                torch.isfinite(logits.float()).all()):
            raise SystemExit(f"{mode}: logits of shape {tuple(logits.shape)} "
                             "or not finite")
        serve_out[mode] = dict(ms_per_batch=ms, agreement=agree)
        say(f"  {mode:10s} {ms:9.3f} ms/batch on {card}, top-1 agreement vs float "
            f"{agree:.4f}")
    results["serve"] = serve_out

    # the main path: one NPE-8 forward, its launches counted
    reset_launches()
    servers["npe-8bit"].answer(work[0])
    torch.cuda.synchronize()
    counts = launches()
    results["launches"] = counts
    say(f"  launches of one NPE-8 forward: {counts} (expected {EXPECTED_LAUNCHES})")
    if {k: counts[k] for k in EXPECTED_LAUNCHES} != EXPECTED_LAUNCHES:
        raise SystemExit("launch counts of the NPE-8 forward differ from expected")

    with Audit() as audit:
        servers["npe-8bit"].answer(work[0])
        torch.cuda.synchronize()
    results["audit"] = {k: dict(launches=n, max_abs_err=e, ok=ok)
                        for k, (n, e, ok) in audit.stats.items()}
    say("  one NPE-8 forward, every launch vs its plain version on its operands: " +
        ", ".join(f"{k} {n} launches max-abs {e:.2e} {'ok' if ok else 'FAIL'}"
                  for k, (n, e, ok) in audit.stats.items()))
    if any(not ok for _, _, ok in audit.stats.values()) or \
            audit.counts() != EXPECTED_LAUNCHES:
        raise SystemExit("a launch of the NPE-8 forward disagrees with its plain version")

    # the scale and the cast folded into nvu_softmax: the same logits, fewer launches
    npe8 = servers["npe-8bit"]
    folded = npe8.answer(work[0])[0]
    with SeparateScaleAndCast():
        separate = npe8.answer(work[0])[0]
        n_sep = device_launches(lambda: npe8.answer(work[0]))
    n_fold = device_launches(lambda: npe8.answer(work[0]))
    same = torch.equal(folded, separate)
    results["softmax_fold"] = dict(bit_for_bit=same, device_launches_separate=n_sep,
                                   device_launches_folded=n_fold, saved=n_sep - n_fold)
    say(f"  NPE-8 logits, scale and cast folded into nvu_softmax vs as torch ops around it: "
        f"{'bit for bit' if same else 'DIFFER'}; device launches of one forward "
        f"{n_sep} -> {n_fold} ({n_sep - n_fold} torch launches saved, torch.profiler)")
    if not same:
        raise SystemExit("folding the scale and the cast into nvu_softmax changed the logits")

    prof = profile_forward(servers["npe-8bit"], work[0])
    results["profile"] = prof
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    say(f"  one NPE-8 forward: {prof['host_ms']:.3f} ms host clock (median of "
        f"{len(prof['host_ms_runs'])}), {prof['device_busy_ms']:.3f} ms device busy "
        f"(torch.profiler), idle share {idle}; device ms by kernel:")
    for name, ms in prof["top"]:
        say(f"      {ms:8.4f}  {name}")


# --- phase 5: KV-cache decode serving --------------------------------------

def decode_prompts(vocab: int, seed: int = 1, n: int = SLOTS):
    reqs = SyntheticRequests(vocab, max_prompt=MAX_PROMPT, seed=seed)
    return [reqs.request(i) for i in range(n)]


def counted(fn):
    """The kernel launches of fn(), counted from 0."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return launches(), out


def teacher_forced(server, prompts, feed, cache=None):
    """Greedy tokens of `server` fed `feed` (B, n): prefill every slot, then
    step i takes the feed's token i-1 (the first re-feeds the last prompt
    token, as `generate` does).  A given `cache`, the one the same server's
    prefills left, takes the place of the prefills."""
    if cache is not None:
        server.cache = cache
    else:
        server.cache = registry.init_cache(server.cfg, server.batch, server.max_seq,
                                           server.device)
        for slot, p in enumerate(prompts):
            server.prefill_prompt(slot, p)
    start = max(len(p) for p in prompts)
    cur = torch.tensor([[int(p[-1])] for p in prompts], device=server.device)
    out = []
    for i in range(feed.shape[1]):
        nxt, server.cache = server.decode(server.model, server.cache, cur, start + i)
        out.append(nxt)
        cur = torch.as_tensor(feed[:, i:i + 1], device=server.device)
    return torch.cat(out, 1).cpu().numpy()


def decode_phase(dev, card, results):
    cfg = get_config("bert_base")
    prompts = decode_prompts(cfg.vocab_size)
    start = max(len(p) for p in prompts)
    say(f"  bert_base L={cfg.num_layers} D={cfg.d_model} V={cfg.vocab_size} {cfg.dtype}, "
        f"{SLOTS} slots, prompts of {[len(p) for p in prompts]} tokens, {GEN} steps "
        f"from position {start}, cache of {MAX_SEQ} rows")
    servers, out, model = {}, {}, None
    for mode in MODES:
        srv = servers[mode] = Server("bert_base", batch=SLOTS, max_seq=MAX_SEQ, mode=mode,
                                     device=dev, model=model, seed=0)
        model = srv.model
        srv.generate(prompts, gen_tokens=2)                 # warm-up
        srv.cache = registry.init_cache(srv.cfg, SLOTS, MAX_SEQ, dev)
        counts, stats = counted(lambda: srv.generate(prompts, gen_tokens=GEN))
        rep = stats.report()
        toks = stats.generated
        if toks.shape != (SLOTS, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"{mode}: generated tokens of shape {toks.shape} or out of range")
        # one more step, its launches counted and its logits checked
        cur = torch.as_tensor(toks[:, -1:], device=dev)
        step, (logits, _) = counted(lambda: registry.decode_step(
            srv.cfg, srv.model, srv.cache, cur, start + GEN))
        if logits.shape != (SLOTS, 1, cfg.vocab_size) or not bool(
                torch.isfinite(logits.float()).all()):
            raise SystemExit(f"{mode}: step logits of shape {tuple(logits.shape)} or not finite")
        prefill, _ = counted(lambda: srv.prefill_prompt(0, prompts[0]))
        out[mode] = dict(rep, generated=toks.tolist(), run_launches=counts,
                         step_launches=step, prefill_launches=prefill, step_ms=stats.step_ms)
        say(f"  {mode:10s} prefill {rep['prefill_ms_per_slot']:8.3f} ms per slot, decode "
            f"{rep['decode_ms_per_step']:8.3f} ms per step (median of {GEN}), "
            f"{rep['tokens_per_sec']:9.1f} tokens/s, on {card}")
        say(f"             launches of one step {step}, of one one-slot prefill {prefill}")
        want = DECODE_LAUNCHES[mode]
        if step != want or prefill != want:
            raise SystemExit(f"{mode}: launches of a step or a prefill differ from {want}")
        runs = len(prompts) + GEN
        if counts != {k: n * runs for k, n in want.items()}:
            raise SystemExit(f"{mode}: launches of the served run {counts} differ from "
                             f"{runs} x {want}")
    results["decode"] = out
    results["decode_launches"] = out["npe-8bit"]["run_launches"]

    npe8 = servers["npe-8bit"]
    cur = torch.as_tensor(np.asarray(out["npe-8bit"]["generated"])[:, -1:], device=dev)
    with Audit() as audit:
        registry.decode_step(npe8.cfg, npe8.model, npe8.cache, cur, start + GEN)
        torch.cuda.synchronize()
    results["decode_audit"] = {k: dict(launches=n, max_abs_err=e, ok=ok)
                               for k, (n, e, ok) in audit.stats.items()}
    say("  one NPE-8 decode step, every launch vs its plain version on its operands: " +
        ", ".join(f"{k} {n} launches max-abs {e:.2e} {'ok' if ok else 'FAIL'}"
                  for k, (n, e, ok) in audit.stats.items()))
    if any(not ok for _, _, ok in audit.stats.values()) or \
            audit.counts() != DECODE_LAUNCHES["npe-8bit"]:
        raise SystemExit("a launch of the NPE-8 decode step disagrees with its plain version")

    prof = results["decode_profile"] = profile_call(
        lambda: registry.decode_step(npe8.cfg, npe8.model, npe8.cache, cur, start + GEN),
        out["npe-8bit"]["decode_ms_per_step"])
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    say(f"  one NPE-8 decode step: {prof['host_ms']:.3f} ms host clock (median of the served "
        f"run), {prof['device_busy_ms']:.3f} ms device busy (torch.profiler), idle share "
        f"{idle}; device ms by kernel:")
    for name, ms in prof["top"]:
        say(f"      {ms:8.4f}  {name}")

    feed = np.asarray(out["float"]["generated"])
    agree = {}
    for mode, srv in servers.items():
        agree[mode] = float((teacher_forced(srv, prompts, feed) == feed).mean())
    results["decode_agreement"] = agree
    say("  top-1 agreement with the float route's tokens, every mode fed them: " +
        ", ".join(f"{m} {a:.4f}" for m, a in agree.items()))
    with BlockedAttention():   # the same, through the blocked route
        fl = servers["float"]
        fl.cache = registry.init_cache(fl.cfg, SLOTS, MAX_SEQ, dev)
        feed_b = fl.generate(prompts, gen_tokens=GEN).generated
        before = {mode: float((teacher_forced(srv, prompts, feed_b) == feed_b).mean())
                  for mode, srv in servers.items()}
    results["decode_agreement_blocked"] = before
    say("  the same through the blocked flash route (f32 probabilities), as before the "
        "dense mode: " + ", ".join(f"{m} {a:.4f}" for m, a in before.items()))


def route_setup(arch, over=None, long_run=True, prompt_lens=None, max_seq=MAX_SEQ, steps=4,
                **_):
    """The config, the runs {name: (prompts, rows)} and the fed tokens of a
    decode route check (`ROUTE_CHECKS`): `arch` at full width cut to 2
    layers (and `over`), float32 weights; prompts of up to 128 tokens (or of
    `prompt_lens`) over a `max_seq`-row cache and, with `long_run`, prompts
    of 1100 and 300 tokens over an 1152-row cache (past one 256-key block,
    and past the 1024 keys one pass of the dense mode holds); `steps` fed
    tokens."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32", **(over or {}))
    rng = np.random.default_rng(3)
    long_prompts = [rng.integers(0, cfg.vocab_size, n) for n in (1100, 300)]
    feed = rng.integers(0, cfg.vocab_size, (2, steps))
    short = (decode_prompts(cfg.vocab_size, seed=2, n=2) if prompt_lens is None
             else [rng.integers(0, cfg.vocab_size, n) for n in prompt_lens])
    runs = {"short": (short, max_seq)}
    if long_run:
        runs["long"] = (long_prompts, 1152)
    return cfg, runs, feed


def route_model(cfg):
    """The route checks' float32 weights, on the CPU, from seed 1."""
    return registry.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))


def route_run(c, model, device, prompts, max_seq, feed, cross):
    """The logits of a route check's run: the slots prefilled alone through
    the server's views (`slot_view`; one call where the cache is a `full`
    group alone, else one token a call), then the fed steps."""
    start = max(len(p) for p in prompts)
    cache = registry.init_cache(c, 2, max_seq, device)
    if cross is not None:
        cache["cross"] = {k: t.to(device) for k, t in cross.items()}
    logits = []
    for slot, p in enumerate(prompts):
        sub = slot_view(cache, slot)
        toks = torch.as_tensor(p, device=device).long()[None]
        if set(cache) != {"full"}:          # rings, states: one token a call
            for t in range(toks.shape[1]):
                logits.append(registry.decode_step(c, model, sub, toks[:, t:t + 1], t)[0][0])
        else:
            logits.append(registry.decode_step(c, model, sub, toks, 0)[0][0])
    cur = torch.tensor([[int(p[-1])] for p in prompts], device=device)
    for i in range(feed.shape[1]):
        lg, cache = registry.decode_step(c, model, cache, cur, start + i)
        logits.append(lg[:, -1])
        cur = torch.as_tensor(feed[:, i:i + 1], device=device)
    return torch.cat(logits).float().cpu()


def decode_route_cpu(arch, modes=("float", "npe-16bit", "npe-8bit"), **spec):
    """The CPU half of a decode route check (run by `CpuRoutes`): the plain
    route's logits in each run and mode, and their change under 1-ulp
    weights (max-abs, top-1 agreement).  An encoder-decoder's cross cache is
    the float plain route over 2 seeded frame batches, cast to bf16 and
    handed to the card's run too (the card's kernels take bf16 k and v only,
    so a float32 encoder runs here; `cross_cache_check` holds the card's
    encoder)."""
    cfg, runs, feed = route_setup(arch, **spec)
    model = route_model(cfg)
    noisy = nudge(model)
    cross = None
    if cfg.family == "encdec":
        cross = encdec_mod.init_cross_cache(cfg, model, seeded_frames(cfg, 2, "cpu"))
    out = {"cross": None if cross is None else {k: t.float().numpy() for k, t in cross.items()}}
    for name, (prompts, max_seq) in runs.items():
        for mode in modes:
            c = MODES[mode](cfg)
            want = route_run(c, model, "cpu", prompts, max_seq, feed, cross)
            ref2 = route_run(c, noisy, "cpu", prompts, max_seq, feed, cross)
            out[name, mode] = dict(
                want=want.numpy(), noise=float((ref2 - want).abs().max()),
                noise_top1=float((ref2.argmax(-1) == want.argmax(-1)).float().mean()))
    return out


def decode_route_check(dev, results, key):
    """The decode path's kernel route on the card against the port's plain
    route on the CPU (`decode_route_cpu`, computed beside the card's phases
    by `CpuRoutes`), as `ROUTE_CHECKS[key]` sets it up (`route_setup`): bf16
    cache, the slots prefilled alone, then the fed steps, in `modes`.
    `routed`: an MoE decoder, whose top-k routing is discrete, so that an
    ulp can send a token to another expert; its top-1 agreement is held, in
    every mode, to twice the plain route's own disagreement under 1-ulp
    weights plus TOP1_MARGIN (a float32 GLM4 or BERT is held to 0.99).
    `ties`: a row whose top-1 differs also passes where the plain route's
    top two logits are within twice the max-abs difference (a difference
    within the gate can swap them there): the last families' runs have 16
    rows of one-token calls, and a bf16 cache or probability that rounds
    the other way moves their float32 logits by up to 1e-2."""
    spec = ROUTE_CHECKS[key]
    arch, modes = spec["arch"], spec.get("modes", ("float", "npe-16bit", "npe-8bit"))
    routed, ties, steps = spec.get("routed", False), spec.get("ties", False), spec.get("steps", 4)
    cfg, runs, feed = route_setup(**spec)
    cpu, seconds = CPU_ROUTES.result(key)
    card_model = registry.build_model(cfg, device=dev)
    card_model.load_state_dict(route_model(cfg).state_dict())
    cross = cpu["cross"] and {k: torch.from_numpy(a).to(torch.bfloat16)
                              for k, a in cpu["cross"].items()}
    out = {}
    for name, (prompts, max_seq) in runs.items():
        for mode in modes:
            c = MODES[mode](cfg)
            plain = cpu[name, mode]
            want, noise, noise_top1 = (torch.from_numpy(plain["want"]), plain["noise"],
                                       plain["noise_top1"])
            got = route_run(c, card_model, dev, prompts, max_seq, feed, cross)
            err = float((got - want).abs().max())
            same = got.argmax(-1) == want.argmax(-1)
            if ties:
                top2 = want.topk(2, dim=-1).values
                same |= (top2[:, 0] - top2[:, 1]) <= 2 * err
            top1 = float(same.float().mean())
            gate = max(NOISE_FACTOR * noise, FLOAT_TOL if mode == "float" else NPE16_TOL)
            gate_top1 = min(noise_top1 - TOP1_MARGIN, 0.99) if mode == "npe-8bit" else 0.99
            if routed:
                gate_top1 = 1 - NOISE_FACTOR * (1 - noise_top1) - TOP1_MARGIN
            ok = err <= gate and top1 >= gate_top1 and bool(torch.isfinite(got).all())
            out[f"{name} {mode}"] = dict(max_abs=err, top1=top1, gate=gate, gate_top1=gate_top1,
                                         noise_max_abs=noise, noise_top1=noise_top1, ok=ok,
                                         prompts=[len(p) for p in prompts], max_seq=max_seq)
            say(f"  {mode:10s} {arch} decode, card kernels vs CPU plain route (float32, 2 layers, "
                f"prompts {[len(p) for p in prompts]}, {max_seq} rows, prefill + {steps} steps): "
                f"max-abs {err:.3e} (gate {gate:.3e}), top-1 {top1:.4f} (gate {gate_top1:.4f}"
                + (f"; {int((got.argmax(-1) != want.argmax(-1)).sum())} top-1 differ, near "
                   "ties (the top two within twice the max-abs) counting as agreeing"
                   if ties else "") + "); "
                f"CPU plain route under 1-ulp weights: max-abs {noise:.3e}, top-1 "
                f"{noise_top1:.4f}" + ("" if ok else "  FAIL"))
            if not ok:
                raise SystemExit(f"{arch} {name} {mode}: the decode kernel route disagrees "
                                 "with the plain route")
    del card_model
    results[key] = dict(out, cpu_seconds=seconds)
    say(f"  (the CPU half took {seconds:.1f} s beside the card's phases)")


# --- phase 6: the npec compiler and executor --------------------------------

# 4 steps keep the script within its budget (8 until [16], the decoders'
# training, joined it)
NPEC_T, NPEC_STEPS = 256, 4
NPEC_GATE = 1e-2            # the reference's gate for its executor (tests/test_npec.py:215-245)
NPEC_SLOTS_TOL = 5e-3       # NPE-8 8-slot vs per-sequence streams, if not bit for bit


def npec_kernel_rows(dev, floor_ms, rows):
    """The two kernel options the npec executor adds (phase [6]), at its
    shapes, timed in [3] with the other rows: the MMU
    with one activation scale a row, (8, 768) @ (768, 768) (a merged 8-slot
    projection) and @ (768, 64) (one head's columns), bit for bit against
    its plain version and, with every row's scale equal, against the
    per-tensor call; nvu_softmax with a key limit, (96, 256) (12 heads x 8
    slots of a decode step, a limit a row) and (12288, 128) causal by limit,
    bit for bit against its walk."""
    g = torch.Generator(device=dev).manual_seed(6)
    row = functools.partial(kernel_row, rows, floor_ms)
    m = SLOTS
    for k, n in ((768, 768), (768, 64)):
        x = torch.randn(m, k, generator=g, device=dev) * (1 + 3 * torch.rand(m, 1, generator=g,
                                                                              device=dev))
        xq = quantize(x, 8, axis=0)
        wq = quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, 8, axis=1)
        a, b = xq.q.contiguous(), wq.q.contiguous()
        lib_a = torch.cat([a, a.new_zeros(32 - m, k)])

        def plain():
            return qm_mod.quant_matmul_plain(a, b, xq.scale, wq.scale)

        row("quant_matmul", f"({m}, {k}) @ ({k}, {n}) row scales", torch.float32,
            lambda: qm_mod.quant_matmul(a, b, xq.scale, wq.scale), plain,
            m * k + k * n + 4 * m + 4 * n + 4 * m * n, [(2 * m * n * k, INT8_OPS_PER_S)],
            library_fn=lambda: torch._int_mm(lib_a, b),
            library_name="torch._int_mm, rows zero-padded to 32", walk_fn=plain,
            walk_name="plain")
        one = xq.scale.reshape(-1)[:1]
        same = torch.equal(qm_mod.quant_matmul(a, b, one.expand(m, 1).contiguous(), wq.scale),
                           qm_mod.quant_matmul(a, b, one, wq.scale))
        rows[-1]["equal_row_scales_bit_for_bit_per_tensor"] = same
        say(f"    every row's scale equal: {'bit for bit' if same else 'DIFFERS from'} the "
            "per-tensor call")
        if not same:
            raise SystemExit("quant_matmul with equal row scales differs from the per-tensor call")
    for r, n, what in ((96, 256, "limit a row (decode)"), (12288, 128, "causal by limit")):
        x = torch.randn(r, n, generator=g, device=dev) * 3
        if r == 12288:
            limit = (torch.arange(r, device=dev) % n + 1).to(torch.int32)
        else:
            limit = torch.randint(1, n + 1, (r,), generator=g, device=dev, dtype=torch.int32)
        ops_ = x.numel() * (pwl_prefix_ops("exp") + 7) + r * (pwl_ops("recip") + 6)
        row("nvu_softmax", f"({r}, {n}) {what}", torch.float32,
            lambda: sm_mod.nvu_softmax(x, limit=limit),
            lambda: sm_mod.nvu_softmax_plain(x, limit=limit),
            x.numel() * 8 + limit.numel() * 4, [(ops_, F32_OPS_PER_S)],
            walk_fn=lambda: sm_mod.nvu_softmax_walk(x, limit=limit),
            yardstick_fn=lambda: torch.softmax(x, dim=-1), yardstick_name="torch.softmax")


def npec_decoder_kernel_rows(dev, floor_ms, rows):
    """The executor's kernel options at the shapes phase [11] gives them
    (cell "npec_decoders"), timed in [3] with the other rows: the MMU with
    one activation scale a row (f32 out) at an 8-slot GLM4 step's merged
    q/o-class (8, 4096) @ (4096, 4096) and gate/up (8, 4096) @ (4096, 13696)
    products, bit for bit against its plain version; nvu_softmax with a key
    limit a row on (32, 256) rows (a decode step's rows over a 256-row bank),
    and without a limit on Granite's (120, 32) router rows (a 120-token
    prefill's softmax over 32 experts), bit for bit against its walk;
    nvu_layernorm rms_only and pwl_eval SiLU in f32 at (8, 4096) and
    (8, 13696), the executor's dtype."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(11)
    row = functools.partial(kernel_row, rows, floor_ms, cell="npec_decoders")
    m = SLOTS
    for k, n in ((4096, 4096), (4096, 13696)):
        x = torch.randn(m, k, generator=g, device=dev) * (1 + 3 * torch.rand(m, 1, generator=g,
                                                                              device=dev))
        xq = quantize(x, 8, axis=0)
        wq = quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, 8, axis=1)
        a, b = xq.q.contiguous(), wq.q.contiguous()
        lib_a = torch.cat([a, a.new_zeros(32 - m, k)])

        def plain():
            return qm_mod.quant_matmul_plain(a, b, xq.scale, wq.scale)

        row("quant_matmul", f"({m}, {k}) @ ({k}, {n}) row scales", torch.float32,
            lambda: qm_mod.quant_matmul(a, b, xq.scale, wq.scale), plain,
            m * k + k * n + 4 * m + 4 * n + 4 * m * n, [(2 * m * n * k, INT8_OPS_PER_S)],
            library_fn=lambda: torch._int_mm(lib_a, b),
            library_name="torch._int_mm, rows zero-padded to 32", walk_fn=plain,
            walk_name="plain")
        del x, xq, wq, a, b, lib_a
    for r, n, what in ((32, 256, "limit a row (decode)"), (120, 32, "router, no limit")):
        x = torch.randn(r, n, generator=g, device=dev) * 3
        limit = (torch.randint(1, n + 1, (r,), generator=g, device=dev, dtype=torch.int32)
                 if "limit" in what else None)
        ops_ = x.numel() * (pwl_prefix_ops("exp") + 7) + r * (pwl_ops("recip") + 6)
        row("nvu_softmax", f"({r}, {n}) {what}", torch.float32,
            lambda: sm_mod.nvu_softmax(x, limit=limit),
            lambda: sm_mod.nvu_softmax_plain(x, limit=limit),
            x.numel() * 8 + (limit.numel() * 4 if limit is not None else 0),
            [(ops_, F32_OPS_PER_S)],
            walk_fn=lambda: sm_mod.nvu_softmax_walk(x, limit=limit),
            yardstick_fn=lambda: torch.softmax(x, dim=-1), yardstick_name="torch.softmax")
    gam = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    x = torch.randn(m, 4096, generator=g, device=dev) * 2
    rms = getattr(F, "rms_norm", None)
    row("nvu_layernorm", f"({m}, 4096) rms_only", torch.float32,
        lambda: ln_mod.nvu_layernorm(x, gam, None, eps=1e-6, rms_only=True),
        lambda: ln_mod.nvu_layernorm_plain(x, gam, None, eps=1e-6, rms_only=True),
        x.numel() * 2 * 4 + 4096 * 4,
        [(x.numel() * 4 + m * (pwl_ops("rsqrt") + 8), F32_OPS_PER_S)],
        yardstick_fn=(lambda: rms(x, (4096,), gam, eps=1e-6)) if rms else None,
        yardstick_name="F.rms_norm" if rms else None)
    xs = torch.randn(m, 13696, generator=g, device=dev) * 4
    tab = pe_mod.device_table("silu", 16, dev)
    row("pwl_eval", f"({m}, 13696) silu", torch.float32,
        lambda: pe_mod.pwl_eval(xs, "silu"),
        lambda: pe_mod.pwl_eval_plain(xs, get_table("silu", 16)),
        xs.numel() * 2 * 4, [(xs.numel() * pwl_prefix_ops("silu"), F32_OPS_PER_S)],
        walk_fn=lambda: pe_mod.pwl_eval_walk(xs, tab),
        yardstick_fn=lambda: F.silu(xs), yardstick_name="F.silu")


def encode_layers(cfg, model: Bert, layers: int, tokens):
    """The port's BERT encoder cut to its first `layers` layers."""
    small = Bert(dataclasses.replace(cfg, num_layers=layers), device=tokens.device,
                 dtype=torch.float32)
    small.load_state_dict(model.state_dict(), strict=False)
    return bert.encode(small.cfg, small, tokens)


def timed(fn, reps: int = 3):
    """(result, median host ms) of `reps` calls of fn, each synchronized."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, sorted(times)[reps // 2]


def say_profile(what, prof):
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    say(f"             {what}: {prof['host_ms']:.1f} ms host, {prof['device_busy_ms']:.3f} ms "
        f"device busy (torch.profiler), idle share {idle}; largest: "
        + ", ".join(f"{name.split('(')[0][-40:]} {ms:.3f}" for name, ms in prof["top"][:4]))


def npec_encoder(dev, model, tree, nudged, tokens, results):
    """(b) `compile_model(bert_base, 128)` with embeddings through `execute`
    on [4]'s 8 x 128 tokens, in each mode, against the port's models/bert
    encoder (float32): float at full depth and NPE at 2 layers within the
    reference's 1e-2; NPE at full depth within twice the model's own change
    under a 1-ulp weight nudge on the same batch."""
    base = model.cfg
    out = {}
    for mode, mcfg in MODES.items():
        c = mcfg(base)
        bits = c.npe_quant_bits if c.npe_quant else 16
        compiled = npec.compile_model(base, SEQ, bits=bits)
        exec_ = lambda: npec.execute(compiled, tree, {"tokens": tokens}, cfg=c, device=dev)
        exec_()
        res, host_ms = timed(exec_)
        got = res[0]
        want = bert.encode(c, model, tokens)
        err = float((got - want).abs().max())
        r = dict(max_abs_full=err, host_ms=host_ms, peak_live_bytes=res.peak_live_bytes,
                 shape=list(got.shape), instrs=len(compiled.instrs),
                 counts_by_unit=compiled.counts_by_unit(),
                 greedy_cycles=npec.greedy_schedule(compiled)["total_cycles"],
                 streaming_cycles=npec.stream_schedule(compiled)["total_cycles"])
        finite = bool(torch.isfinite(got).all()) and tuple(got.shape) == (BATCH, SEQ, base.d_model)
        if c.npe_quant:
            small = npec.compile_model(dataclasses.replace(base, num_layers=2), SEQ, bits=bits)
            got2 = npec.execute(small, tree, {"tokens": tokens}, cfg=c, device=dev)[0]
            err2 = float((got2 - encode_layers(c, model, 2, tokens)).abs().max())
            noise = float((bert.encode(c, nudged, tokens) - want).abs().max())
            r.update(max_abs_2layers=err2, gate_2layers=NPEC_GATE, nudge_full=noise,
                     gate_full=NOISE_FACTOR * noise)
            ok = err2 <= NPEC_GATE and err <= NOISE_FACTOR * noise
            gates = (f"2 layers max-abs {err2:.3e} (gate {NPEC_GATE:g}); {base.num_layers} "
                     f"layers max-abs {err:.3e} (gate {NOISE_FACTOR:g} x the model's change "
                     f"under 1-ulp weights {noise:.3e})")
        else:
            r.update(gate_full=NPEC_GATE)
            ok = err <= NPEC_GATE
            gates = f"{base.num_layers} layers max-abs {err:.3e} (gate {NPEC_GATE:g})"
        r["ok"] = ok = ok and finite
        out[mode] = r
        say(f"  {mode:10s} encoder stream vs models/bert.encode (float32, {BATCH} x {SEQ}): {gates}; "
            f"{host_ms:.1f} ms host a forward (median of 3); {len(compiled.instrs)} overlay "
            f"instrs {r['counts_by_unit']}, overlay model cycles (200 MHz FPGA, not card time) "
            f"{r['greedy_cycles']:.0f} whole-op / {r['streaming_cycles']:.0f} tile-streaming"
            + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"npec encoder stream, {mode}: disagrees with models/bert")
        if mode == "npe-8bit":
            counts, _ = counted(exec_)
            want_n = every_kernel(npec.expected_launches(compiled.graph, npe_quant=True, bits=8,
                                                        use_pwl=True))
            r["launches"], r["expected_launches"] = counts, want_n
            say(f"             launches of one NPE-8 execute {counts} (from the graph {want_n})")
            r["profile"] = profile_call(exec_, host_ms)
            say_profile("one NPE-8 execute", r["profile"])
            if counts != want_n or any(counts[k] == 0 for k in NPEC_KERNELS):
                raise SystemExit("npec encoder stream: launches differ from the graph's")
    results["npec_encoder"] = out
    return out["npe-8bit"]["launches"]


NPEC_KERNELS = ("quant_matmul", "nvu_softmax", "nvu_layernorm", "pwl_eval")


def npec_decode(dev, model, tree, nudged_tree, results):
    """(c) 8 prompts of `SyntheticRequests(max_prompt=128)` seed 1 (as [5]),
    each prefilled by its own `compile_prefill` stream and loaded into the
    8-slot `compile_decode(bert_base, 256, batch=8)` stream by `load_slot`,
    then NPEC_STEPS steps: float greedy, NPE-8 and NPE-16 fed float's
    tokens.  The 8-slot stream is held against 8 per-sequence streams
    (batch=1) fed the same tokens from the same prefills."""
    base = model.cfg
    prompts = decode_prompts(base.vocab_size, n=SLOTS)
    dec = npec.compile_decode(base, NPEC_T, bits=8, batch=SLOTS)
    seq_prog = npec.compile_decode(base, NPEC_T, bits=8)
    pre = {n: npec.compile_prefill(base, n, bits=8) for n in sorted({len(p) for p in prompts})}

    def run_slots(c, tr, feed=None, keep=None):
        sess = npec.DecodeSession(dec, tr, cfg=c, device=dev)
        if keep is not None:
            keep.append(sess)
        kv, first = [], []
        for slot, p in enumerate(prompts):
            res = npec.execute(pre[len(p)], tr, {"tokens": p}, cfg=c, device=dev)
            sess.load_slot(slot, res.kv_exports, len(p))
            kv.append(res.kv_exports)
            first.append(res[0][-1])
        first = torch.stack(first)
        cur = first.argmax(-1) if feed is None else feed[:, 0]
        fed, logits, ms = [], [], []
        for i in range(NPEC_STEPS):
            toks = cur if feed is None else feed[:, i]
            fed.append(toks)
            t0 = time.perf_counter()
            out = sess.step(toks)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            logits.append(out)
            cur = out.argmax(-1)
        return dict(first=first, kv=kv, fed=torch.stack(fed, 1), logits=torch.stack(logits),
                    step_ms=ms)

    def run_sequences(c, tr, kv, feed):
        logits = []
        for slot, p in enumerate(prompts):
            sess = npec.DecodeSession(seq_prog, tr, cfg=c, device=dev)
            for name, rows in kv[slot].items():
                sess.caches[name][0, :len(p)] = rows
            sess.pos = len(p)
            logits.append(torch.stack([sess.step(feed[slot:slot + 1, i:i + 1])[0, 0]
                                       for i in range(NPEC_STEPS)]))
        return torch.stack(logits, 1)

    out, runs = {}, {}
    expected = {k: 0 for k in KERNELS}
    for p in prompts:
        for k, n in npec.expected_launches(pre[len(p)].graph, npe_quant=True, bits=8,
                                           use_pwl=True).items():
            expected[k] += n
    for k, n in npec.expected_launches(dec.graph, npe_quant=True, bits=8, use_pwl=True).items():
        expected[k] += NPEC_STEPS * n
    npe8_counts = None
    for mode, mcfg in MODES.items():
        c = mcfg(base)
        feed = None if mode == "float" else runs["float"]["fed"]
        if mode == "npe-8bit":
            kept = []
            npe8_counts, run = counted(lambda: run_slots(c, tree, feed, kept))
            sess, last = kept[0], run["fed"][:, -1]
            prof = profile_call(lambda: sess.step(last, active=np.zeros(SLOTS, bool)),
                                sorted(run["step_ms"])[NPEC_STEPS // 2])
        else:
            run = run_slots(c, tree, feed)
        runs[mode] = run
        fed = run["fed"]
        seq_logits = run_sequences(c, tree, run["kv"], fed)
        bit = torch.equal(seq_logits, run["logits"])
        err = float((seq_logits - run["logits"]).abs().max())
        if mode == "npe-8bit":
            gate, why = (0.0 if bit else NPEC_SLOTS_TOL), None
            if not bit:
                why = ("not bit for bit: the merged and the single-row streams reach the f32 "
                       "products of attention (QK^T, AV) through different cuBLAS calls, whose "
                       "order of addition can differ; the MMU rows are per-row scaled and exact")
        else:
            nud = run_slots(c, nudged_tree, fed)
            noise = max(float((nud["logits"] - run["logits"]).abs().max()),
                        float((nud["first"] - run["first"]).abs().max()))
            gate, why = NOISE_FACTOR * noise, None
        agree = float(torch.cat([run["first"].argmax(-1)[None], run["logits"].argmax(-1)]).eq(
            torch.cat([runs["float"]["first"].argmax(-1)[None],
                       runs["float"]["logits"].argmax(-1)])).float().mean())
        finite = bool(torch.isfinite(run["logits"]).all())
        ok = (bit or err <= gate) and finite
        step_ms = sorted(run["step_ms"])[NPEC_STEPS // 2]
        out[mode] = dict(bit_for_bit=bit, max_abs=err, gate=gate, why=why, agreement=agree,
                         host_ms_per_step=step_ms, step_ms=run["step_ms"], ok=ok,
                         tokens=fed.tolist())
        say(f"  {mode:10s} {SLOTS}-slot decode stream vs {SLOTS} per-sequence streams ({NPEC_STEPS} steps, "
            f"same tokens): {'bit for bit' if bit else f'max-abs {err:.3e} (gate {gate:.3e})'}"
            f"; top-1 agreement with float {agree:.4f}; {step_ms:.1f} ms host a step "
            f"(median of {NPEC_STEPS})" + ("" if ok else "  FAIL"))
        if why:
            say(f"             {why}")
        if mode == "npe-8bit":
            out[mode]["profile"] = prof
            say_profile("one more NPE-8 step", prof)
        if not ok:
            raise SystemExit(f"npec decode stream, {mode}: the 8-slot stream disagrees with "
                             "the per-sequence streams")
    say(f"  launches of the NPE-8 decode run ({SLOTS} prefills + {NPEC_STEPS} steps): {npe8_counts} "
        f"(from the graphs {expected})")
    if npe8_counts != expected:
        raise SystemExit("npec decode run: launches differ from the graphs'")
    results["npec_decode"] = dict(out, launches=npe8_counts, expected_launches=expected)
    return npe8_counts


def npec_phase(dev, results):
    """[6] The npec compiler and functional executor on the card: (a) its
    kernel options (held and timed in [3]), (b) the encoder stream, (c) the
    decode streams, at full width and depth (BERT-base, weights from [4]'s
    seed in float32)."""
    opts = [r for r in results["rows"] if r["cell"] is None
            and ("row scales" in r["shape"] or "limit" in r["shape"])]
    say("  (a) the executor's kernel options, held and timed in [3]: " + "; ".join(
        f"{r['kernel']} {r['shape']} {r['ms']:.4f} ms (bound {r['bound_ms']:.6f}, "
        f"{'bit for bit' if r['bit_exact_walk'] else 'DIFFERS'})" for r in opts))
    if len(opts) != 4 or not all(r["ok"] and r["bit_exact_walk"] for r in opts):
        raise SystemExit("npec kernel options missing or not bit for bit")
    base = dataclasses.replace(get_config("bert_base"), dtype="float32")
    model = Bert(base, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    nudged = nudge(model).to(dev)
    tree = npec.ParamTree(param_tree_from_model(model), dev)
    reqs = SyntheticRequests(base.vocab_size, max_prompt=SEQ, seed=1)
    tokens = BertServer(base, seq=SEQ, device=dev, model=model).tokens(
        [reqs.request(i) for i in range(BATCH)])
    say(f"  bert_base L={base.num_layers} D={base.d_model} V={base.vocab_size} float32 "
        f"weights; encoder batch {BATCH} x {SEQ}")
    enc = npec_encoder(dev, model, tree, nudged, tokens, results)
    nudged_tree = npec.ParamTree(param_tree_from_model(nudged), dev)
    dec = npec_decode(dev, model, tree, nudged_tree, results)
    results["npec_launches"] = {k: enc[k] + dec[k] for k in KERNELS}
    return base, tree


# --- phase 7: the npec serving runtime --------------------------------------

ENGINE = dict(slots=8, capacity=64, max_new_tokens=8)     # 8 tokens: the script's budget
ENGINE_REQUESTS, ENGINE_MAX_PROMPT, ENGINE_CHUNK = 12, 32, 16   # 12 on 8 slots: recycled
PROFILE_STEP = 4            # the engine step run under torch.profiler


def engine_requests(vocab: int):
    reqs = SyntheticRequests(vocab, max_prompt=ENGINE_MAX_PROMPT)
    return [(reqs.request(i), reqs.eos_id(i)) for i in range(ENGINE_REQUESTS)]


def _signature(a):
    return (tuple(a.shape), a.dtype) if torch.is_tensor(a) else a


def _kept(a):
    return a.clone() if torch.is_tensor(a) else a


@contextlib.contextmanager
def kept_kernel_calls():
    """Within: each kernel that `kernels/ops` launches keeps a copy of the
    inputs of its first call at each shape and option set, in the dict
    yielded, {signature: (kernel, args, kwargs)}."""
    from repro_torch.kernels import ops as ops_mod
    kept, saved = {}, {name: getattr(ops_mod, name) for name in NPEC_KERNELS}

    def keeper(name, fn):
        def call(*args, **kw):
            key = (name, *map(_signature, args), *sorted((k, _signature(v))
                                                          for k, v in kw.items()))
            if key not in kept:
                kept[key] = (name, [_kept(a) for a in args],
                             {k: _kept(v) for k, v in kw.items()})
            return fn(*args, **kw)
        return call

    try:
        for name, fn in saved.items():
            setattr(ops_mod, name, keeper(name, fn))
        yield kept
    finally:
        for name, fn in saved.items():
            setattr(ops_mod, name, fn)


def kernel_and_plain(name, args, kw):
    """(kernel's result, its plain version's, the result it must equal bit
    for bit or None) of one kept call: quant_matmul's plain version, the
    walks of nvu_softmax and pwl_eval, as [3] and [6] hold them."""
    if name == "quant_matmul":
        if len(args) != 4:
            raise SystemExit(f"npec engine: quant_matmul called with {len(args)} arguments")
        plain = qm_mod.quant_matmul_plain(*args, None, kw.get("out_dtype", torch.float32))
        return qm_mod.quant_matmul(*args, **kw), plain, plain
    if name == "nvu_softmax":
        return (sm_mod.nvu_softmax(*args, **kw), sm_mod.nvu_softmax_plain(*args, **kw),
                sm_mod.nvu_softmax_walk(*args, **kw))
    if name == "pwl_eval":
        x, fn, segments = args
        return (pe_mod.pwl_eval(x, fn, segments), pe_mod.pwl_eval_plain(x, get_table(fn, segments)),
                pe_mod.pwl_eval_walk(x, pe_mod.device_table(fn, segments, x.device)).to(x.dtype))
    return ln_mod.nvu_layernorm(*args, **kw), ln_mod.nvu_layernorm_plain(*args, **kw), None


def check_kept_calls(kept):
    """Each kept call of the engine's run once more through its kernel, on
    the same card inputs, against its plain version within TOLS, and bit for
    bit against quant_matmul's plain version and the softmax and PWL walks.
    A softmax under one key limit for all its rows (a decode step's slot
    and kv head) runs at every limit 1..n of its rows.  These launches are not counted."""
    out = {k: dict(shapes=[], calls=0, max_abs_err=0.0,
                   bit_for_bit=None if k == "nvu_layernorm" else True, ok=True)
           for k in NPEC_KERNELS}
    for name, args, kw in kept.values():
        cases = [args]
        if name == "nvu_softmax" and args[5] is not None and args[5].numel() == 1:
            cases = [args[:5] + [torch.full_like(args[5], n)]
                     for n in range(1, args[0].shape[1] + 1)]
        r = out[name]
        r["shapes"].append(" x ".join(str(tuple(a.shape)) for a in args[:2]
                                      if torch.is_tensor(a))
                           + ("" if name != "nvu_softmax" or args[5] is None
                              else f" limit {tuple(args[5].shape)}"))
        for a in cases:
            got, plain, exact = kernel_and_plain(name, a, kw)
            atol, rtol = TOLS[(name, got.dtype)]
            err, ok = compare(got, plain, atol, rtol)
            bit = exact is None or same_bits(got, exact)
            r["calls"] += 1
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if exact is not None:
                r["bit_for_bit"] &= bit
            r["ok"] &= ok and bit
    torch.cuda.synchronize()
    return out


def run_engine(base, tree, dev, *, npe, bits, prefill_chunk=None, profile_step=None):
    """Serve `engine_requests` through `NPEEngine` step by step: (stats,
    host ms of each step, whether each step admitted, profile of one step)."""
    from repro_torch.npec.runtime import NPEEngine
    eng = NPEEngine(base, slots=ENGINE["slots"], capacity=ENGINE["capacity"],
                    max_new_tokens=ENGINE["max_new_tokens"], bits=bits, npe=npe, params=tree,
                    device=dev, prefill_chunk=prefill_chunk)
    for prompt, eos in engine_requests(base.vocab_size):
        eng.submit(prompt, eos_id=eos)
    ms, admitted, prof = [], [], None
    torch.cuda.synchronize()
    while eng.queue or len(eng.pool):
        before = len(eng.stats.queue_wait.samples_ms)     # one sample an admission
        step = eng.step
        holder = {}

        def timed_step():
            t0 = time.perf_counter()
            holder["more"] = step()
            torch.cuda.synchronize()
            holder["ms"] = 1e3 * (time.perf_counter() - t0)

        if profile_step is not None and len(ms) == profile_step:
            prof = profile_call(timed_step, float("nan"))
        else:
            timed_step()
        more = holder["more"]
        ms.append(holder["ms"])
        admitted.append(len(eng.stats.queue_wait.samples_ms) != before)
        if not more:
            break
    eng.stats.total_cycles = eng.clock.cycles
    return eng, ms, admitted, prof


def engine_expected_launches(base, stats, decode_graph, bits):
    """Launches of an NPE-8 engine run from the graphs it ran: one prefill
    stream a request at its prompt's length, one decode stream a step."""
    total = {k: 0 for k in KERNELS}
    for r in stats.requests:
        g = npec.compile_prefill(base, len(r.prompt), bits=bits).graph
        for k, n in npec.expected_launches(g, npe_quant=True, bits=bits, use_pwl=True).items():
            total[k] += n
    for k, n in npec.expected_launches(decode_graph, npe_quant=True, bits=bits,
                                       use_pwl=True).items():
        total[k] += stats.decode_steps * n
    return total


def per_request_streams(base, tree, dev, cfg, stats, bits):
    """Each request's tokens from its own streams: `compile_prefill` at the
    prompt's length, loaded into `compile_decode(base, 64, batch=1)`, run
    greedily for as many tokens as the engine served it."""
    seq_prog = npec.compile_decode(base, ENGINE["capacity"], bits=bits)
    out = {}
    for r in stats.requests:
        res = npec.execute(npec.compile_prefill(base, len(r.prompt), bits=bits), tree,
                           {"tokens": r.prompt}, cfg=cfg, device=dev)
        sess = npec.DecodeSession(seq_prog, tree, cfg=cfg, device=dev)
        for name, rows in res.kv_exports.items():
            sess.caches[name][0, :len(r.prompt)] = rows
        sess.pos = len(r.prompt)
        toks = [int(res[0][-1].argmax())]
        while len(toks) < len(r.generated):
            toks.append(int(sess.step(torch.tensor([[toks[-1]]], device=dev))[0, 0].argmax()))
        out[r.rid] = toks
    return out


def engine_records():
    """(c) the cost-only engine and fleet rebuild the bert rows of the serve
    (kind "engine") and tensor records, with the arguments of
    benchmarks/paper_tables.py npec_serve and npec_tensor."""
    from repro_torch.core.overlay import NPEHardware
    from repro_torch.npec.fleet import NPEFleet, partition_tensor
    from repro_torch.npec.runtime import NPEEngine, StreamCache
    hw = NPEHardware(vrwidth=1024)
    cfg = get_config("bert_base")
    serve_rows = []
    for bits in (8, 16):
        eng = NPEEngine(cfg, hw, slots=8, capacity=48, max_new_tokens=16, bits=bits)
        reqs = SyntheticRequests(cfg.vocab_size, max_prompt=32)
        for i in range(16):
            eng.submit(reqs.request(i), eos_id=reqs.eos_id(i))
        rep = eng.run().report()
        serve_rows.append(dict(
            kind="engine", arch="bert_base", slots=8, mmu_bits=bits,
            cycle_model=rep["cycle_model"], requests=rep["requests"],
            generated_tokens=rep["generated_tokens"], p50_ms=rep["p50_ms"],
            p99_ms=rep["p99_ms"], first_token_p50_ms=rep["first_token_p50_ms"],
            tok_s=round(rep["tokens_per_sec"], 1), decode_step_cycles=rep["decode_step_cycles"],
            decode_step_cycles_dag=rep["decode_step_cycles_dag"],
            mmu_row_occupancy=round(rep["mmu_row_occupancy"], 4),
            total_cycles=rep["total_cycles"], decode_steps=rep["decode_steps"],
            prefills=rep["prefills"]))
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=24)
    dec = npec.compile_decode(cfg, 48, hw, bits=16, batch=4)
    pre = npec.compile_prefill(cfg, 24, hw, bits=16)
    shared, tensor_rows = StreamCache(), []

    def critical(plan):
        costs = [(npec.stream_schedule(q)["total_cycles"], npec.transfer_cycles(q))
                 for q in plan.shards]
        return int(max(c for c, _ in costs)), int(max(x for _, x in costs))

    for n in (1, 2, 4):
        fleet = NPEFleet(cfg, hw, overlays=n, shard="tensor", slots=4, capacity=48,
                         max_new_tokens=12, bits=16, stream_cache=shared)
        for i in range(4):
            fleet.submit(reqs.request(i), eos_id=reqs.eos_id(i))
        rep = fleet.run().report()
        dplan, pplan = partition_tensor(dec, n), partition_tensor(pre, n)
        (d_cyc, d_x), (p_cyc, p_x) = critical(dplan), critical(pplan)
        tensor_rows.append(dict(
            family="bert", shard="tensor", overlays=n, mmu_bits=16,
            heads_per_overlay=cfg.num_heads // n, boundaries=dplan.boundaries,
            requests=rep["requests"], tokens=rep["tokens"], p50_ms=rep["p50_ms"],
            p99_ms=rep["p99_ms"], service_p50_ms=rep["service_p50_ms"],
            tok_s=round(rep["tokens_per_sec"], 1), makespan_cycles=rep["makespan_cycles"],
            transfer_cycles=rep["transfer_cycles"], overlay_util=rep["overlay_util"],
            decode_step_cycles=d_cyc, decode_allreduce_cycles=d_x, prefill_cycles=p_cyc,
            prefill_allreduce_cycles=p_x))
    return {"npec_serve_cycles.json": (serve_rows, lambda r: r.get("kind") == "engine"),
            "npec_tensor_cycles.json": (tensor_rows, lambda r: r.get("family") == "bert")}


def engine_phase(dev, base, tree, results):
    """[7] `NPEEngine` serving on the card: (a) the NPE-8 engine and its
    launches, tokens against per-request streams; (b) chunked float prefill
    against whole prompts; (c) the cost-only cycle records."""
    out = {}
    t_phase = time.perf_counter()
    c8 = base.with_npe(quant_bits=8)
    say(f"  (a) NPEEngine(bert_base, slots={ENGINE['slots']}, capacity={ENGINE['capacity']}, "
        f"max_new_tokens={ENGINE['max_new_tokens']}, bits=8, npe=True, device=cuda), "
        f"{ENGINE_REQUESTS} requests of SyntheticRequests(max_prompt={ENGINE_MAX_PROMPT}) "
        "with their EOS ids")
    counts, (eng, ms, admitted, prof) = counted(
        lambda: run_engine(base, tree, dev, npe=True, bits=8, profile_step=PROFILE_STEP))
    stats = eng.stats
    expected = engine_expected_launches(base, stats, eng.decode_prog.graph, 8)
    # host ms of the steps the profiler did not run
    plain = [(m, a) for i, (m, a) in enumerate(zip(ms, admitted)) if i != PROFILE_STEP]
    decode_only = [m for m, a in plain if not a]
    host_med = float(np.median([m for m, _ in plain]))
    busy = prof["device_busy_ms"]
    # the profiled step's own host time runs under the profiler (its trace
    # is read after the step's clock stops); the idle
    # share is also given against the median of the decode-only steps run
    # without it, which do the same work (one decode graph over 8 slots)
    prof["host_ms_profiled_step"] = ms[PROFILE_STEP]
    prof["idle_share_profiled_step"] = 1 - busy / ms[PROFILE_STEP] if busy > 0 else None
    prof["host_ms"] = float(np.median(decode_only)) if decode_only else host_med
    prof["idle_share"] = (1 - busy / prof["host_ms"]) if busy > 0 else None
    rep = stats.report()
    say(f"      launches of the run {counts} (from the {stats.prefills} prefill and "
        f"{stats.decode_steps} decode graphs {expected})")
    say(f"      {len(ms)} engine steps: {host_med:.1f} ms host a step (median), "
        f"{prof['host_ms']:.1f} ms a decode-only step (median of {len(decode_only)})")
    say_profile(f"engine step {PROFILE_STEP} ("
                + ("it admitted" if admitted[PROFILE_STEP] else "decode only")
                + "), idle share against the decode-only median of the other steps", prof)
    idle_own = prof["idle_share_profiled_step"]
    say(f"             the same step's own host time under the profiler: "
        f"{ms[PROFILE_STEP]:.1f} ms, idle share "
        + ("not measured" if idle_own is None else f"{idle_own:.3f}"))
    say(f"      overlay model (FPGA, 200 MHz), not card time: p50 {rep['p50_ms']} ms, "
        f"p99 {rep['p99_ms']} ms, {rep['tokens_per_sec']:.1f} tokens/s, "
        f"{rep['generated_tokens']} tokens, {rep['total_cycles']} cycles")
    if counts != expected or any(counts[k] == 0 for k in NPEC_KERNELS):
        raise SystemExit("npec engine: launches differ from the graphs'")
    want = per_request_streams(base, tree, dev, c8, stats, 8)
    same = {r.rid: r.generated == want[r.rid] for r in stats.requests}
    say(f"      served tokens vs per-request streams: {sum(same.values())}/{len(same)} "
        "requests bit for bit" + ("" if all(same.values()) else "  FAIL"))
    if not all(same.values()) or len(same) != ENGINE_REQUESTS:
        raise SystemExit("npec engine: served tokens differ from the per-request streams")
    tokens = {r.rid: r.generated for r in stats.requests}

    # the kernels at the engine's shapes: the same run once more, untimed,
    # keeping the inputs of each kernel's first call at each shape
    with kept_kernel_calls() as kept:
        again, _, _, _ = run_engine(base, tree, dev, npe=True, bits=8)
    rerun_same = {r.rid: r.generated for r in again.stats.requests} == tokens
    checks = check_kept_calls(kept)
    say(f"      each kernel at the engine's shapes, on the inputs of its first call at each "
        f"(a second, untimed run{'' if rerun_same else ' that served OTHER tokens  FAIL'}), "
        "against its plain version; quant_matmul, nvu_softmax and pwl_eval also bit for "
        "bit (plain, walk, walk):")
    for k, r in checks.items():
        exact = {None: "within atol {:g}, rtol {:g}".format(*TOLS[(k, torch.float32)]),
                 True: "bit for bit",
                 False: "NOT bit for bit"}[r["bit_for_bit"]]
        say(f"        {k:13s} {len(r['shapes'])} shapes, {r['calls']} calls, max-abs "
            f"{r['max_abs_err']:.2e} from plain, {exact}"
            f"{'' if r['ok'] else '  FAIL'}: " + "; ".join(r["shapes"][:14])
            + (" ..." if len(r["shapes"]) > 14 else ""))
    if not rerun_same or not all(r["ok"] and r["shapes"] for r in checks.values()):
        raise SystemExit("npec engine: a kernel disagrees with its plain version at the "
                         "engine's shapes")
    out["npe8"] = dict(launches=counts, expected_launches=expected, step_ms=ms,
                       admitted=admitted, host_ms_per_step=host_med,
                       host_ms_per_decode_step=prof["host_ms"], profile=prof, report=rep,
                       tokens=tokens, kernel_checks=checks)

    gate = results["npec_decode"]["float"]["gate"]
    say(f"  (b) float engine, prefill_chunk={ENGINE_CHUNK} vs whole prompts; a differing "
        f"token must sit at a top-2 margin below {gate:.3e} (twice the float stream's "
        "change under 1-ulp weights, [6](c)), the margin of a float prefill over the "
        "prompt and the tokens before it")
    runs = {}
    for chunk in (None, ENGINE_CHUNK):
        e, ms_c, _, _ = run_engine(base, tree, dev, npe=False, bits=16, prefill_chunk=chunk)
        runs[chunk] = (e.stats, float(np.median(ms_c)))
    (whole, ms_w), (chunked, ms_ch) = runs[None], runs[ENGINE_CHUNK]
    gw = {r.rid: r.generated for r in whole.requests}
    diffs = []
    for r in chunked.requests:
        a, b = gw[r.rid], r.generated
        if a != b:
            j = next(i for i in range(min(len(a), len(b)) + 1)
                     if i == min(len(a), len(b)) or a[i] != b[i])
            seq = list(r.prompt) + a[:j]
            logits = npec.execute(npec.compile_prefill(base, len(seq), bits=16), tree,
                                  {"tokens": np.asarray(seq, np.int32)}, device=dev)[0][-1]
            top = logits.double().topk(2).values
            margin = float(top[0] - top[1])
            diffs.append(dict(rid=r.rid, index=j, margin=margin))
            say(f"      request {r.rid} token {j}: {a[j:j + 1]} vs {b[j:j + 1]}, top-2 "
                f"margin {margin:.3e}")
    ok = all(d["margin"] < gate for d in diffs)
    say(f"      {len(gw) - len(diffs)}/{len(gw)} requests the same tokens; {ms_w:.1f} / "
        f"{ms_ch:.1f} ms host a step (median, whole / chunked)" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("npec engine: chunked prefill changed a token past a near tie")
    out["chunked_float"] = dict(differences=diffs, gate=gate, host_ms_whole=ms_w,
                                host_ms_chunked=ms_ch)

    say("  (c) cost-only engine and fleet vs the committed records (bert rows)")
    for name, (rows, keep) in engine_records().items():
        want = [r for r in json.loads((ROOT / "results" / name).read_text())["rows"] if keep(r)]
        same = rows == want
        say(f"      results/{name}: {len(rows)} rows rebuilt, "
            + ("equal" if same else "DIFFER  FAIL"))
        if not same:
            raise SystemExit(f"npec engine: the rebuilt rows of results/{name} differ")
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase [7]: {out['seconds']:.1f} s, {ENGINE_REQUESTS} requests")
    results["engine"] = out
    results["engine_launches"] = counts


# --- phase 8: GLM4-9B decode serving --------------------------------------

def audit_call(fn, what, expected=None):
    """Run fn with every kernel launch held to its plain version; raise on a
    disagreement or, with `expected`, on other launch counts."""
    with Audit() as audit:
        fn()
        torch.cuda.synchronize()
    stats = {k: dict(launches=n, max_abs_err=e, ok=ok) for k, (n, e, ok) in audit.stats.items()}
    say(f"  {what}, every launch vs its plain version on its operands: " +
        ", ".join(f"{k} {n} launches max-abs {e:.2e} {'ok' if ok else 'FAIL'}"
                  for k, (n, e, ok) in audit.stats.items()))
    if any(not ok for _, _, ok in audit.stats.values()):
        raise SystemExit(f"{what}: a launch disagrees with its plain version")
    if expected is not None and audit.counts() != expected:
        raise SystemExit(f"{what}: launches differ from {expected}")
    return stats


def check_logits(logits, shape, what):
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits.float()).all()):
        raise SystemExit(f"{what}: logits of shape {tuple(logits.shape)} or not finite")


def say_profile_step(what, prof):
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    say(f"  one {what}: {prof['host_ms']:.3f} ms host clock (median of the served run), "
        f"{prof['device_busy_ms']:.3f} ms device busy (torch.profiler), idle share {idle}; "
        f"{prof['kernels']} kernels by name, device ms by kernel:")
    for name, ms in prof["top"]:
        say(f"      {ms:8.4f}  {name}")



def glm4_phase(dev, card, results):
    """Full-width, 40-layer GLM4-9B in bf16 through `launch.serve.Server`,
    random weights from a torch generator: (a) 8 slots, [5]'s prompts, 16
    greedy tokens, a 256-row cache, in float, NPE-8 and NPE-16; (b) the
    launches of one step and of one one-slot prefill in each mode, and of
    the served run, checked exactly; (c) every launch of one NPE-8 step and
    of the 8 one-slot NPE-8 prefills held to its plain version; (d) one
    NPE-8 step profiled; (e) teacher-forced top-1 agreement with float,
    reported; (f) the kernel route at 2 layers, float32, against the CPU's
    plain route (after the served model is freed)."""
    cfg = get_config("glm4_9b")
    prompts = decode_prompts(cfg.vocab_size)
    start = max(len(p) for p in prompts)
    t0 = time.perf_counter()
    since = lambda: f"({time.perf_counter() - t0:.1f} s into [8])"   # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    model = registry.build_model(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  glm4_9b L={cfg.num_layers} D={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
        f"Dh={cfg.head_dim} d_ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}, {n_params:,} "
        f"parameters ({torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB on the card, drawn in "
        f"{time.perf_counter() - t0:.1f} s); {SLOTS} slots, prompts of "
        f"{[len(p) for p in prompts]} tokens, {GLM4_GEN} steps from position {start}, "
        f"cache of {MAX_SEQ} rows")
    servers, out = {}, {}
    for mode in MODES:
        srv = servers[mode] = Server("glm4_9b", batch=SLOTS, max_seq=MAX_SEQ, mode=mode,
                                     device=dev, model=model)
        srv.generate(prompts, gen_tokens=2)                 # warm-up
        srv.cache = registry.init_cache(srv.cfg, SLOTS, MAX_SEQ, dev)
        counts, stats = counted(lambda: srv.generate(prompts, gen_tokens=GLM4_GEN))
        rep = stats.report()
        toks = stats.generated
        if toks.shape != (SLOTS, GLM4_GEN) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"glm4 {mode}: generated tokens of shape {toks.shape} or out of range")
        cur = torch.as_tensor(toks[:, -1:], device=dev)
        step, (logits, _) = counted(lambda: registry.decode_step(
            srv.cfg, srv.model, srv.cache, cur, start + GLM4_GEN))
        check_logits(logits, (SLOTS, 1, cfg.vocab_size), f"glm4 {mode} step")
        prefill, _ = counted(lambda: srv.prefill_prompt(0, prompts[0]))
        out[mode] = dict(rep, generated=toks.tolist(), run_launches=counts,
                         step_launches=step, prefill_launches=prefill, step_ms=stats.step_ms)
        say(f"  {mode:10s} prefill {rep['prefill_ms_per_slot']:8.3f} ms per slot, decode "
            f"{rep['decode_ms_per_step']:8.3f} ms per step (median of {GLM4_GEN}), "
            f"{rep['tokens_per_sec']:9.1f} tokens/s, on {card}")
        say(f"             launches of one step {step}, of one one-slot prefill {prefill}")
        want = GLM4_LAUNCHES[mode]
        if step != want or prefill != want:
            raise SystemExit(f"glm4 {mode}: launches of a step or a prefill differ from {want}")
        runs = len(prompts) + GLM4_GEN
        if counts != {k: n * runs for k, n in want.items()}:
            raise SystemExit(f"glm4 {mode}: launches of the served run {counts} differ from "
                             f"{runs} x {want}")
    results["glm4"] = out
    results["glm4_launches"] = out["npe-8bit"]["run_launches"]

    npe8 = servers["npe-8bit"]
    cur = torch.as_tensor(np.asarray(out["npe-8bit"]["generated"])[:, -1:], device=dev)
    pos = start + GLM4_GEN
    results["glm4_audit"] = audit_call(
        lambda: registry.decode_step(npe8.cfg, npe8.model, npe8.cache, cur, pos),
        f"{since()} one NPE-8 GLM4 decode step", GLM4_LAUNCHES["npe-8bit"])
    results["glm4_prefill_audit"] = audit_call(
        lambda: [npe8.prefill_prompt(slot, p) for slot, p in enumerate(prompts)],
        f"{since()} the 8 one-slot NPE-8 GLM4 prefills ({min(map(len, prompts))} to "
        f"{max(map(len, prompts))} rows)",
        {k: n * len(prompts) for k, n in GLM4_LAUNCHES["npe-8bit"].items()})
    prof = results["glm4_profile"] = profile_call(
        lambda: registry.decode_step(npe8.cfg, npe8.model, npe8.cache, cur, pos),
        out["npe-8bit"]["decode_ms_per_step"])
    say_profile_step("NPE-8 GLM4 decode step", prof)
    n_dev = results["glm4_device_launches"] = {
        mode: device_launches(lambda: registry.decode_step(srv.cfg, srv.model, srv.cache, cur, pos))
        for mode, srv in servers.items()}
    say("  device launches of one GLM4 decode step (kernels and copies, torch.profiler): " +
        ", ".join(f"{m} {n}" for m, n in n_dev.items()))

    feed = np.asarray(out["float"]["generated"])
    agree = {mode: float((teacher_forced(srv, prompts, feed) == feed).mean())
             for mode, srv in servers.items()}
    results["glm4_agreement"] = agree
    say(f"  {since()} GLM4 top-1 agreement with the float route's tokens, every mode fed them "
        "(reported, not gated): " + ", ".join(f"{m} {a:.4f}" for m, a in agree.items()))
    del servers, srv, npe8, model
    torch.cuda.empty_cache()
    say(f"  {since()} the route check:")
    decode_route_check(dev, results, "glm4_route_check")
    say(f"  {since()} done")


# --- phase 9: Gemma3-27B: local:global attention over ring caches -----------

def gemma3_phase(dev, card, results):
    """Full-width Gemma3-27B cut to GEMMA3_LAYERS = 6 of its 62 layers (one
    whole local:global period: 5 local over 1024-row rings, 1 global;
    bf16, about 3.9 B parameters drawn from a torch generator) through
    `launch.serve.Server`: (a) 8 slots, prompts of up to 16 tokens prefilled
    one token a call, 8 greedy steps, in float and NPE-8; (b) the launches
    of one step and of one prefill (a step a prompt token), and of the
    served run, checked exactly; NPE-16 for one step and one prefill; (c)
    every launch of one NPE-8 step held to its plain version; (d) one NPE-8
    step profiled, the device launches of one step in each mode; (e) the
    wrap: one slot in float to position 1040 over 1024-row rings through
    the first 6 layers (one local:global period), the step there audited,
    its launches those of a step before the wrap, its logits finite; (f)
    the route check at 2 layers (one local, one global; window 64, so both
    routes wrap the ring), float only: a CPU NPE call quantizes every
    weight of the cut model, some 2.2 B values, for each of the run's 28
    one-token calls."""
    cfg = dataclasses.replace(get_config("gemma3_27b"), num_layers=GEMMA3_LAYERS)
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=GEMMA3_MAX_PROMPT, seed=1)
    prompts = [reqs.request(i) for i in range(SLOTS)]
    start = max(len(p) for p in prompts)
    t0 = time.perf_counter()
    since = lambda: f"({time.perf_counter() - t0:.1f} s into [9])"   # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    model = registry.build_model(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    windows = registry.module_for(cfg).layer_windows(cfg)
    say(f"  gemma3_27b L={cfg.num_layers} (of 62; {int((windows > 0).sum())} local of window "
        f"{cfg.window}, {int((windows == 0).sum())} global) "
        f"D={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} Dh={cfg.head_dim} d_ff={cfg.d_ff} "
        f"V={cfg.vocab_size} tied {cfg.dtype}, {n_params:,} parameters "
        f"({torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB on the card, drawn in "
        f"{time.perf_counter() - t0:.1f} s); {SLOTS} slots, prompts of "
        f"{[len(p) for p in prompts]} tokens one a call, {GEMMA3_GEN} steps from position "
        f"{start}, cache of {GEMMA3_MAX_SEQ} rows")
    out, servers = {}, {}
    for mode in ("float", "npe-8bit"):
        srv = servers[mode] = Server("gemma3_27b", batch=SLOTS, max_seq=GEMMA3_MAX_SEQ,
                                     mode=mode, device=dev, model=model)
        srv.generate(prompts[:1], gen_tokens=1)            # warm-up
        srv.cache = registry.init_cache(srv.cfg, SLOTS, GEMMA3_MAX_SEQ, dev)
        counts, stats = counted(lambda: srv.generate(prompts, gen_tokens=GEMMA3_GEN))
        rep = stats.report()
        toks = stats.generated
        if toks.shape != (SLOTS, GEMMA3_GEN) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"gemma3 {mode}: generated tokens of shape {toks.shape} "
                             "or out of range")
        out[mode] = dict(rep, generated=toks.tolist(), run_launches=counts, step_ms=stats.step_ms)
        say(f"  {mode:10s} prefill {rep['prefill_ms_per_slot']:9.3f} ms per slot "
            f"({sum(map(len, prompts)) / SLOTS:.1f} one-token calls), decode "
            f"{rep['decode_ms_per_step']:8.3f} ms per step (median of {GEMMA3_GEN}), "
            f"{rep['tokens_per_sec']:8.1f} tokens/s, on {card} {since()}")
    srv16 = servers["npe-16bit"] = Server("gemma3_27b", batch=SLOTS, max_seq=GEMMA3_MAX_SEQ,
                                          mode="npe-16bit", device=dev, model=model)
    srv16.prefill_prompt(0, prompts[0][:2])               # warm-up
    out["npe-16bit"] = {}
    cur = torch.as_tensor(np.asarray(out["npe-8bit"]["generated"])[:, -1:], device=dev)
    pos = start + GEMMA3_GEN
    for mode, srv in servers.items():
        t1 = time.perf_counter()
        prefill, _ = counted(lambda: srv.prefill_prompt(0, prompts[0]))
        prefill_ms = 1e3 * (time.perf_counter() - t1)
        t1 = time.perf_counter()
        step, (logits, _) = counted(
            lambda: registry.decode_step(srv.cfg, model, srv.cache, cur, pos))
        step_ms = 1e3 * (time.perf_counter() - t1)
        check_logits(logits, (SLOTS, 1, cfg.vocab_size), f"gemma3 {mode} step")
        out[mode].update(step_launches=step, prefill_launches=prefill,
                         one_prefill_ms=prefill_ms, one_step_ms=step_ms)
        say(f"  {mode:10s} launches of one step {step}, of one one-slot prefill of "
            f"{len(prompts[0])} tokens {prefill} ({prefill_ms:.1f} ms; the step {step_ms:.1f} ms)")
        want = GEMMA3_LAUNCHES[mode]
        if step != want or prefill != {k: n * len(prompts[0]) for k, n in want.items()}:
            raise SystemExit(f"gemma3 {mode}: launches of a step or a prefill differ from {want}")
        if mode != "npe-16bit":
            runs = sum(map(len, prompts)) + GEMMA3_GEN
            if out[mode]["run_launches"] != {k: n * runs for k, n in want.items()}:
                raise SystemExit(f"gemma3 {mode}: launches of the served run differ from "
                                 f"{runs} x {want}")
    del servers["npe-16bit"], srv16
    results["gemma3"] = out
    results["gemma3_launches"] = out["npe-8bit"]["run_launches"]

    npe8 = servers["npe-8bit"]
    results["gemma3_audit"] = audit_call(
        lambda: registry.decode_step(npe8.cfg, model, npe8.cache, cur, pos),
        f"{since()} one NPE-8 Gemma3 decode step", GEMMA3_LAUNCHES["npe-8bit"])
    prof = results["gemma3_profile"] = profile_call(
        lambda: registry.decode_step(npe8.cfg, model, npe8.cache, cur, pos),
        out["npe-8bit"]["decode_ms_per_step"])
    say_profile_step("NPE-8 Gemma3 decode step", prof)
    n_dev = results["gemma3_device_launches"] = {
        mode: device_launches(lambda: registry.decode_step(srv.cfg, model, srv.cache, cur, pos))
        for mode, srv in servers.items()}
    say("  device launches of one Gemma3 decode step (kernels and copies, torch.profiler): " +
        ", ".join(f"{m} {n}" for m, n in n_dev.items()))
    fl_cfg = dataclasses.replace(servers["float"].cfg, num_layers=GEMMA3_WRAP_LAYERS)
    del servers, npe8
    torch.cuda.empty_cache()

    # the wrap: one slot, greedy, to GEMMA3_WRAP_POS over 1024-row rings,
    # through the served model's first GEMMA3_WRAP_LAYERS layers
    full_model, model = model, copy.copy(model)
    model._modules = dict(full_model._modules)
    model.layers = torch.nn.ModuleList(list(full_model.layers)[:GEMMA3_WRAP_LAYERS])
    cache = registry.init_cache(fl_cfg, 1, GEMMA3_WRAP_SEQ, dev)
    rows = cache["win"]["k"].shape[2]
    tok = torch.as_tensor(prompts[0][:1], device=dev).long()[None]
    wrap = {}
    t1 = time.perf_counter()
    for p in range(GEMMA3_WRAP_POS):
        if p == 1000:                   # a step before the wrap at 1024
            wrap["launches_at_1000"], (lg, _) = counted(
                lambda: registry.decode_step(fl_cfg, model, cache, tok, p))
        else:
            lg, _ = registry.decode_step(fl_cfg, model, cache, tok, p)
        tok = lg[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    wrap["seconds_to_1040"] = time.perf_counter() - t1
    snapshot = {g: {k: t.clone() for k, t in kv.items()} for g, kv in cache.items()}
    wrap["launches_at_1040"], (lg, _) = counted(
        lambda: registry.decode_step(fl_cfg, model, cache, tok, GEMMA3_WRAP_POS))
    check_logits(lg, (1, 1, cfg.vocab_size), "gemma3 step at 1040")
    cache = snapshot                    # the same step once more, audited
    wrap["audit"] = audit_call(
        lambda: registry.decode_step(fl_cfg, model, cache, tok, GEMMA3_WRAP_POS),
        f"{since()} the float Gemma3 step at position {GEMMA3_WRAP_POS} ({rows}-row rings, "
        f"written {GEMMA3_WRAP_POS // rows} times over)", wrap["launches_at_1040"])
    say(f"  the wrap: {GEMMA3_WRAP_POS} one-slot float steps of the first "
        f"{GEMMA3_WRAP_LAYERS} layers in {wrap['seconds_to_1040']:.1f} s; launches at 1000 "
        f"{wrap['launches_at_1000']}, at 1040 {wrap['launches_at_1040']}; logits finite")
    if wrap["launches_at_1040"] != wrap["launches_at_1000"] or \
            wrap["launches_at_1040"]["flash_attention"] != GEMMA3_WRAP_LAYERS:
        raise SystemExit("gemma3: the launches of a step past the wrap differ")
    results["gemma3_wrap"] = wrap
    del cache, snapshot, model, full_model
    torch.cuda.empty_cache()
    say(f"  {since()} the route check (2 layers, global_every 2: layer 0 local, layer 1 "
        "global; window 16; prompts of 18 and 6 tokens one a call and 4 steps, so both "
        "routes wrap the ring; float only):")
    decode_route_check(dev, results, "gemma3_route_check")
    say(f"  {since()} done")


# --- phase 10: Granite-3.0-1B-A400M: an MoE block in every layer --------------

class DropCounter:
    """Record, for each MoE call (in call order: a train step's forward, then
    its backward pass's recomputed layers), the (token, choice) slots that
    capacity drops, of how many, at what capacity, and its expert ids."""

    def __enter__(self):
        self.route, self.drops, self.ids = moe_mod.route, [], []

        def counting(cfg, p, x):
            r = self.route(cfg, p, x)
            self.drops.append((int((~r.kept).sum()), r.kept.numel(), r.capacity))
            self.ids.append(r.expert_ids.detach().cpu())
            return r

        moe_mod.route = counting
        return self

    def __exit__(self, *exc):
        moe_mod.route = self.route


def granite_phase(dev, card, results):
    """Full-width, 24-layer Granite-3.0-1B-A400M (32 experts, top-8, bf16)
    through `launch.serve.Server`: (a) 8 slots, [5]'s prompts (33 to 120
    tokens, one multi-token prefill each: full attention), 16 greedy tokens,
    a 256-row cache, in float, NPE-8 and NPE-16; (b) the launches of one
    step and of one one-slot prefill, and of the served run, checked
    exactly; (c) every launch of one NPE-8 step and of the 8 NPE-8
    prefills held to its plain version, with the token-slots capacity
    dropped in each prefill; (d) one NPE-8 step profiled; (e)
    teacher-forced top-1 agreement with float, reported; (f) the route
    check at 2 layers in every mode."""
    cfg = get_config("granite_moe_1b_a400m")
    prompts = decode_prompts(cfg.vocab_size)
    start = max(len(p) for p in prompts)
    t0 = time.perf_counter()
    since = lambda: f"({time.perf_counter() - t0:.1f} s into [10])"   # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    model = registry.build_model(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    m = cfg.moe
    say(f"  granite_moe_1b_a400m L={cfg.num_layers} D={cfg.d_model} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} Dh={cfg.head_dim} E={m.num_experts} "
        f"top-{m.top_k} expert d_ff={cfg.d_ff} V={cfg.vocab_size} tied {cfg.dtype}, "
        f"{n_params:,} parameters; {SLOTS} slots, prompts of {[len(p) for p in prompts]} "
        f"tokens, {GRANITE_GEN} steps from position {start}, cache of {MAX_SEQ} rows")
    servers, out = {}, {}
    for mode in MODES:
        srv = servers[mode] = Server("granite_moe_1b_a400m", batch=SLOTS, max_seq=MAX_SEQ,
                                     mode=mode, device=dev, model=model)
        srv.generate(prompts, gen_tokens=2)                 # warm-up
        srv.cache = registry.init_cache(srv.cfg, SLOTS, MAX_SEQ, dev)
        counts, stats = counted(lambda: srv.generate(prompts, gen_tokens=GRANITE_GEN))
        rep = stats.report()
        toks = stats.generated
        if toks.shape != (SLOTS, GRANITE_GEN) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"granite {mode}: generated tokens of shape {toks.shape} "
                             "or out of range")
        cur = torch.as_tensor(toks[:, -1:], device=dev)
        step, (logits, _) = counted(lambda: registry.decode_step(
            srv.cfg, model, srv.cache, cur, start + GRANITE_GEN))
        check_logits(logits, (SLOTS, 1, cfg.vocab_size), f"granite {mode} step")
        prefill, _ = counted(lambda: srv.prefill_prompt(0, prompts[0]))
        out[mode] = dict(rep, generated=toks.tolist(), run_launches=counts,
                         step_launches=step, prefill_launches=prefill, step_ms=stats.step_ms)
        say(f"  {mode:10s} prefill {rep['prefill_ms_per_slot']:8.3f} ms per slot, decode "
            f"{rep['decode_ms_per_step']:8.3f} ms per step (median of {GRANITE_GEN}), "
            f"{rep['tokens_per_sec']:9.1f} tokens/s, on {card}")
        say(f"             launches of one step {step}, of one one-slot prefill {prefill}")
        want = GRANITE_LAUNCHES[mode]
        if step != want or prefill != want:
            raise SystemExit(f"granite {mode}: launches of a step or a prefill differ from {want}")
        runs = len(prompts) + GRANITE_GEN
        if counts != {k: n * runs for k, n in want.items()}:
            raise SystemExit(f"granite {mode}: launches of the served run {counts} differ from "
                             f"{runs} x {want}")
    results["granite"] = out
    results["granite_launches"] = out["npe-8bit"]["run_launches"]

    npe8 = servers["npe-8bit"]
    cur = torch.as_tensor(np.asarray(out["npe-8bit"]["generated"])[:, -1:], device=dev)
    pos = start + GRANITE_GEN
    results["granite_audit"] = audit_call(
        lambda: registry.decode_step(npe8.cfg, model, npe8.cache, cur, pos),
        f"{since()} one NPE-8 Granite decode step", GRANITE_LAUNCHES["npe-8bit"])
    drops = {}
    with DropCounter() as dc:
        results["granite_prefill_audit"] = audit_call(
            lambda: [npe8.prefill_prompt(slot, p) for slot, p in enumerate(prompts)],
            f"{since()} the 8 one-slot NPE-8 Granite prefills ({min(map(len, prompts))} to "
            f"{max(map(len, prompts))} rows)",
            {k: n * len(prompts) for k, n in GRANITE_LAUNCHES["npe-8bit"].items()})
    for slot, p in enumerate(prompts):
        calls = dc.drops[slot * cfg.num_layers:(slot + 1) * cfg.num_layers]
        drops[len(p)] = dict(capacity=calls[0][2], slots_per_layer=calls[0][1],
                             dropped_per_layer=[d for d, _, _ in calls],
                             dropped=sum(d for d, _, _ in calls))
    results["granite_drops"] = drops
    say("  token-slots (token, choice) that capacity dropped in each NPE-8 prefill, over its "
        f"{cfg.num_layers} MoE layers (capacity C = int(S * {m.top_k} / {m.num_experts} * "
        f"{m.capacity_factor}) a sequence): " +
        ", ".join(f"S={s} C={d['capacity']}: {d['dropped']} of "
                  f"{d['slots_per_layer'] * cfg.num_layers}" for s, d in drops.items()))
    prof = results["granite_profile"] = profile_call(
        lambda: registry.decode_step(npe8.cfg, model, npe8.cache, cur, pos),
        out["npe-8bit"]["decode_ms_per_step"])
    say_profile_step("NPE-8 Granite decode step", prof)
    feed = np.asarray(out["float"]["generated"])
    agree = {mode: float((teacher_forced(srv, prompts, feed) == feed).mean())
             for mode, srv in servers.items()}
    results["granite_agreement"] = agree
    say(f"  {since()} Granite top-1 agreement with the float route's tokens, every mode fed "
        "them (reported, not gated): " + ", ".join(f"{m} {a:.4f}" for m, a in agree.items()))
    del servers, srv, npe8, model
    torch.cuda.empty_cache()
    say(f"  {since()} the route check:")
    decode_route_check(dev, results, "granite_route_check")
    say(f"  {since()} done")


# --- phase 11: npec for the dense and MoE families ---------------------------

# [11](a): GLM4-9B's depth through the executor.  On an H100 80GB HBM3 at
# 700 W, 32 layers took [11] to 159.7 s, past its 150 s, and the script to
# 1,144 s; 24 layers took [11] 122.6-148.0 s; 12 layers, once [16] (the
# decoders' training) joined the script, 90.0-126.0 s and the script
# 1,021-1,232 s, past its 1,200 s on the slower host; 4 layers since
NPEC_GLM4_LAYERS = 4
NPEC_CHUNK, NPEC_GLM4_T, NPEC_GLM4_STEPS = 16, 256, 8
NPEC_CHECK_SLOTS, NPEC_CHECK_STEPS, NPEC_CHECK_T = 2, 4, 128     # [11](b), 2 layers
GRANITE_NPEC_SEQS = (64, 120)                                     # [11](c)
NPEC_MODES = ("float", "npe-8bit")


def f32_cache(cfg, rows: int, dev):
    """A one-sequence float32 KV cache for the model's plain attention: the
    executor's banks are float32, where the served model's cache is bf16."""
    kv = lambda: torch.zeros(cfg.num_layers, 1, rows, cfg.num_kv_heads, cfg.head_dim,  # noqa: E731
                             device=dev)
    return {"full": {"k": kv(), "v": kv()}}


def chunked_prefill(chunk, tree, c, prompt, dev):
    """One prompt through the 16-row chunked slice stream, slice by slice,
    carrying the cache banks: (its banks' first len(prompt) rows, the last
    prompt row's logits, host ms of each slice).  The last slice is padded
    with token 0 at the positions after the prompt: their k/v rows lie past
    the prompt and are not loaded, no prompt row sees them (a row sees the
    slots up to its own position), and in NPE-8 they take part in the
    slice's per-tensor activation scale."""
    g = chunk.graph
    banks = {name: torch.zeros(g.node(nid).shape, dtype=torch.float32, device=dev)
             for name, nid in g.caches.items()}
    n, ms, last = len(prompt), [], None
    for base in range(0, n, NPEC_CHUNK):
        toks = np.zeros(NPEC_CHUNK, np.int32)
        real = prompt[base:base + NPEC_CHUNK]
        toks[:len(real)] = real
        rows = np.arange(base, base + NPEC_CHUNK, dtype=np.int32)
        t0 = time.perf_counter()
        res = npec.execute(chunk, tree, dict(banks, tokens=toks, pos_ids=rows), cfg=c, device=dev)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        banks.update(res.cache_updates)
        if base + NPEC_CHUNK >= n:
            last = res[0][n - 1 - base]
    return {k: v[:n] for k, v in banks.items()}, last, ms


def npec_glm4_serve(dev, ptree, base, results):
    """(a) GLM4-9B at full width, NPEC_GLM4_LAYERS layers, float32 weights
    from [8]'s seed: [5]'s 8 prompts through one compiled 16-row chunked
    prefill slice over 256-row banks, loaded into the 8-slot
    `compile_decode(256, batch=8)` stream, then NPEC_GLM4_STEPS steps; float
    greedy, NPE-8 fed float's tokens.  Compile seconds, host ms a slice and
    a step, the NPE-8 run's launches against the graphs', every kernel call
    of one NPE-8 step held to its plain version, one step profiled, and
    NPE-8's top-1 agreement with float over the first token and the steps."""
    prompts = decode_prompts(base.vocab_size)
    t0 = time.perf_counter()
    chunk = npec.compile_prefill(base, NPEC_CHUNK, bits=8, cache_len=NPEC_GLM4_T)
    dec = npec.compile_decode(base, NPEC_GLM4_T, bits=8, batch=SLOTS)
    compile_s = time.perf_counter() - t0
    slices = sum(-(-len(p) // NPEC_CHUNK) for p in prompts)
    say(f"  (a) glm4_9b L={base.num_layers} (of 40) D={base.d_model} float32 weights; compiled "
        f"the {NPEC_CHUNK}-row slice ({len(chunk.graph.nodes)} nodes, {len(chunk.instrs)} "
        f"overlay instrs) and the {SLOTS}-slot decode step ({len(dec.graph.nodes)} nodes, "
        f"{len(dec.instrs)} instrs) in {compile_s:.2f} s; prompts {[len(p) for p in prompts]} "
        f"in {slices} slices, {NPEC_GLM4_STEPS} steps")

    def run(c, feed=None, keep=None):
        sess = npec.DecodeSession(dec, ptree, cfg=c, device=dev)
        if keep is not None:
            keep.append(sess)
        first, slice_ms = [], []
        for slot, p in enumerate(prompts):
            kv, last, ms = chunked_prefill(chunk, ptree, c, p, dev)
            sess.load_slot(slot, kv, len(p))
            first.append(last)
            slice_ms += ms
        first = torch.stack(first)
        cur = first.argmax(-1) if feed is None else feed[:, 0]
        fed, logits, step_ms = [], [], []
        for i in range(NPEC_GLM4_STEPS):
            toks = cur if feed is None else feed[:, i]
            fed.append(toks)
            t1 = time.perf_counter()
            out = sess.step(toks)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
            logits.append(out)
            cur = out.argmax(-1)
        return dict(first=first, fed=torch.stack(fed, 1), logits=torch.stack(logits),
                    slice_ms=slice_ms, step_ms=step_ms)

    expected = {k: 0 for k in KERNELS}
    for graph, n in ((chunk.graph, slices), (dec.graph, NPEC_GLM4_STEPS)):
        for k, v in npec.expected_launches(graph, npe_quant=True, bits=8, use_pwl=True).items():
            expected[k] += n * v
    runs, out = {}, {}
    for mode in NPEC_MODES:
        c = MODES[mode](base)
        t1 = time.perf_counter()
        if mode == "npe-8bit":
            kept_sess = []
            counts, run_ = counted(lambda: run(c, runs["float"]["fed"], kept_sess))
        else:
            counts, run_ = counted(lambda: run(c))
        seconds = time.perf_counter() - t1
        runs[mode] = run_
        logits = torch.cat([run_["first"][None], run_["logits"]])
        if tuple(logits.shape) != (NPEC_GLM4_STEPS + 1, SLOTS, base.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"npec glm4 {mode}: logits of shape {tuple(logits.shape)} "
                             "or not finite")
        float_toks = torch.cat([runs["float"]["first"].argmax(-1)[None],
                                runs["float"]["logits"].argmax(-1)])
        agree = float(logits.argmax(-1).eq(float_toks).float().mean())
        slice_ms = sorted(run_["slice_ms"])[len(run_["slice_ms"]) // 2]
        step_ms = sorted(run_["step_ms"])[NPEC_GLM4_STEPS // 2]
        out[mode] = dict(seconds=seconds, host_ms_per_slice=slice_ms, host_ms_per_step=step_ms,
                         slice_ms=run_["slice_ms"], step_ms=run_["step_ms"],
                         agreement_with_float=agree, launches=counts,
                         tokens=run_["fed"].tolist())
        say(f"  {mode:10s} {slices} prefill slices {slice_ms:.1f} ms host each (median), "
            f"{NPEC_GLM4_STEPS} steps {step_ms:.1f} ms host each (median); top-1 agreement with "
            f"float {agree:.4f}; {seconds:.1f} s; launches {counts}")
    npe8 = out["npe-8bit"]
    npe8["expected_launches"] = expected
    say(f"  launches of the NPE-8 run ({slices} slices + {NPEC_GLM4_STEPS} steps) from the graphs "
        f"{expected}")
    if npe8["launches"] != expected or any(npe8["launches"][k] == 0 for k in NPEC_KERNELS):
        raise SystemExit("npec glm4: launches differ from the graphs'")
    sess, last = kept_sess[0], runs["npe-8bit"]["fed"][:, -1]
    idle = np.zeros(SLOTS, bool)
    with kept_kernel_calls() as kept:
        sess.step(last, active=idle)
    torch.cuda.synchronize()
    checked = npe8["kept_calls"] = check_kept_calls(kept)
    say("  every kernel call of one NPE-8 step (first at each shape) once more vs its plain "
        "version: " + "; ".join(f"{k} {r['calls']} calls at {len(r['shapes'])} shapes max-abs "
                                f"{r['max_abs_err']:.2e}"
                                + ("" if r["bit_for_bit"] is None else
                                   f", {'bit for bit' if r['bit_for_bit'] else 'NOT bit for bit'}")
                                for k, r in checked.items()))
    if not all(r["ok"] and r["calls"] for r in checked.values()):
        raise SystemExit("npec glm4: a kernel call of the NPE-8 step disagrees with its plain "
                         "version")
    npe8["profile"] = prof = profile_call(lambda: sess.step(last, active=idle),
                                          npe8["host_ms_per_step"])
    say_profile("one more NPE-8 step", prof)
    results["npec_glm4"] = dict(out, layers=base.num_layers, compile_s=compile_s,
                                slices=slices, prompts=[len(p) for p in prompts])
    return npe8["launches"]


def npec_glm4_check(dev, ptree, model, results):
    """(b) The executor against the port's models/transformer on the same
    weights on the card: GLM4-9B at full width cut to 2 layers, float32
    weights and a float32 cache, the model's attention its plain version
    (`ops.plain_dense_attention`).  NPEC_CHECK_SLOTS of [5]'s prompts, each prefilled
    by its own `compile_prefill` stream and loaded into a 2-slot decode
    stream, then NPEC_CHECK_STEPS steps; the model runs each prompt alone
    (one activation scale a row, as the stream's).  All fed the model's
    float greedy tokens.  Logits within FLOAT_TOL (float) or NPE16_TOL
    (NPE-8), or past it within twice the model's own change under 1-ulp
    weights; the executor's greedy token equal to the model's wherever the
    model's top-2 margin is above that gate."""
    cfg = model.cfg
    prompts = decode_prompts(cfg.vocab_size)[:NPEC_CHECK_SLOTS]
    dec = npec.compile_decode(cfg, NPEC_CHECK_T, bits=8, batch=NPEC_CHECK_SLOTS)

    def model_run(c, m, feed=None):
        """(logits (steps + 1, slots, V), greedy tokens (slots, steps))"""
        logits, toks = [], []
        with ops.plain_dense_attention():
            for p in prompts:
                cache = f32_cache(cfg, NPEC_CHECK_T, dev)
                lg = registry.decode_step(c, m, cache, torch.as_tensor(p, device=dev).long()[None],
                                          0)[0]
                rows, cur, seq = [lg[0, -1]], int(lg[0, -1].argmax()), []
                for i in range(NPEC_CHECK_STEPS):
                    tok = cur if feed is None else int(feed[len(toks), i])
                    seq.append(tok)
                    lg = registry.decode_step(c, m, cache, torch.tensor([[tok]], device=dev),
                                              len(p) + i)[0]
                    rows.append(lg[0, -1])
                    cur = int(lg[0, -1].argmax())
                logits.append(torch.stack(rows))
                toks.append(seq)
        return torch.stack(logits, 1), np.asarray(toks)

    def exec_run(c, feed):
        sess = npec.DecodeSession(dec, ptree, cfg=c, device=dev)
        first = []
        for slot, p in enumerate(prompts):
            res = npec.execute(npec.compile_prefill(cfg, len(p), bits=8), ptree, {"tokens": p},
                               cfg=c, device=dev)
            sess.load_slot(slot, res.kv_exports, len(p))
            first.append(res[0][-1])
        rows = [torch.stack(first)]
        for i in range(NPEC_CHECK_STEPS):
            rows.append(sess.step(torch.as_tensor(feed[:, i], device=dev)))
        return torch.stack(rows)

    t0 = time.perf_counter()
    _, feed = model_run(cfg, model)
    noisy, out = None, {}
    for mode in NPEC_MODES:
        c = MODES[mode](cfg)
        want, _ = model_run(c, model, feed)
        got = exec_run(c, feed)
        err = float((got - want).abs().max())
        base_tol = FLOAT_TOL if mode == "float" else NPE16_TOL
        noise = None
        if err > base_tol:
            if noisy is None:
                noisy = nudge(model).to(dev)
            noise = float((model_run(c, noisy, feed)[0] - want).abs().max())
        gate = max(base_tol, NOISE_FACTOR * noise) if noise is not None else base_tol
        top2 = want.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        differ = got.argmax(-1) != want.argmax(-1)
        near = bool((margin[differ] <= gate).all())
        ok = err <= gate and near and bool(torch.isfinite(got).all())
        out[mode] = dict(max_abs=err, gate=gate, nudge_max_abs=noise,
                         tokens_differ=int(differ.sum()), tokens=int(differ.numel()),
                         differ_at_near_ties=near, ok=ok)
        say(f"  (b) {mode:10s} executor vs models/transformer decode_step (its plain attention, "
            f"float32 cache), glm4_9b 2 layers full width, {NPEC_CHECK_SLOTS} slots (prompts "
            f"{[len(p) for p in prompts]}), prefill + {NPEC_CHECK_STEPS} steps: max-abs "
            f"{err:.3e} (gate {gate:.3e}"
            + ("" if noise is None else f"; the model under 1-ulp weights {noise:.3e}")
            + f"), greedy tokens differ at {int(differ.sum())} of {differ.numel()}"
            + (" (each at a top-2 margin below the gate)" if differ.any() and near else "")
            + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"npec glm4 check, {mode}: the executor disagrees with "
                             "models/transformer")
    results["npec_glm4_check"] = dict(out, seconds=time.perf_counter() - t0)


def npec_granite(dev, results):
    """(c) Granite-3.0-1B-A400M at full width and depth (24 MoE layers,
    float32 weights from seed 0): `compile_model` prefill streams at S = 64
    and 120 through the executor against the port's models/transformer.apply
    on the same weights on the card (its plain attention), float and NPE-8.
    A routing choice can turn on the last bit of a router probability, and
    the two sum their products in other orders, so the model takes the
    executor's expert ids (`models/moe.ForcedRouting`); where its own top-k differs
    from them, the count and the largest probability gap are reported (a
    near tie), and in float the gap must stay below NPE16_TOL.  Logits
    within FLOAT_TOL / NPE16_TOL or twice the model's own change under
    1-ulp weights (with the same ids), top-1 as `decode_route_check` holds
    a route.  Routing, layer by layer: each layer's input from the model's
    run through `trace_moe_block` against `models/moe.route`, both on the
    card: ids and gates bit for bit, the dispatch buffer bit for bit
    against the model's slots, capacity `moe_capacity` (20 and 37), the
    dropped token-slots reported.  The launches of an NPE-8 execute against
    the graph's, and every kernel call of one at S = 120 held to its plain
    version."""
    import types
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m"), dtype="float32")
    t0 = time.perf_counter()
    model = registry.build_model(cfg, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(0))
    ptree = npec.ParamTree(param_tree_from_model(model), dev)
    routers = ptree.tree["blocks"]["moe"]["router"]
    m = cfg.moe
    say(f"  (c) granite_moe_1b_a400m L={cfg.num_layers} D={cfg.d_model} E={m.num_experts} "
        f"top-{m.top_k}, float32 weights drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(21)
    noisy, out, launches_ = None, {}, {k: 0 for k in KERNELS}
    for S in GRANITE_NPEC_SEQS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to(dev)
        cap = npec.moe_capacity(cfg, S)
        for mode in NPEC_MODES:
            c = MODES[mode](cfg)
            bits = 8 if c.npe_quant else 16
            compiled = npec.compile_model(cfg, S, bits=bits)
            g = compiled.graph
            g.outputs.extend(n.id for n in g.nodes            # each layer's expert ids
                             if n.op == "topk" and n.attrs["out"] == "indices")
            exec_ = lambda: npec.execute(compiled, ptree, {"tokens": toks}, cfg=c,  # noqa: E731
                                         device=dev)
            exec_()
            res, host_ms = timed(exec_)
            got, ids = res.outputs[0], res.outputs[1:]
            with moe_mod.ForcedRouting(ids) as fr, ops.plain_dense_attention():
                want = registry.apply(c, model, toks)
            err = float((got - want).abs().max())
            top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            base_tol = FLOAT_TOL if mode == "float" else NPE16_TOL
            if noisy is None:
                noisy = nudge(model).to(dev)
            with moe_mod.ForcedRouting(ids), ops.plain_dense_attention():
                ref2 = registry.apply(c, noisy, toks)
            noise = float((ref2 - want).abs().max())
            noise_top1 = float((ref2.argmax(-1) == want.argmax(-1)).float().mean())
            gate = max(base_tol, NOISE_FACTOR * noise)
            gate_top1 = min(noise_top1 - TOP1_MARGIN, 0.99) if c.npe_quant else 0.99
            near = mode != "float" or fr.gap <= NPE16_TOL
            # routing, layer by layer, on the card
            ids_equal = gates_equal = buf_equal = True
            dropped = []
            for layer, (x, _) in enumerate(fr.calls):
                block = npec.trace_moe_block(cfg, S, layer=layer, debug_outputs=True)
                bout = npec.execute(block, ptree, {"x": x[0]}, cfg=c, device=dev).outputs
                r = moe_mod.route(c, types.SimpleNamespace(router=routers[layer]), x)
                ids_equal &= torch.equal(bout[2].reshape(-1).long(), r.expert_ids.reshape(-1))
                gates_equal &= same_bits(bout[1].reshape(-1), r.gates.reshape(-1))
                buf = torch.zeros(m.num_experts, r.capacity, cfg.d_model, device=dev)
                kept = r.kept[0]
                buf[r.expert_ids[0][kept], r.slot[0][kept]] = \
                    x[0].repeat_interleave(m.top_k, 0)[kept]
                buf_equal &= same_bits(bout[3], buf)
                dropped.append(int((~r.kept).sum()))
                if r.capacity != cap:
                    raise SystemExit(f"npec granite S={S}: capacity {r.capacity} != {cap}")
            ok = (err <= gate and top1 >= gate_top1 and ids_equal and gates_equal and buf_equal
                  and near and bool(torch.isfinite(got).all()) and len(fr.calls) == cfg.num_layers)
            r_out = dict(max_abs=err, gate=gate, top1=top1, gate_top1=gate_top1,
                         nudge_max_abs=noise, nudge_top1=noise_top1, capacity=cap,
                         own_routing_differs=fr.differ, own_routing_max_gap=fr.gap,
                         dropped_per_layer=dropped, dropped=sum(dropped),
                         token_slots=S * m.top_k * cfg.num_layers,
                         ids_bit_for_bit=ids_equal, gates_bit_for_bit=gates_equal,
                         dispatch_bit_for_bit=buf_equal, host_ms=host_ms, ok=ok)
            say(f"  (c) {mode:10s} S={S}: executor vs models/transformer.apply (plain attention, "
                f"the executor's expert ids) max-abs {err:.3e} (gate {gate:.3e}), top-1 "
                f"{top1:.4f} (gate {gate_top1:.4f}); the model's own top-k differs at "
                f"{fr.differ} of {S * m.top_k * cfg.num_layers} choices (largest probability "
                f"gap {fr.gap:.2e}); routing layer by layer vs models/moe.route: ids "
                f"{'bit for bit' if ids_equal else 'DIFFER'}, gates "
                f"{'bit for bit' if gates_equal else 'DIFFER'}, dispatch "
                f"{'bit for bit' if buf_equal else 'DIFFERS'}; C={cap}, token-slots dropped "
                f"{sum(dropped)} of {r_out['token_slots']}; {host_ms:.1f} ms host an execute"
                + ("" if ok else "  FAIL"))
            if not ok:
                raise SystemExit(f"npec granite S={S} {mode}: the executor disagrees with the "
                                 "model")
            if mode == "npe-8bit":
                n, _ = counted(exec_)
                want_n = every_kernel(npec.expected_launches(g, npe_quant=True, bits=8,
                                                            use_pwl=True))
                for kk in KERNELS:
                    launches_[kk] += n[kk]
                r_out.update(launches=n, expected_launches=want_n)
                if n != want_n:
                    raise SystemExit(f"npec granite S={S}: launches {n} differ from the "
                                     f"graph's {want_n}")
                if S == GRANITE_NPEC_SEQS[-1]:
                    with kept_kernel_calls() as kept_calls:
                        exec_()
                    torch.cuda.synchronize()
                    checked = r_out["kept_calls"] = check_kept_calls(kept_calls)
                    say(f"             launches of one NPE-8 execute {n} (the graph's); every "
                        "kernel call (first at each shape) once more vs its plain version: "
                        + "; ".join(f"{k} {r['calls']} calls max-abs {r['max_abs_err']:.2e}"
                                    for k, r in checked.items()))
                    if not all(r["ok"] for r in checked.values()):
                        raise SystemExit("npec granite: a kernel call disagrees with its "
                                         "plain version")
            out[f"S={S} {mode}"] = r_out
    results["npec_granite"] = dict(out, seconds=time.perf_counter() - t0)
    return launches_


def npec_decoders_phase(dev, results):
    """[11] The npec compiler and executor for the dense and MoE families on
    the card: (a) GLM4-9B served from compiled streams, (b) the executor
    against models/transformer at 2 layers, (c) Granite's MoE prefill
    streams and their routing."""
    t0 = time.perf_counter()
    cfg = get_config("glm4_9b")
    torch.cuda.reset_peak_memory_stats(dev)
    model = registry.build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    t1 = time.perf_counter()
    tree = param_tree_from_model(model)
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    model2 = registry.build_model(cfg2, device=dev, dtype=torch.float32)
    model2.load_state_dict(model.state_dict(), strict=False)
    del model
    torch.cuda.empty_cache()
    say(f"  glm4_9b float32 tree from the bf16 model ([8]'s seed) in {tree_s:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB on the card after the model went "
        f"(peak {peak:.1f} GiB)")
    ptree = npec.ParamTree(tree, dev)
    base = dataclasses.replace(cfg, dtype="float32", num_layers=NPEC_GLM4_LAYERS)
    glm4_n = npec_glm4_serve(dev, ptree, base, results)
    say(f"  ({time.perf_counter() - t0:.1f} s into [11])")
    npec_glm4_check(dev, ptree, model2, results)
    del ptree, tree, model2
    torch.cuda.empty_cache()
    say(f"  ({time.perf_counter() - t0:.1f} s into [11])")
    granite_n = npec_granite(dev, results)
    results["npec_glm4_launches"], results["npec_granite_launches"] = glm4_n, granite_n
    results["npec_decoders_seconds"] = time.perf_counter() - t0
    say(f"  phase [11]: {results['npec_decoders_seconds']:.1f} s")


# --- phases 12-14: RWKV6, the Hymba hybrid, Whisper ---------------------------

# 8 slots, prompts of 7 to 16 tokens prefilled one token a call (the state
# caches take one token a call in the reference's server), 16 steps, 32 rows
FAMILY_MAX_PROMPT, FAMILY_GEN, FAMILY_MAX_SEQ = GEMMA3_MAX_PROMPT, 16, 32
FAMILY_PHASES = {"rwkv6_3b": "[12]", "hymba_1_5b": "[13]", "whisper_base": "[14]"}
# [12] and [13] at 16 of their 32 layers since [16] (the decoders' training)
# joined the script, to keep it inside its budget (full depth took them 45.2
# and 55.6 s on an H100 80GB HBM3 at 700 W); RWKV6 at 8 since (16 took [12]
# 29.5-35.4 s).  Hymba stays at 16: its 16th layer is its global one
FAMILY_LAYERS = {"rwkv6_3b": 8, "hymba_1_5b": 16}


def family_launches(cfg, mode: str, what: str = "step"):
    """Launches of one decode step of `cfg` in `mode` (a prefill: one such
    step a prompt token), or, what="encoder", of Whisper's
    `init_cross_cache`.  RWKV6, L layers: r/k/v/g/o and the channel mix's
    k/v/r a layer and the head; ln_in, two LayerNorms a layer and ln_f;
    tanh twice, silu, the decay, the group norm's rsqrt and the sigmoid a
    layer.  Hymba: q/k/v/o, in/x/out_proj and gate/up/down a layer and the
    head; four RMSNorms a layer and ln_f; silu three times, softplus and
    exp a layer; one dense attention a layer.  Whisper's decoder: self
    q/k/v/o, cross q/o and the MLP's two a layer and the tied head; three
    LayerNorms a layer and ln_f; GELU; self and cross attention.  Its
    encoder: q/k/v/o and the MLP's two a layer, then each decoder layer's
    cross k/v; two LayerNorms a layer and ln_enc; GELU; one causal
    attention a layer.  Float mode launches attention only; NPE-16 no
    MMU kernel."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        n = dict(quant_matmul=8 * L + 1, nvu_layernorm=2 * L + 2, pwl_eval=6 * L,
                 flash_attention=0)
    elif cfg.family == "hybrid":
        n = dict(quant_matmul=10 * L + 1, nvu_layernorm=4 * L + 1, pwl_eval=5 * L,
                 flash_attention=L)
    elif what == "encoder":
        le, ld = cfg.encoder_layers, cfg.decoder_layers
        n = dict(quant_matmul=6 * le + 2 * ld, nvu_layernorm=2 * le + 1, pwl_eval=le,
                 flash_attention=le)
    else:
        ld = cfg.decoder_layers
        n = dict(quant_matmul=8 * ld + 1, nvu_layernorm=3 * ld + 1, pwl_eval=ld,
                 flash_attention=2 * ld)
    n["nvu_softmax"] = 0
    if mode != "npe-8bit":
        n["quant_matmul"] = 0
    if mode == "float":
        n.update(nvu_layernorm=0, pwl_eval=0)
    return every_kernel(n)


def clone_tree(tree):
    """A copy of a cache tree's tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def seeded_frames(cfg, batch: int, device, dtype=torch.float32):
    """Seeded frame embeddings (B, encoder_seq, D) x 0.02 for Whisper's stubbed
    front end, drawn on the CPU so that both routes get the same values."""
    g = torch.Generator().manual_seed(7)
    x = 0.02 * torch.randn(batch, cfg.encoder_seq, cfg.d_model, generator=g)
    return x.to(device=device, dtype=dtype)


# (cell, M, K, N) of the last families' NPE-8 products: RWKV6's channel-mix k
# and v and its head; Hymba's in_proj, x_proj (N = dt_rank 100 + 2 x 16) and
# out_proj; Whisper's decoder MLP up, its encoder's (8 x 1500 rows) MLP
FAMILY_PRODUCTS = [
    ("rwkv6", 8, 2560, 8960), ("rwkv6", 8, 8960, 2560), ("rwkv6", 8, 2560, 65536),
    ("hymba", 8, 1600, 6400), ("hymba", 8, 3200, 132), ("hymba", 8, 3200, 1600),
    ("whisper", 8, 512, 2048), ("whisper", 12000, 512, 2048), ("whisper", 12000, 2048, 512),
]


def family_kernel_rows(dev, g, row):
    """The MMU at RWKV6's, Hymba's and Whisper's products (FAMILY_PRODUCTS),
    bf16 out; the layernorm kernel at RWKV6's (8, 2560) and Whisper's
    encoder (12000, 512) rows with beta (eps 1e-5 and 1e-6) and Hymba's
    (8, 1600) RMSNorm; `pwl_eval` at the new tables' shapes: RWKV6's decay
    exp(-exp(x)) (8, 2560) bf16, Mamba's exp (8 x 3200, 16) f32 and the group
    norm's rsqrt on (8 x 40, 1) f32 mantissas, bit for bit against the
    walk.  Their dense-mode rows are in MASK_ROWS."""
    import torch.nn.functional as F
    for cell, m, k, n in FAMILY_PRODUCTS:
        xq = quantize(torch.randn(m, k, generator=g, device=dev), 8)
        wq = quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, 8, axis=1)
        a, b = xq.q.contiguous(), wq.q.contiguous()
        lib_a = torch.cat([a, a.new_zeros(32 - m, k)]) if m < 32 else a  # _int_mm: M > 16
        lib_b = b if n % 8 == 0 else torch.cat([b, b.new_zeros(k, 8 - n % 8)], 1)
        row("quant_matmul", f"({m}, {k}) @ ({k}, {n})", torch.bfloat16,
            lambda: qm_mod.quant_matmul(a, b, xq.scale, wq.scale, out_dtype=torch.bfloat16),
            lambda: qm_mod.quant_matmul_plain(a, b, xq.scale, wq.scale, None, torch.bfloat16),
            m * k + k * n + 4 + 4 * n + m * n * 2, [(2 * m * n * k, INT8_OPS_PER_S)],
            library_fn=lambda: torch._int_mm(lib_a, lib_b),
            library_name="torch._int_mm" + (", rows zero-padded to 32" if m < 32 else "")
            + (", columns to a multiple of 8" if n % 8 else ""), cell=cell)
        del xq, wq, a, b, lib_a, lib_b
    for cell, m, n, eps, rms in (("rwkv6", 8, 2560, 1e-5, False),
                                 ("whisper", 12000, 512, 1e-6, False),
                                 ("hymba", 8, 1600, 1e-6, True)):
        x = (torch.randn(m, n, generator=g, device=dev) * 2 + 0.3).to(torch.bfloat16)
        gam = 1 + 0.1 * torch.randn(n, generator=g, device=dev)
        bet = None if rms else 0.1 * torch.randn(n, generator=g, device=dev)
        row("nvu_layernorm", f"({m}, {n})" + (" rms_only" if rms else " beta"), torch.bfloat16,
            lambda: ln_mod.nvu_layernorm(x, gam, bet, eps=eps, rms_only=rms),
            lambda: ln_mod.nvu_layernorm_plain(x, gam, bet, eps=eps, rms_only=rms),
            x.numel() * 2 * x.element_size() + (1 if rms else 2) * n * 4,
            [(x.numel() * (4 if rms else 8) + m * (pwl_ops("rsqrt") + 8), F32_OPS_PER_S)],
            yardstick_fn=None if rms else (lambda: F.layer_norm(
                x, (n,), gam.to(x.dtype), bet.to(x.dtype), eps=eps)),
            yardstick_name=None if rms else "F.layer_norm", cell=cell)
    for cell, name, shape, dt in (("rwkv6", "exp_neg_exp", (8, 2560), torch.bfloat16),
                                  ("hymba", "exp", (25600, 16), torch.float32),
                                  ("rwkv6", "rsqrt", (320, 1), torch.float32)):
        if name == "rsqrt":                                # mantissas in [0.25, 1)
            x = (0.25 + 0.75 * torch.rand(*shape, generator=g, device=dev)).to(dt)
        elif name == "exp":                                # dt * A <= 0
            x = (-4 * torch.rand(*shape, generator=g, device=dev)).to(dt)
        else:
            x = torch.randn(*shape, generator=g, device=dev).to(dt)
        tab = pe_mod.device_table(name, 16, dev)
        row("pwl_eval", f"{shape} {name}", dt,
            lambda: pe_mod.pwl_eval(x, name),
            lambda: pe_mod.pwl_eval_plain(x, get_table(name, 16)),
            x.numel() * 2 * x.element_size(),
            [(x.numel() * pwl_prefix_ops(name), F32_OPS_PER_S)],
            walk_fn=lambda: pe_mod.pwl_eval_walk(x, tab).to(x.dtype), cell=cell)


def logits_corr(cfg, model, prompts, mode, dev) -> float:
    """Correlation of `mode`'s logits with float's over the forward (`apply`)
    of the prompts cut to their shortest length, the reference's measure
    (tests/test_npe_accuracy.py: above 0.98 at smoke size)."""
    n = min(map(len, prompts))
    tok = torch.as_tensor(np.stack([p[:n] for p in prompts]), device=dev).long()
    base = registry.apply(cfg, model, tok).float().flatten()
    other = registry.apply(MODES[mode](cfg), model, tok).float().flatten()
    return float(torch.corrcoef(torch.stack([base, other]))[0, 1])


CROSS_CHECK_LAYERS = dict(encoder_layers=2, decoder_layers=2)
CROSS_CHECK_MODES = ("float", "npe-8bit")


def cross_cache_cpu():
    """The CPU half of `cross_cache_check` (run by `CpuRoutes`): the plain
    route's cross cache in each mode, and its change under 1-ulp weights."""
    cfg = dataclasses.replace(get_config("whisper_base"), **CROSS_CHECK_LAYERS)
    model = route_model(cfg)
    noisy = nudge(model)
    fr = seeded_frames(cfg, 2, "cpu")
    out = {}
    for mode in CROSS_CHECK_MODES:
        c = MODES[mode](cfg)
        want = encdec_mod.init_cross_cache(c, model, fr)
        ref2 = encdec_mod.init_cross_cache(c, noisy, fr)
        out[mode] = dict(want={k: want[k].float().numpy() for k in "kv"},
                         noise=max(float((ref2[k].float() - want[k].float()).abs().max())
                                   for k in "kv"))
    return out


def cross_cache_check(dev, results):
    """Whisper's encoder and cross K/V (`init_cross_cache`) on the card against
    the CPU's plain route (`cross_cache_cpu`) on the same bf16 weights (the
    model's own dtype: the card's attention takes bf16 k and v), full width
    cut to 2 encoder and 2 decoder layers, over 2 seeded frame batches (2 x
    1500 rows), float and NPE-8; the gate is the decode route check's,
    against the CPU route's own change under 1-ulp weights."""
    cfg = dataclasses.replace(get_config("whisper_base"), **CROSS_CHECK_LAYERS)
    cpu, seconds = CPU_ROUTES.result("whisper_cross_check")
    card_model = registry.build_model(cfg, device=dev)
    card_model.load_state_dict(route_model(cfg).state_dict())
    fr = seeded_frames(cfg, 2, dev)
    out = {}
    for mode in CROSS_CHECK_MODES:
        got = encdec_mod.init_cross_cache(MODES[mode](cfg), card_model, fr)
        want, noise = ({k: torch.from_numpy(a) for k, a in cpu[mode]["want"].items()},
                       cpu[mode]["noise"])
        err = max(float((got[k].cpu().float() - want[k]).abs().max()) for k in "kv")
        ulp = float(np.mean([((got[k].cpu().float() - want[k]).abs()
                              <= want[k].abs() * BF16_RTOL).float().mean() for k in "kv"]))
        gate = max(NOISE_FACTOR * noise, FLOAT_TOL if mode == "float" else NPE16_TOL)
        ok = err <= gate and all(bool(torch.isfinite(got[k].float()).all()) for k in "kv")
        out[mode] = dict(max_abs=err, gate=gate, noise_max_abs=noise, within_one_ulp=ulp, ok=ok)
        say(f"  {mode:10s} whisper cross cache (encoder + cross k/v, bf16, 2+2 layers, 2 x 1500 "
            f"frames), card kernels vs CPU plain route: max-abs {err:.3e} (gate {gate:.3e}; "
            f"CPU under 1-ulp weights {noise:.3e}), {ulp:.4f} of the values within one bf16 ulp"
            + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"whisper {mode}: the card's cross cache disagrees with the CPU's")
    del card_model
    results["whisper_cross_check"] = dict(out, cpu_seconds=seconds)


def family_phase(dev, card, results, arch):
    """One of the last families at full width and depth (bf16, random
    weights from a torch generator) through `launch.serve.Server`: (a) 8
    slots, prompts of 7 to 16 tokens prefilled one token a call, 16 greedy
    steps, a 32-row cache, in float and NPE-8, NPE-16 for one step and one
    prefill; Whisper's cross cache first, by `init_cross_cache` over 8
    seeded frame batches in the server's mode, its launches checked and its
    host and device-busy ms printed; (b) the launches of a step, a prefill
    and the served run checked exactly (`family_launches`); (c) every launch
    of one NPE-8 step (and Whisper's NPE-8 encoder) held to its plain
    version; (d) one NPE-8 step profiled, with its device launches; (e)
    NPE-8's teacher-forced top-1 agreement with float (from the cache its
    served prefills left), and the NPE-8 and NPE-16 logits' correlation
    with float (RWKV6, Hymba), reported; (f) the route check (float32, 2
    layers, prompts of 4 and 2 tokens, prefill plus 4 steps, float and
    NPE-8; Hymba's ring cut to 4 rows, so that both routes wrap it) and
    Whisper's cross cache on the card against the CPU."""
    key, label = arch.split("_")[0], FAMILY_PHASES[arch]
    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS[arch])
    reqs = SyntheticRequests(cfg.vocab_size, max_prompt=FAMILY_MAX_PROMPT, seed=1)
    prompts = [reqs.request(i) for i in range(SLOTS)]
    start = max(len(p) for p in prompts)
    t0 = time.perf_counter()
    since = lambda: f"({time.perf_counter() - t0:.1f} s into {label})"   # noqa: E731
    model = registry.build_model(cfg, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  {arch} L={cfg.num_layers} D={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}, {n_params:,} parameters "
        f"({torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB on the card); {SLOTS} slots, "
        f"prompts of {[len(p) for p in prompts]} tokens one a call, {FAMILY_GEN} steps from "
        f"position {start}, cache of {FAMILY_MAX_SEQ} rows")
    out, servers, enc, prefilled = {}, {}, {}, {}
    fill = None
    if cfg.family == "encdec":
        frames = seeded_frames(cfg, SLOTS, dev, torch.bfloat16)

        def fill(srv):
            srv.cache["cross"] = encdec_mod.init_cross_cache(srv.cfg, model, frames)
    for mode in ("float", "npe-8bit", "npe-16bit"):
        srv = servers[mode] = Server(arch, batch=SLOTS, max_seq=FAMILY_MAX_SEQ, mode=mode,
                                     device=dev, model=model)
        if fill is not None:                # the encoder, in this mode
            fill(srv)                       # warm-up
            want = family_launches(srv.cfg, mode, "encoder")
            host = []
            for _ in range(3):
                t1 = time.perf_counter()
                n, _ = counted(lambda: fill(srv))
                host.append(1e3 * (time.perf_counter() - t1))
                if n != want:
                    raise SystemExit(f"whisper {mode}: encoder launches {n} differ from {want}")
            prof = profile_call(lambda: fill(srv), sorted(host)[1])
            enc[mode] = dict(prof, launches=n, host_ms_runs=host)
            idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
            say(f"  {mode:10s} encoder + cross k/v of {SLOTS} x {cfg.encoder_seq} frames: "
                f"{prof['host_ms']:.3f} ms host (median of 3), {prof['device_busy_ms']:.3f} ms "
                f"device busy, idle share {idle}; launches {n}")
        if mode == "npe-16bit":
            srv.prefill_prompt(0, prompts[0][:2])          # warm-up
            out[mode] = {}
            continue
        srv.generate([prompts[0][:2]], gen_tokens=1)       # warm-up
        srv.cache = registry.init_cache(srv.cfg, SLOTS, FAMILY_MAX_SEQ, dev)
        if fill is not None:
            fill(srv)
        step_fn = srv.decode
        if mode == "npe-8bit":              # keep the cache the prefills leave
            def srv_decode(m, cache, cur, pos, step_fn=step_fn):
                prefilled.setdefault("cache", clone_tree(cache))
                return step_fn(m, cache, cur, pos)
            srv.decode = srv_decode
        counts, stats = counted(lambda: srv.generate(prompts, gen_tokens=FAMILY_GEN))
        srv.decode = step_fn
        rep = stats.report()
        toks = stats.generated
        if toks.shape != (SLOTS, FAMILY_GEN) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"{arch} {mode}: generated tokens of shape {toks.shape} "
                             "or out of range")
        out[mode] = dict(rep, generated=toks.tolist(), run_launches=counts, step_ms=stats.step_ms)
        say(f"  {mode:10s} prefill {rep['prefill_ms_per_slot']:9.3f} ms per slot "
            f"({sum(map(len, prompts)) / SLOTS:.1f} one-token calls), decode "
            f"{rep['decode_ms_per_step']:8.3f} ms per step (median of {FAMILY_GEN}), "
            f"{rep['tokens_per_sec']:8.1f} tokens/s, on {card} {since()}")
    cur = torch.as_tensor(np.asarray(out["npe-8bit"]["generated"])[:, -1:], device=dev)
    pos = start + FAMILY_GEN - 1            # the last step's position, once more
    for mode, srv in servers.items():
        t1 = time.perf_counter()
        prefill, _ = counted(lambda: srv.prefill_prompt(0, prompts[0]))
        prefill_ms = 1e3 * (time.perf_counter() - t1)
        t1 = time.perf_counter()
        step, (logits, _) = counted(
            lambda: registry.decode_step(srv.cfg, model, srv.cache, cur, pos))
        step_ms = 1e3 * (time.perf_counter() - t1)
        check_logits(logits, (SLOTS, 1, cfg.vocab_size), f"{arch} {mode} step")
        out[mode].update(step_launches=step, prefill_launches=prefill,
                         one_prefill_ms=prefill_ms, one_step_ms=step_ms)
        say(f"  {mode:10s} launches of one step {step}, of one one-slot prefill of "
            f"{len(prompts[0])} tokens {prefill} ({prefill_ms:.1f} ms; the step {step_ms:.1f} ms)")
        want = family_launches(srv.cfg, mode)
        if step != want or prefill != {k: n * len(prompts[0]) for k, n in want.items()}:
            raise SystemExit(f"{arch} {mode}: launches of a step or a prefill differ from {want}")
        if mode != "npe-16bit":
            runs = sum(map(len, prompts)) + FAMILY_GEN
            if out[mode]["run_launches"] != {k: n * runs for k, n in want.items()}:
                raise SystemExit(f"{arch} {mode}: launches of the served run differ from "
                                 f"{runs} x {want}")
    results[key] = out
    results[f"{key}_launches"] = out["npe-8bit"]["run_launches"]
    if enc:
        results["whisper_encoder"] = enc
        results["whisper_encoder_launches"] = enc["npe-8bit"]["launches"]

    npe8 = servers["npe-8bit"]
    results[f"{key}_audit"] = audit_call(
        lambda: registry.decode_step(npe8.cfg, model, npe8.cache, cur, pos),
        f"{since()} one NPE-8 {arch} decode step", family_launches(npe8.cfg, "npe-8bit"))
    if fill is not None:
        results["whisper_encoder_audit"] = audit_call(
            lambda: fill(npe8), f"{since()} the NPE-8 whisper encoder and cross k/v",
            family_launches(npe8.cfg, "npe-8bit", "encoder"))
    prof = results[f"{key}_profile"] = profile_call(
        lambda: registry.decode_step(npe8.cfg, model, npe8.cache, cur, pos),
        out["npe-8bit"]["decode_ms_per_step"])
    say_profile_step(f"NPE-8 {arch} decode step", prof)
    say(f"  device launches of that step (kernels and copies): {prof['device_launches']}")
    feed = np.asarray(out["float"]["generated"])
    agree = {"npe-8bit": float((teacher_forced(npe8, prompts, feed, cache=prefilled["cache"])
                                == feed).mean())}
    results[f"{key}_agreement"] = agree
    say(f"  {since()} {arch} NPE-8 top-1 agreement with the float route's tokens, fed them "
        f"(reported, not gated; float's own is 1 by construction): {agree['npe-8bit']:.4f}")
    if cfg.family in ("ssm", "hybrid"):
        corr = results[f"{key}_logits_corr"] = {
            mode: logits_corr(servers["float"].cfg, model, prompts, mode, dev)
            for mode in ("npe-8bit", "npe-16bit")}
        say(f"  {arch} logits' correlation with float over the forward of the {SLOTS} prompts "
            f"cut to {min(map(len, prompts))} tokens (reported; the reference finds RWKV6 "
            "NPE-8 and Hymba NPE-16 above 0.98 at smoke size): "
            + ", ".join(f"{m} {c:.5f}" for m, c in corr.items()))
    del servers, srv, npe8, model
    torch.cuda.empty_cache()
    say(f"  {since()} the route check:")
    decode_route_check(dev, results, f"{key}_route_check")
    if cfg.family == "encdec":
        cross_cache_check(dev, results)
    results[f"{key}_seconds"] = time.perf_counter() - t0
    say(f"  {since()} done")


# --- the CPU halves of the route checks, beside the card's phases -----------

# --- phase 15: training -------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_FLOAT_STEPS, TRAIN_NPE_STEPS = 50, 2
# the float run checkpoints at step 0 and at its end alone (each save is 1.3
# GB on a thread beside the steps); the crash at step 3 rewinds to step 0
TRAIN_CRASH_AT = 3
# The optimizer of [15]: AdamW without weight decay, so only the gradients
# can lower the loss, with b1 0 and eps 1 (above every gradient entry after
# the clip to norm 1): the step is lr times the clipped gradient, SGD.
# SyntheticLM's next token is an affine function of the previous one, and
# the labels are the tokens one position on, but at BERT-base's widths
# neither route learns that in the steps a smoke run can take: under the
# reference's own AdamW (eps 1e-8, lr 1e-3, weight decay 0.1) its loss rises
# from 10.49 to 10.5-10.9 over 150-300 steps, and the port's with it within
# 0.02 (scripts/train_curve_vs_reference.py at 2 layers on the CPU; float32
# without remat the same as bf16 with remat on the card:
# scripts/train_probe.py).  At the start each position's logits favour its
# own input token (post-norm layers, a tied head), 0.15 above ln V = 10.33;
# these steps take that away, through a rise in the first 10 steps, to
# 10.34 by step 40 (PERF.md §6).
TRAIN_OPT = dict(lr=5.0, warmup_steps=5, schedule="constant", b1=0.0, eps=1.0,
                 weight_decay=0.0)
# launches of one NPE-8 train step of BERT-base (12 layers, remat "block"):
# the forward (73 products, 25 norms, 12 softmaxes and GELUs), each layer's
# forward once more in the backward pass (72, 24, 12, 12), and the backward
# passes: one more product a dense for its int32 product, one backward of
# each GELU, softmax and norm
def train_launch_counts(layers: int = 12):
    """(forward, backward, all) launches of one NPE-8 BERT train step."""
    fwd = {"quant_matmul": 12 * layers + 1, "nvu_layernorm": 4 * layers + 1,
           "nvu_softmax": 2 * layers, "pwl_eval": 2 * layers, "flash_attention": 0}
    bwd = {"quant_matmul": 6 * layers + 1, "pwl_eval_grad": layers, "nvu_softmax_grad": layers,
           "nvu_layernorm_grad": 2 * layers + 1}
    return (every_kernel(fwd), bwd,
            every_kernel({k: fwd.get(k, 0) + bwd.get(k, 0) for k in KERNELS}))


TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_LAUNCHES = train_launch_counts()
# the route check: full width at 2 layers, float32, 2 x 128 tokens, 512
# positions (BERT's own; the config's 32768 is structural), one step
TRAIN_ROUTE_BATCH, TRAIN_ROUTE_POSITIONS = 2, 512
TRAIN_ROUTE_FLOOR = 1e-6    # of a tree's largest value: below it lie rounding residues
TRAIN_ROUTE_MODES = ("float", "npe-16bit", "npe-8bit")
# the backward kernels' rows in the kernels line, and what each differentiates
GRAD_MAIN_ROWS = {"pwl_eval_grad": "(1024, 3072) gelu",
                  "nvu_softmax_grad": "(12288, 128) scale 0.125 dy bf16",
                  "nvu_layernorm_grad": "(1024, 768)"}
# (the TPU kernel has no backward: XLA differentiates the jnp code it fuses)
GRAD_REFERENCE = {"pwl_eval_grad": "src/repro/core/nvu.py:40",
                  "nvu_softmax_grad": "src/repro/core/nvu.py:154",
                  "nvu_layernorm_grad": "src/repro/core/nvu.py:185"}


class GradAudit:
    """Wrap the backward passes the training path calls through `ops` so
    that every launch is also computed by its plain backward on the same
    operands (`quant_matmul_scale_grad`: its int32 product by `int_matmul`;
    the dense mode's backward held by `attn_grad_check`)."""

    NAMES = ("pwl_eval_grad", "nvu_softmax_grad", "nvu_layernorm_grad",
             "quant_matmul_scale_grad", "dense_attention_grad")

    def __init__(self):
        self.stats = {k: [0, 0.0, True] for k in self.NAMES}
        self.shapes = {k: set() for k in self.NAMES}   # (rows, n) of each launch's x
        self.saved = {}

    def _wrap(self, attr, plain, bf16):
        kernel = getattr(ops, attr)

        def fn(*args, **kw):
            got = kernel(*args, **kw)
            self.shapes[attr].add(tuple(args[0].shape))
            err, ok = grad_check(lambda: plain(*args, **kw), bf16=bf16(args))(got)
            st = self.stats[attr]
            st[0] += 1
            st[1] = max(st[1], err)
            st[2] = st[2] and ok
            return got
        return fn

    def __enter__(self):
        is_bf16 = lambda args: args[0].dtype == torch.bfloat16
        plains = {
            "pwl_eval_grad": (lambda x, dy, name, segments=16, clamped=False:
                              pe_mod.pwl_eval_grad_plain(x, dy, get_table(name, segments),
                                                         clamped), is_bf16),
            "nvu_softmax_grad": (sm_mod.nvu_softmax_grad_plain, lambda args: False),
            "nvu_layernorm_grad": (ln_mod.nvu_layernorm_grad_plain, is_bf16),
            "quant_matmul_scale_grad": (qm_mod.quant_matmul_scale_grad_plain, lambda args: False),
        }
        for attr, (plain, bf16) in plains.items():
            self.saved[attr] = getattr(ops, attr)
            setattr(ops, attr, self._wrap(attr, plain, bf16))
        kernel = ops.dense_attention_grad
        self.saved["dense_attention_grad"] = kernel

        def attn(q, k, v, do, **kw):
            got = kernel(q, k, v, do, **kw)
            err, ok = attn_grad_check(q, k, v, do, kw, got)
            st = self.stats["dense_attention_grad"]
            st[0] += 1
            st[1] = max(st[1], err)
            st[2] = st[2] and ok
            return got
        ops.dense_attention_grad = attn
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(ops, attr, fn)


def train_run(mode, steps, ckpt_dir, crash_at=-1, moment_dtype="float32"):
    """BERT-base at full width and depth (float32 masters, bf16 compute,
    remat "block") in `mode`, trained on SyntheticLM(30720, 128, 8) through
    `launch.train`; checkpoints at step 0 and at the end."""
    run = train_mod.make_run("bert_base", False, steps, TRAIN_BATCH, TRAIN_SEQ,
                             npe=mode != "float", bits=16 if mode == "npe-16bit" else 8,
                             ckpt_dir=ckpt_dir,
                             fault=FaultConfig(inject_crash_at_step=crash_at, max_restarts=2),
                             opt=OptimizerConfig(decay_steps=steps, moment_dtype=moment_dtype,
                                                 **TRAIN_OPT))
    return dataclasses.replace(run, checkpoint=dataclasses.replace(run.checkpoint, interval=0))


def checkpoint_roundtrip(trainer, directory):
    """(save s, restore s, bit for bit, leaves, dtypes): the trainer's state
    saved synchronously and restored onto the card."""
    ck = Checkpointer(directory, keep=1, async_save=False)
    state = trainer.state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(10_000, state)
    t1 = time.perf_counter()
    back, _ = ck.restore(state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pairs = list(zip(tree_mod.leaves(state), tree_mod.leaves(back)))
    same = all(a.dtype == b.dtype and a.shape == b.shape and same_bits(a, b) for a, b in pairs)
    dtypes = sorted({str(a.dtype).replace("torch.", "") for a, _ in pairs})
    return t1 - t0, t2 - t1, same, len(pairs), dtypes


def train_mode(dev, card, mode, steps, ckpt_root, crash_at=-1, moment_dtype="float32",
               roundtrip=True):
    """Train one mode; print and return its numbers (with `roundtrip`, the
    checkpoint's save and restore too)."""
    run = train_run(mode, steps, str(Path(ckpt_root) / mode), crash_at, moment_dtype)
    torch.cuda.reset_peak_memory_stats()
    logs = []
    trainer = train_mod.Trainer(run, log=logs.append, device=dev)
    t0 = time.perf_counter()
    out = trainer.train()
    wall = time.perf_counter() - t0
    losses = {}
    for h in out["history"]:
        losses[h["step"]] = h["loss"]
    secs = [h["sec"] for h in out["history"][1:]]
    host_ms = 1e3 * float(np.median(secs)) if secs else 1e3 * out["history"][0]["sec"]
    batch = trainer.batch_at(0)
    prof = profile_call(lambda: trainer.step_fn(trainer.model, trainer.opt_state, batch),
                        host_ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    save_s = restore_s = same = n = dtypes = None
    if roundtrip:
        save_s, restore_s, same, n, dtypes = checkpoint_roundtrip(
            trainer, str(Path(ckpt_root) / f"{mode}-roundtrip"))
    finite = all(np.isfinite(v) for v in losses.values())
    r = dict(steps=steps, losses=[losses[s] for s in sorted(losses)], host_ms=host_ms,
             device_busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
             device_launches=prof["device_launches"], top=prof["top"],
             tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (host_ms / 1e3), peak_gib=peak,
             wall_s=wall, restarts=out["restarts"],
             fault_events=[dataclasses.asdict(e) for e in out["fault_events"]],
             save_s=save_s, restore_s=restore_s, restored_bit_for_bit=same, leaves=n,
             state_dtypes=dtypes, finite=finite, moment_dtype=moment_dtype)
    idle = "not measured" if r["idle_share"] is None else f"{r['idle_share']:.3f}"
    say(f"  {mode:10s} {steps} steps in {wall:.1f} s: loss {r['losses'][0]:.4f} -> "
        f"{r['losses'][-1]:.4f}; {host_ms:.1f} ms a step host clock (median), "
        f"{r['device_busy_ms']:.1f} ms device busy (torch.profiler, {r['device_launches']} "
        f"device launches), idle share {idle}, {r['tokens_per_s']:.0f} tokens/s, peak "
        f"{peak:.2f} GiB, restarts {out['restarts']} on {card}")
    if roundtrip:
        say(f"             checkpoint of {n} leaves ({', '.join(dtypes)}): save {save_s:.2f} s, "
            f"restore {restore_s:.2f} s, restored {'bit for bit' if same else 'DIFFERENT'}")
    for line in logs:
        if line.startswith("[recover]"):
            say(f"             {line}")
    if not finite:
        raise SystemExit(f"{mode}: a training loss is not finite")
    if roundtrip and not same:
        raise SystemExit(f"{mode}: the restored checkpoint differs from the saved state")
    return trainer, r


def train_launches(dev, trainer):
    """One more NPE-8 train step with every launch counted and held to its
    plain version (forward: `Audit`; backward: `GradAudit`)."""
    batch = trainer.batch_at(1)
    reset_launches()
    with Audit() as fwd, GradAudit() as bwd:
        trainer.model, trainer.opt_state, _ = trainer.step_fn(trainer.model, trainer.opt_state,
                                                              batch)
        torch.cuda.synchronize()
    counts = launches()
    fwd_n = fwd.counts()
    bwd_n = {"quant_matmul": bwd.stats["quant_matmul_scale_grad"][0],
             **{k: bwd.stats[k][0] for k in GRAD_MAIN_ROWS}}
    say(f"  launches of one NPE-8 train step: {counts} (expected {TRAIN_LAUNCHES}); forward, "
        f"each layer's twice (remat): {fwd_n}; backward: {bwd_n}")
    say("  every launch vs its plain version on its operands: " + ", ".join(
        f"{k} {n} max-abs {e:.2e} {'ok' if ok else 'FAIL'}"
        for k, (n, e, ok) in list(fwd.stats.items()) + list(bwd.stats.items()) if n))
    ok = (counts == TRAIN_LAUNCHES and fwd_n == TRAIN_FORWARD and bwd_n == TRAIN_BACKWARD
          and all(st[2] for st in list(fwd.stats.values()) + list(bwd.stats.values())))
    if not ok:
        raise SystemExit("the NPE-8 train step's launches differ from expected or from "
                         "their plain versions")
    return dict(counts=counts, forward=fwd_n, backward=bwd_n,
                audit={k: dict(launches=n, max_abs_err=e, ok=o) for k, (n, e, o) in
                       list(fwd.stats.items()) + list(bwd.stats.items())})


def train_route_setup():
    cfg = dataclasses.replace(get_config("bert_base"), num_layers=2, dtype="float32",
                              max_position=TRAIN_ROUTE_POSITIONS)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=4)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_ROUTE_BATCH, seed=4).batch_at(0)
    return cfg, opt, batch


def train_route_step(c, opt, batch, model):
    """One train step of `model` in config `c`: {"loss", "grads", "params",
    "m", "v"}, the trees float32 tensors on the model's device by
    parameter name."""
    run = RunConfig(model=c, shape=ShapeConfig("route", "train", TRAIN_SEQ, TRAIN_ROUTE_BATCH),
                    mesh=SMOKE_MESH, optimizer=opt)
    model.requires_grad_(True)
    state = adamw.init(opt, trainable(model))
    dev = next(model.parameters()).device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    model, state, met = build_train_step(run, keep_grads=True)(model, state, b)
    f = lambda t: t.detach().float()
    return dict(loss=float(met["loss"]), grads={k: f(v) for k, v in met["grads"].items()},
                params={k: f(p) for k, p in trainable(model).items()},
                m={k: f(v) for k, v in state.m.items()}, v={k: f(v) for k, v in state.v.items()})


TRAIN_TREES = ("grads", "params", "m", "v")


def train_route_cpu(directory):
    """The CPU half of the training route check (run by `CpuRoutes`): one
    plain-route train step in each mode, and the same from weights moved by
    one ulp up and one down; the step's trees go to `directory` (npz, too
    large for the queue), the loss and each leaf's largest change under
    either nudge are returned."""
    cfg, opt, batch = train_route_setup()
    out = {}
    for mode in TRAIN_ROUTE_MODES:
        c = MODES[mode](cfg)
        want = train_route_step(c, opt, batch, route_model(cfg))
        others = [train_route_step(c, opt, batch, nudge(route_model(cfg), toward))
                  for toward in (float("inf"), float("-inf"))]
        noise = {t: {k: max(float((o[t][k] - want[t][k]).abs().max()) for o in others)
                     for k in want[t]} for t in TRAIN_TREES}
        np.savez(Path(directory) / f"{mode}.npz",
                 **{f"{t}/{k}": a.numpy() for t in TRAIN_TREES for k, a in want[t].items()})
        out[mode] = dict(loss=want["loss"], noise=noise,
                         loss_noise=max(abs(o["loss"] - want["loss"]) for o in others))
    return out


def nonzero_flips(a, w, top):
    """Entries above TRAIN_ROUTE_FLOOR * top in either tensor that are zero
    in one and not in the other."""
    big = (a.abs() > TRAIN_ROUTE_FLOOR * top) | (w.abs() > TRAIN_ROUTE_FLOOR * top)
    return int(((a != 0) & big).ne((w != 0) & big).sum())


def train_route_compare(mode, opt, got, want, plain, nonzero_gate=None):
    """Hold one mode's train step `got` (the kernel route) to `want` (the
    plain route's trees, {"<tree>/<name>": tensor}) and to `plain` (its loss
    and 1-ulp changes, from `train_route_cpu`): each leaf within twice the
    plain route's own change under 1-ulp weights (up or down) plus
    TRAIN_ROUTE_FLOOR of its tree's largest value; in the NPE modes at
    least NPE16_TOL (the loss absolute, as the decode checks gate their
    logits; a leaf relative to its largest value), since an int8 or int16
    rounding that goes the other way moves a value by a whole step.  A
    parameter may differ by as much more as AdamW's first step, lr * g /
    (|g| + eps), moves over its gradient's gate: that step is about lr *
    sign(g), so an entry whose gradient lies within its gate of 0 may step
    either way (up to 2 lr where the gate holds 0: a rounding residue, such
    as the key biases', whose exact gradient is 0).  In NPE-8 the nonzero
    gradient entries above that floor are the same (with `nonzero_gate`,
    at most that many differ).  Also returned: each
    tree's worst share of the 1-ulp gate alone (no NPE floor, no AdamW
    step) and the leaf where it lies, which those two widenings are for."""
    worst, rel, grad_gate, ulp = {}, {}, {}, {}
    flips = 0
    npe = mode != "float"
    loss_gate = max(2 * plain["loss_noise"], NPE16_TOL if npe else 0.0) + 1e-5
    ok = abs(got["loss"] - plain["loss"]) <= loss_gate
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(want[f"grads/{k}"].double()))
                                 for k in got["grads"])))
    clip = min(1.0, opt.grad_clip / max(gnorm, 1e-9)) if opt.grad_clip > 0 else 1.0
    step1 = lambda g: g * clip / ((g * clip).abs() + opt.eps)   # AdamW's first step / lr
    for t in plain["noise"]:                # the trees the CPU half measured
        top = max(float(want[f"{t}/{k}"].abs().max()) for k in got[t])
        for k, a in got[t].items():
            w = want[f"{t}/{k}"]
            scale = float(w.abs().max())
            ulp_gate = 2 * plain["noise"][t][k] + TRAIN_ROUTE_FLOOR * top
            gate = max(2 * plain["noise"][t][k], NPE16_TOL * scale if npe else 0.0)
            gate += TRAIN_ROUTE_FLOOR * top
            diff = (a - w).abs()
            share = float(diff.max()) / ulp_gate if ulp_gate > 0 else 0.0
            if t not in ulp or share > ulp[t][0]:
                ulp[t] = (share, k)
            if t == "grads":
                grad_gate[k] = gate
            if t == "params":
                g, d = want[f"grads/{k}"], grad_gate[k]
                diff = torch.clamp(diff - opt.lr * (step1(g + d) - step1(g - d)), min=0.0)
            err = float(diff.max())
            worst[t] = max(worst.get(t, 0.0), err / gate if gate > 0 else 0.0)
            rel[t] = max(rel.get(t, 0.0), err / scale if scale > 0 else 0.0)
            ok = ok and err <= gate and bool(torch.isfinite(a).all())
            if t == "grads" and mode == "npe-8bit":
                flips += nonzero_flips(a, w, top)
    nonzero_same = flips == 0 if nonzero_gate is None else flips <= nonzero_gate
    return dict(ok=ok and nonzero_same, loss_gate=loss_gate, worst_share_of_gate=worst,
                worst_relative=rel, nonzero_same=nonzero_same if mode == "npe-8bit" else None,
                nonzero_flips=flips if mode == "npe-8bit" else None, nonzero_gate=nonzero_gate,
                worst_share_of_ulp_gate={t: dict(share=v, leaf=k) for t, (v, k) in ulp.items()})


def train_route_check(dev, results, directory):
    """One train step on the card's kernel route against the port's plain
    route on the CPU (`train_route_cpu`, in the second process): BERT-base
    at full width cut to 2 layers, float32, the same weights and batch, in
    float, NPE-16 and NPE-8; the loss, every gradient, the updated
    parameters and both moments, gated by `train_route_compare`.  The CPU's
    trees are compared on the card."""
    cpu, seconds = CPU_ROUTES.result("train_route_check")
    cfg, opt, batch = train_route_setup()
    weights = route_model(cfg).state_dict()
    out = {}
    for mode in TRAIN_ROUTE_MODES:
        c = MODES[mode](cfg)
        model = registry.build_model(cfg, device=dev, dtype=torch.float32)
        model.load_state_dict(weights)
        got = train_route_step(c, opt, batch, model)
        del model
        plain = cpu[mode]
        with np.load(Path(directory) / f"{mode}.npz") as z:
            want = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
        r = train_route_compare(mode, opt, got, want, plain)
        nz = sum(int(torch.count_nonzero(a)) for a in got["grads"].values())
        total = sum(a.numel() for a in got["grads"].values())
        loss = got["loss"]
        del got, want
        ok, worst, rel = r["ok"], r["worst_share_of_gate"], r["worst_relative"]
        out[mode] = dict(r, loss=loss, loss_cpu=plain["loss"], loss_noise=plain["loss_noise"],
                         nonzero_grads=nz, grad_entries=total)
        say(f"  {mode:10s} train step, card kernels vs CPU plain route (float32, 2 layers): loss "
            f"{loss:.6f} vs {plain['loss']:.6f} (gate {r['loss_gate']:.2e}; 1-ulp change "
            f"{plain['loss_noise']:.2e}); worst error as a share of its gate (and of its leaf's "
            "largest value): " + ", ".join(f"{t} {worst[t]:.3f} ({rel[t]:.1e})"
                                            for t in TRAIN_TREES)
            + f"; nonzero gradient entries {nz} of {total} ({nz / total:.2%})"
            + (f", the same set as the CPU's: {r['nonzero_same']}" if mode == "npe-8bit" else "")
            + ("" if ok else "  FAIL"))
        say("             of the 1-ulp gate alone: " + ", ".join(
            f"{t} {v['share']:.3f} ({v['leaf']})" for t, v in r["worst_share_of_ulp_gate"].items()))
        if not ok:
            raise SystemExit(f"{mode}: the training kernel route disagrees with the plain route")
    torch.cuda.empty_cache()
    results["train_route_check"] = dict(out, cpu_seconds=seconds)
    say(f"  (the CPU half took {seconds:.1f} s beside the card's phases)")


def train_phase(dev, card, results):
    """[15]: the Trainer on BERT-base at full width and depth in float (a
    crash injected and recovered, the loss gated on falling below that of
    the first 5 steps and of the first step), NPE-16 (bf16 moments, so the
    checkpoint, saved and restored once more, holds bf16) and NPE-8; one
    NPE-8 step's launches counted and audited; the route check."""
    cfg = get_config("bert_base")
    say(f"  bert_base L={cfg.num_layers} D={cfg.d_model} V={cfg.vocab_size}, float32 masters, "
        f"bf16 compute, remat block, SyntheticLM({cfg.vocab_size}, {TRAIN_SEQ}, {TRAIN_BATCH}), "
        f"AdamW {TRAIN_OPT}")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = {}
    try:
        trainer, out["float"] = train_mode(dev, card, "float", TRAIN_FLOAT_STEPS, root,
                                           crash_at=TRAIN_CRASH_AT, roundtrip=False)
        del trainer
        losses = out["float"]["losses"]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        events = out["float"]["fault_events"]
        say(f"  float: loss of the first step {losses[0]:.4f}, mean of the first 5 steps "
            f"{first:.4f}, of the last 5 {last:.4f}; fault events "
            f"{[(e['step'], e['kind'], e['action']) for e in events]}")
        if not last < min(first, losses[0]):
            raise SystemExit("float training: the loss did not fall")
        if out["float"]["restarts"] != 1 or not events or events[0]["kind"] != "crash":
            raise SystemExit("float training: the injected crash was not recovered once")
        trainer, out["npe-16bit"] = train_mode(dev, card, "npe-16bit", TRAIN_NPE_STEPS, root,
                                               moment_dtype="bfloat16")
        if "bfloat16" not in out["npe-16bit"]["state_dtypes"]:
            raise SystemExit("the NPE-16 checkpoint holds no bf16 leaf")
        del trainer
        trainer, out["npe-8bit"] = train_mode(dev, card, "npe-8bit", TRAIN_NPE_STEPS, root,
                                              roundtrip=False)
        out["npe-8bit_launches"] = train_launches(dev, trainer)
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    results["train"] = out
    results["train_launches"] = out["npe-8bit_launches"]["counts"]
    route_dir = CPU_ROUTES.train_dir
    train_route_check(dev, results, route_dir)

# --- phase 16: training the decoders ----------------------------------------

DEC_TRAIN_BATCH, DEC_TRAIN_SEQ = 4, 1024
# each model of [16]: its label, float / NPE-16 / NPE-8 steps and its
# optimizer (OptimizerConfig fields, the schedule constant), from
# `scripts/train_probe.py loss --steps 16` on the card (PERF.md §6):
# over 16 steps StarCoder2's loss rose under AdamW at lr 1e-3 and fell by
# 0.05-0.11 under lr 3e-5 and under SGD (b1 0, eps 1) at lr 0.5 and 1;
# Granite's fell most under AdamW at lr 1e-3 (0.06) and 0.01-0.02 under SGD
DEC_TRAIN = {
    "starcoder2_3b": dict(label="(a)", steps=(12, 2, 2),
                          opt=dict(lr=0.5, warmup_steps=4, b1=0.0, eps=1.0, weight_decay=0.0)),
    "granite_moe_1b_a400m": dict(label="(b)", steps=(12, 1, 2),
                                 opt=dict(lr=1e-3, warmup_steps=4)),
}
# the route check: full width at 2 layers in the kernels' dtype (bf16
# compute, float32 masters), 1 x 64 tokens (the CPU half in bf16 is slow), one
# step, in float and NPE-8 (NPE-16 runs the kernels of NPE-8 less the MMU;
# [15] checks all three); the gradients and the updated parameters (after
# one step the moments are (1 - b1) g and (1 - b2) g^2 of the gradients
# compared; [15] compares them too), which halves the trees a 2-layer
# StarCoder2 hands over (2 GB each)
DEC_ROUTE_BATCH, DEC_ROUTE_SEQ, DEC_ROUTE_MODES = 1, 64, ("float", "npe-8bit")
DEC_ROUTE_TREES = ("grads", "params")


def dec_train_launch_counts(cfg):
    """(forward, backward, all) launches of one NPE-8 train step of the
    decoder `cfg` with remat "block": each layer's kernels twice in the
    forward (the backward pass runs each layer's forward again), the head
    and the final norm once; in the backward pass one more product a dense
    (its int32 product) and a backward of each activation, router softmax,
    norm and attention."""
    L = cfg.num_layers
    moe = transformer.layer_is_moe(cfg)
    products = norms = acts = routers = 0
    for is_moe in moe:
        products += 4
        norms += 1 + (0 if cfg.parallel_block else 1) + (2 if cfg.qk_norm else 0)
        if is_moe:
            shared = cfg.moe.shared_expert
            products += 3 if shared else 0
            acts += 1 + (1 if shared else 0) + (1 if cfg.moe.router_act == "sigmoid" else 0)
            routers += 1 if cfg.moe.router_act == "softmax" else 0
        else:
            products += 3 if cfg.mlp_type == "gated" else 2
            acts += 1
    fwd = every_kernel({"quant_matmul": 2 * products + 1, "nvu_layernorm": 2 * norms + 1,
                        "pwl_eval": 2 * acts, "nvu_softmax": 2 * routers,
                        "flash_attention": 2 * L})
    bwd = {"quant_matmul": products + 1, "pwl_eval_grad": acts, "nvu_softmax_grad": routers,
           "nvu_layernorm_grad": norms + 1, "flash_attention_grad": L}
    return fwd, bwd, every_kernel({k: fwd.get(k, 0) + bwd.get(k, 0) for k in KERNELS})


def dec_train_run(arch, mode, steps):
    """`arch` at full width and depth (float32 masters, bf16 compute, remat
    "block") in `mode` on SyntheticLM(V, DEC_TRAIN_SEQ, DEC_TRAIN_BATCH)
    through `launch.train`, with DEC_TRAIN's optimizer."""
    run = train_mod.make_run(arch, False, steps, DEC_TRAIN_BATCH, DEC_TRAIN_SEQ,
                             npe=mode != "float", bits=16 if mode == "npe-16bit" else 8,
                             ckpt_dir=tempfile.mkdtemp(prefix="chip_smoke_dec_train_"),
                             opt=OptimizerConfig(decay_steps=steps, schedule="constant",
                                                 **DEC_TRAIN[arch]["opt"]))
    return dataclasses.replace(run, log_every=10 ** 9)


def router_grads(trainer):
    """One more train step with its gradients kept: each MoE layer's router
    gradient's largest entry, and the choices capacity dropped in each
    route call of the step."""
    step = build_train_step(trainer.run, keep_grads=True)
    with DropCounter() as rec:
        trainer.model, trainer.opt_state, met = step(trainer.model, trainer.opt_state,
                                                     trainer.batch_at(trainer.run.steps))
    g = met["grads"]
    names = sorted((n for n in g if n.endswith("moe.router")),
                   key=lambda n: int(n.split(".")[1]))
    return [float(g[n].abs().max()) for n in names], [d for d, _, _ in rec.drops]


def dec_train_mode(dev, card, arch, mode, steps):
    """Train `arch` in `mode` for `steps` steps (no checkpoints: [15] covers
    them, and a 3B state is 51 GB); print and return its numbers.  The last
    mode's trainer is collected first (its closures hold it in reference
    cycles), so that the peak is this mode's own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_mod.Trainer(dec_train_run(arch, mode, steps), log=lambda *a: None, device=dev)
    init_s = time.perf_counter() - t0
    out = trainer.train(checkpoints=False)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in out["history"]]
    secs = [h["sec"] for h in out["history"][1:]] or [out["history"][0]["sec"]]
    host_ms = 1e3 * float(np.median(secs))
    # one more step under torch.profiler in float alone: a profile of a step
    # of 20,000-35,000 launches takes longer than the step
    prof = dict(device_busy_ms=None, idle_share=None, device_launches=None, top=None)
    if mode == "float":
        batch = trainer.batch_at(0)
        prof = profile_call(lambda: trainer.step_fn(trainer.model, trainer.opt_state, batch),
                            host_ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(np.isfinite(v) for v in losses)
    tokens = DEC_TRAIN_BATCH * DEC_TRAIN_SEQ
    shutil.rmtree(trainer.run.checkpoint.directory, ignore_errors=True)   # empty: none written
    r = dict(steps=steps, losses=losses, host_ms=host_ms, first_step_s=out["history"][0]["sec"],
             device_busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
             device_launches=prof["device_launches"], top=prof["top"],
             tokens_per_s=tokens / (host_ms / 1e3), peak_gib=peak, wall_s=wall, init_s=init_s,
             finite=finite)
    busy = ("device busy not measured" if r["device_busy_ms"] is None else
            f"{r['device_busy_ms']:.1f} ms device busy (torch.profiler, "
            f"{r['device_launches']} device launches), idle share " + (
                "not measured" if r["idle_share"] is None else f"{r['idle_share']:.3f}"))
    say(f"  {mode:10s} {steps} steps in {wall:.1f} s (set-up {init_s:.1f} s): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {host_ms:.1f} ms a step host clock (median; "
        f"the first {1e3 * r['first_step_s']:.0f} ms), {busy}, {r['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak:.2f} GiB on {card}")
    if not finite:
        raise SystemExit(f"{arch} {mode}: a training loss is not finite")
    return trainer, r


def dec_train_launches(arch, trainer):
    """One more NPE-8 train step with every launch counted and held to its
    plain version (forward: `Audit`; backward: `GradAudit`, the dense
    mode's backward by its gates)."""
    fwd_want, bwd_want, all_want = dec_train_launch_counts(trainer.run.model)
    batch = trainer.batch_at(trainer.run.steps + 1)
    reset_launches()
    with Audit() as fwd, GradAudit() as bwd:
        trainer.model, trainer.opt_state, _ = trainer.step_fn(trainer.model, trainer.opt_state,
                                                              batch)
        torch.cuda.synchronize()
    counts = launches()
    fwd_n = fwd.counts()
    bwd_n = {"quant_matmul": bwd.stats["quant_matmul_scale_grad"][0],
             **{k: bwd.stats[k][0] for k in GRAD_MAIN_ROWS},
             "flash_attention_grad": bwd.stats["dense_attention_grad"][0]}
    say(f"  launches of one NPE-8 train step: {counts} (expected {all_want}); forward, each "
        f"layer's twice (remat): {fwd_n}; backward: {bwd_n}")
    # the shapes [3]'s decoder rows of the two NVU backward kernels take
    cell = next(c for c, a in TRAINED_CELLS.items() if a == arch)
    rows3 = {"pwl_eval_grad": {(m, n) for _, m, n, c in PWL_GRAD_ROWS if c == cell},
             "nvu_layernorm_grad": {(m, n) for m, n, _, _, c in LN_GRAD_ROWS if c == cell}}
    for name, want in rows3.items():
        seen = sorted(bwd.shapes[name])
        say(f"  {name} shapes of the step: {seen}; [3]'s {cell} rows {sorted(want)} "
            + ("among them" if want <= set(seen) else "NOT AMONG THEM"))
    say("  every launch vs its plain version on its operands: " + ", ".join(
        f"{k} {n} max-abs {e:.2e} {'ok' if ok else 'FAIL'}"
        for k, (n, e, ok) in list(fwd.stats.items()) + list(bwd.stats.items()) if n))
    ok = (counts == all_want and fwd_n == fwd_want and bwd_n == bwd_want
          and all(st[2] for st in list(fwd.stats.values()) + list(bwd.stats.values())))
    if not ok:
        raise SystemExit(f"{arch}: the NPE-8 train step's launches differ from expected or "
                         "from their plain versions")
    return dict(counts=counts, forward=fwd_n, backward=bwd_n,
                audit={k: dict(launches=n, max_abs_err=e, ok=o) for k, (n, e, o) in
                       list(fwd.stats.items()) + list(bwd.stats.items())})


def dec_route_setup(arch):
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=4)
    batch = SyntheticLM(cfg.vocab_size, DEC_ROUTE_SEQ, DEC_ROUTE_BATCH, seed=4).batch_at(0)
    return cfg, opt, batch


def dec_route_model(cfg):
    """The route check's float32 masters on the CPU, from seed 1."""
    return registry.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1),
                                dtype=torch.float32)


def dec_train_route_cpu(arch, directory):
    """The CPU half of a decoder's training route check (run by `CpuRoutes`):
    one plain-route train step in each mode, and the same from masters moved
    one bf16 ulp up and one down; an MoE model's nudged steps take the main
    step's expert ids (`moe.ForcedRouting`), whose ids go to the npz too.
    The trees go to `directory`; the loss and each leaf's largest change
    under either nudge are returned."""
    cfg, opt, batch = dec_route_setup(arch)
    base = dec_route_model(cfg)
    # one ulp of the dtype the kernels compute in, as [15]'s float32 route
    # moves one float32 ulp
    nudged = [nudge(base, toward, getattr(torch, cfg.dtype))
              for toward in (float("inf"), float("-inf"))]
    out = {}
    for mode in DEC_ROUTE_MODES:
        c = MODES[mode](cfg)
        with DropCounter() as rec:
            want = train_route_step(c, opt, batch, copy.deepcopy(base))
        others = []
        for model in nudged:
            forced = moe_mod.ForcedRouting(rec.ids) if cfg.moe else contextlib.nullcontext()
            with forced:
                others.append(train_route_step(c, opt, batch, copy.deepcopy(model)))
        noise = {t: {k: max(float((o[t][k] - want[t][k]).abs().max()) for o in others)
                     for k in want[t]} for t in DEC_ROUTE_TREES}
        top = max(float(g.abs().max()) for g in want["grads"].values())
        flips = max(sum(nonzero_flips(o["grads"][k], g, top) for k, g in want["grads"].items())
                    for o in others)
        np.savez(Path(directory) / f"{arch}-{mode}.npz",
                 **{f"{t}/{k}": a.numpy() for t in DEC_ROUTE_TREES for k, a in want[t].items()},
                 **{f"ids/{i}": a.numpy() for i, a in enumerate(rec.ids)})
        out[mode] = dict(loss=want["loss"], noise=noise, drops=[d for d, _, _ in rec.drops],
                         nonzero_flips=flips,
                         loss_noise=max(abs(o["loss"] - want["loss"]) for o in others))
    return out


def dec_train_route_check(dev, arch, directory):
    """One train step on the card's kernel route against the port's plain
    route on the CPU (`dec_train_route_cpu`): `arch` at full width cut to 2
    layers, bf16 compute, float32 masters, the same weights and batch, in
    float and NPE-8, gated by `train_route_compare` with the plain
    route's change under one bf16 ulp of every master (a MoE model routed
    as the CPU routed: its own choices that differ are counted, with the
    largest gap in probability between them)."""
    cpu, seconds = CPU_ROUTES.result(f"dec_train_route_{arch}")
    cfg, opt, batch = dec_route_setup(arch)
    weights = dec_route_model(cfg).state_dict()
    out = {}
    for mode in DEC_ROUTE_MODES:
        c = MODES[mode](cfg)
        with np.load(Path(directory) / f"{arch}-{mode}.npz") as z:
            want = {k: torch.from_numpy(z[k]).to(dev) for k in z.files if not k.startswith("ids/")}
            ids = [torch.from_numpy(z[f"ids/{i}"]) for i in
                   range(sum(k.startswith("ids/") for k in z.files))]
        model = registry.build_model(cfg, device=dev, dtype=torch.float32)
        model.load_state_dict(weights)
        torch.cuda.reset_peak_memory_stats()
        forced = moe_mod.ForcedRouting(ids) if cfg.moe else None
        with forced or contextlib.nullcontext():
            got = train_route_step(c, opt, batch, model)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del model
        plain = cpu[mode]
        r = train_route_compare(mode, opt, got, want, plain,
                                nonzero_gate=2 * plain["nonzero_flips"])
        ok, worst, rel = r["ok"], r["worst_share_of_gate"], r["worst_relative"]
        out[mode] = dict(r, loss=got["loss"], loss_cpu=plain["loss"],
                         loss_noise=plain["loss_noise"], peak_gib=peak,
                         routing_differ=forced.differ if forced else None,
                         routing_gap=forced.gap if forced else None)
        say(f"  {mode:10s} {arch} train step, card kernels vs CPU plain route (bf16, 2 layers, "
            f"{DEC_ROUTE_BATCH} x {DEC_ROUTE_SEQ}): loss {got['loss']:.6f} vs {plain['loss']:.6f} "
            f"(gate {r['loss_gate']:.2e}); worst error as a share of its gate (and of its leaf's "
            "largest value): " + ", ".join(f"{t} {worst[t]:.3f} ({rel[t]:.1e})"
                                            for t in DEC_ROUTE_TREES)
            + (f"; the card's own top-k differs in {forced.differ} choices (largest gap "
               f"{forced.gap:.2e}), routed as the CPU routed" if forced else "")
            + (f"; gradient entries zero on one route and not the other {r['nonzero_flips']} "
               f"(gate: twice the plain route's own flips under the nudges, "
               f"{plain['nonzero_flips']})" if mode == "npe-8bit" else "")
            + f"; peak {peak:.2f} GiB" + ("" if ok else "  FAIL"))
        del got, want
        if not ok:
            raise SystemExit(f"{arch} {mode}: the training kernel route disagrees with the "
                             "plain route")
    torch.cuda.empty_cache()
    say(f"  (the CPU half took {seconds:.1f} s beside the card's phases)")
    return dict(out, cpu_seconds=seconds)


def dec_train_phase(dev, card, results):
    """[16]: StarCoder2-3B and Granite-3.0-1B-A400M trained at full width and
    depth through `launch.train.Trainer`: float for DEC_TRAIN's steps (the
    loss gated on falling: the last 5 below the first 5 and step 0), NPE-16
    and NPE-8 for a step or two, finite losses; one NPE-8 step's launches
    counted and audited; Granite's router gradients and capacity drops; the
    route check at 2 layers."""
    out = {}
    for arch, spec in DEC_TRAIN.items():
        cfg = get_config(arch)
        t0 = time.perf_counter()
        n_float, n16, n8 = spec["steps"]
        say(f"  {spec['label']} {arch} L={cfg.num_layers} D={cfg.d_model} V={cfg.vocab_size}, "
            f"{registry.param_count(cfg) / 1e9:.2f} B parameters, float32 masters and moments, "
            f"bf16 compute, remat block, SyntheticLM({cfg.vocab_size}, {DEC_TRAIN_SEQ}, "
            f"{DEC_TRAIN_BATCH}), AdamW {spec['opt']}, schedule constant")
        res = {}
        trainer, res["float"] = dec_train_mode(dev, card, arch, "float", n_float)
        losses = res["float"]["losses"]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        say(f"  float: loss of the first step {losses[0]:.4f}, mean of the first 5 steps "
            f"{first:.4f}, of the last 5 {last:.4f}")
        if not last < min(first, losses[0]):
            raise SystemExit(f"{arch} float training: the loss did not fall")
        if cfg.moe:
            res["float_router_grads"], res["float_drops"] = router_grads(trainer)
            say(f"  float: each layer's router gradient, largest entry: "
                f"{[f'{x:.2e}' for x in res['float_router_grads']]}; choices capacity dropped "
                f"in each route call of the step (the forward's {cfg.num_layers}, then remat's): "
                f"{res['float_drops']}")
            if not all(x > 0 for x in res["float_router_grads"]):
                raise SystemExit(f"{arch}: a router's gradient is zero in float")
        del trainer
        torch.cuda.empty_cache()
        for mode, n in (("npe-16bit", n16), ("npe-8bit", n8)):
            trainer, res[mode] = dec_train_mode(dev, card, arch, mode, n)
            if mode == "npe-8bit":
                t1 = time.perf_counter()
                res["npe-8bit_launches"] = dec_train_launches(arch, trainer)
                res["audit_s"] = time.perf_counter() - t1
                say(f"  (the audited step took {res['audit_s']:.1f} s)")
                if cfg.moe:
                    res["npe8_router_grads"], res["npe8_drops"] = router_grads(trainer)
                    say(f"  npe-8bit: router gradients {[f'{x:.2e}' for x in res['npe8_router_grads']]} "
                        f"(the head's MMU passes gradient to the entries that set its scales "
                        f"alone); dropped choices {res['npe8_drops']}")
            del trainer
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res["route_check"] = dec_train_route_check(dev, arch, CPU_ROUTES.train_dir)
        res["route_s"] = time.perf_counter() - t1
        say(f"  (the route check took {res['route_s']:.1f} s on the card, waiting included)")
        res["seconds"] = time.perf_counter() - t0
        say(f"  {spec['label']} {arch}: {res['seconds']:.1f} s")
        out[arch] = res
    results["dec_train"] = out
    results["dec_train_launches"] = {arch: r["npe-8bit_launches"]["counts"]
                                     for arch, r in out.items()}

# each decode route check's set-up (`route_setup`), in the order the phases
# need them: BERT's with the long run; GLM4's over prefill plus 2 steps
# (its CPU NPE calls quantize the 151552-column head each call); Gemma3's
# local layer over a 16-row ring that both runs wrap (global_every 2: layer
# 0 local, layer 1 global); the last families' over prompts of 4 and 2
# tokens (Hymba's local layer over a 4-row ring, which they wrap)
FAMILY_ROUTE = dict(long_run=False, modes=("float", "npe-8bit"), prompt_lens=(4, 2),
                    max_seq=FAMILY_MAX_SEQ, ties=True)
ROUTE_CHECKS = {
    "decode_route_check": dict(arch="bert_base"),
    "glm4_route_check": dict(arch="glm4_9b", long_run=False, modes=("float", "npe-8bit"),
                             steps=2),
    "gemma3_route_check": dict(arch="gemma3_27b", long_run=False, modes=("float",),
                               over=dict(global_every=2, window=16), prompt_lens=(18, 6),
                               max_seq=32),
    "granite_route_check": dict(arch="granite_moe_1b_a400m", long_run=False, routed=True),
    "rwkv6_route_check": dict(arch="rwkv6_3b", **FAMILY_ROUTE),
    "hymba_route_check": dict(arch="hymba_1_5b", over=dict(global_every=2, window=4),
                              **FAMILY_ROUTE),
    "whisper_route_check": dict(arch="whisper_base", over=CROSS_CHECK_LAYERS, **FAMILY_ROUTE),
}
# the CPU threads of the process that computes them; the rest of the 8
# cores are the card's phases' host
ROUTE_THREADS = 6


def cpu_route_worker(jobs, queue):
    """Run each (key, function name, kwargs) job on the CPU and put (key,
    result, seconds) on the queue; (None, traceback, 0) if one fails."""
    torch.set_num_threads(ROUTE_THREADS)
    torch.set_float32_matmul_precision("highest")
    for key, fn, kw in jobs:
        t0 = time.perf_counter()
        try:
            value = globals()[fn](**kw)
        except BaseException:
            queue.put((None, traceback.format_exc(), 0.0))
            return
        queue.put((key, value, time.perf_counter() - t0))


class CpuRoutes:
    """The CPU halves of the route checks (the port's plain route on the
    CPU, `decode_route_cpu` and `cross_cache_cpu`), computed in a process of
    its own while the card's phases run, so that the script's time is not
    their sum; `result(key)` waits for one."""

    def __init__(self):
        self.train_dir = tempfile.mkdtemp(prefix="chip_smoke_route_")
        jobs = [(key, "decode_route_cpu", spec) for key, spec in ROUTE_CHECKS.items()]
        jobs.append(("whisper_cross_check", "cross_cache_cpu", {}))
        jobs.append(("train_route_check", "train_route_cpu", {"directory": self.train_dir}))
        jobs += [(f"dec_train_route_{arch}", "dec_train_route_cpu",
                  {"arch": arch, "directory": self.train_dir}) for arch in DEC_TRAIN]
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.proc = ctx.Process(target=cpu_route_worker, args=(jobs, self.queue), daemon=True)
        self.proc.start()
        self.done = {}

    def result(self, key):
        while key not in self.done:
            try:
                k, value, seconds = self.queue.get(timeout=10)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise SystemExit(f"the CPU route process ended (code "
                                     f"{self.proc.exitcode}) before {key}")
                continue
            if k is None:
                raise SystemExit(f"the CPU route process failed:\n{value}")
            self.done[k] = (value, seconds)
        return self.done.pop(key)

    def close(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        shutil.rmtree(self.train_dir, ignore_errors=True)


CPU_ROUTES = None


def main() -> int:
    global CPU_ROUTES
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_info()
    say(f"[1] card: {card}")
    results = {"card": card, "phase_start_s": {}}

    def phase(label: str):
        """Print a phase's header with the seconds since the start."""
        results["phase_start_s"][label.split("]")[0] + "]"] = time.perf_counter() - t_start
        say(f"{label}  (at {time.perf_counter() - t_start:.1f} s)")

    res = build.build()
    build.library()
    say(f"[2] built {len(list(build.CSRC.glob('*.cu')))} CUDA sources into {res.path.name} "
        f"in {res.seconds:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})"
        + (" [found built]" if res.cached else ""))
    results["build_seconds"] = res.seconds
    ptx, sass = ptxas_table(res.log), sass_counts(res.path)
    results["ptxas"], results["sass"] = ptx, sass
    names = demangle(sorted(ptx))
    say("    kernel function: registers, static smem bytes, spill store/load bytes (ptxas); "
        "HMMA, IMMA in its SASS (cuobjdump)")
    for fn in sorted(ptx, key=names.get):
        regs, smem, st, ld = ptx[fn]
        mma = ("HMMA %4d IMMA %4d" % tuple(sass[fn]) if sass and fn in sass
               else "HMMA/IMMA not available")
        say(f"    {names[fn][:58]:58s} {regs:3d} regs {smem:5d} B  spills {st}/{ld}  {mma}")
    rebuilt = ("pwl_stream_kernel", "nvu_layernorm_warp_kernel", "nvu_softmax_kernel",
               "nvu_softmax_grad_kernel", "flash_dense_split_kernel", "flash_dense_wg_kernel",
               "flash_dense_wgt_kernel", "dense_grad_dq_kernel", "dense_grad_dkv_kernel")
    new = {fn: ptx[fn] for fn in ptx if any(k in fn for k in rebuilt)}
    spilled = [names[fn] for fn, (_, _, st, ld) in new.items() if st or ld]
    say(f"    {len(new)} instances of {' / '.join(rebuilt)}, "
        f"spills in {spilled if spilled else 'none'}")
    if sass is None:
        say("    SASS tensor-core instructions: not available (no cuobjdump)")
    else:
        for name, key, col in (("flash_attention", "flash", 0), ("its backward", "dense_grad", 0),
                               ("quant_matmul", "qmm", 1)):
            n = sum(c[col] for f, c in sass.items() if key in f)
            say(f"    SASS of {name}: {n} {'HMMA' if col == 0 else 'IMMA'} instructions")

    CPU_ROUTES = CpuRoutes()
    try:
        return serve_phases(dev, card, results, phase)
    finally:
        CPU_ROUTES.close()


def serve_phases(dev, card, results, phase) -> int:
    """Phases [3] to [16], with the CPU route process running beside them."""
    phase("[3] kernels vs plain versions on the card (ms per call: device time "
        "from torch.profiler, CUDA events in brackets)")
    floor_ms, floor_ev = launch_floor()
    floor_ms = floor_ms if floor_ms is not None else floor_ev
    results["launch_floor"] = dict(ms=floor_ms, event_ms=floor_ev)
    say(f"  launch floor: an empty 256-thread block {floor_ms:.4f} ms (events {floor_ev:.4f})")
    rows = kernel_rows(dev, floor_ms)
    results["rows"] = rows

    phase("[4] full-width BERT-base encoder serving through the kernels")
    serve_phase(dev, card, results)
    route_check(dev, results)

    phase("[5] full-width BERT-base KV-cache decode serving through the kernels")
    decode_phase(dev, card, results)
    decode_route_check(dev, results, "decode_route_check")

    phase("[6] npec: the compiled BERT-base streams through the functional executor on the card")
    base, tree = npec_phase(dev, results)

    phase("[7] npec serving runtime: NPEEngine on the card")
    engine_phase(dev, base, tree, results)
    del base, tree
    torch.cuda.empty_cache()

    phase("[8] full-width GLM4-9B (40 layers) KV-cache decode serving through the kernels")
    glm4_phase(dev, card, results)

    phase(f"[9] full-width Gemma3-27B ({GEMMA3_LAYERS} of 62 layers, local:global over ring "
          "caches) decode serving through the kernels")
    gemma3_phase(dev, card, results)

    phase("[10] full-width Granite-3.0-1B-A400M (24 MoE layers) decode serving through the "
          "kernels")
    granite_phase(dev, card, results)

    phase("[11] npec for the dense and MoE families: GLM4-9B and Granite-3.0-1B-A400M compiled "
          "and executed on the card")
    npec_decoders_phase(dev, results)

    phase("[12] full-width RWKV6-3B (32 layers) decode serving through the kernels")
    family_phase(dev, card, results, "rwkv6_3b")

    phase("[13] full-width Hymba-1.5B (32 layers: attention over 1024-row windows and an SSM "
          "head in each) decode serving through the kernels")
    family_phase(dev, card, results, "hymba_1_5b")

    phase("[14] full-width Whisper-base (6 encoder and 6 decoder layers) encoding and decode "
          "serving through the kernels")
    family_phase(dev, card, results, "whisper_base")

    phase("[15] training: full-width BERT-base (12 layers) through the forward and backward "
          "kernels, with checkpoints and a recovered crash")
    train_phase(dev, card, results)

    phase("[16] training the decoders at full width and depth: StarCoder2-3B (30 layers) and "
          "Granite-3.0-1B-A400M (24 MoE layers), through flash attention's backward kernel")
    dec_train_phase(dev, card, results)

    # each kernel at the shapes of one NPE-8 decode step (nvu_softmax, which
    # decode does not run, at the encoder's); launches from the run of that
    # path: the served NPE-8 decode run, or the NPE-8 encoder forward
    kernels = []
    main_rows = {"pwl_eval": ("decode", "(8, 3072) gelu"),
                 "quant_matmul": ("decode", "(8, 768) @ (768, 3072)"),
                 "nvu_softmax": ("encoder", "(12288, 128) scale 0.125"),
                 "nvu_layernorm": ("decode", "(8, 768)"),
                 "flash_attention": ("decode", "dense decode (8, 12, 1, 64) kv 256/256 pwl")}
    by_shape = {r["shape"]: r for r in rows if r["kernel"] == "flash_attention"}
    exact_decode = by_shape["dense decode (8, 12, 1, 64) kv 256/256"]
    for name, (path, shape) in main_rows.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"] == shape)
        counts = results["decode_launches" if path == "decode" else "launches"]
        if counts[name] == 0:
            raise SystemExit(f"{name} was not launched on the {path} path")
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=counts[name], path=path,
            shape=f"{r['shape']} {r['dtype']}", max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], library=r["library"],
            launches_encoder=results["launches"][name],
            launches_decode=results["decode_launches"][name],
            launches_npec=results["npec_launches"][name],
            launches_engine=results["engine_launches"][name],
            launches_glm4=results["glm4_launches"][name],
            launches_gemma3=results["gemma3_launches"][name],
            launches_granite=results["granite_launches"][name],
            launches_npec_glm4=results["npec_glm4_launches"][name],
            launches_npec_granite=results["npec_granite_launches"][name],
            launches_rwkv6=results["rwkv6_launches"][name],
            launches_hymba=results["hymba_launches"][name],
            launches_whisper=results["whisper_launches"][name],
            launches_whisper_encoder=results["whisper_encoder_launches"][name],
            launches_train=results["train_launches"][name],
            **{f"launches_train_{arch}": results["dec_train_launches"][arch][name]
               for arch in DEC_TRAIN}))
        npec_rows = [dict(shape=f"{x['shape']} {x['dtype']}", ms=x["ms"], plain_ms=x["plain_ms"],
                          bound_ms=x["bound_ms"], bound_by=x["bound_by"],
                          library_ms=x["library_ms"], max_abs_err=x["max_abs_err"],
                          launch_floor_ms=x["launch_floor_ms"])
                     for x in rows if x["kernel"] == name and x["cell"] is None
                     and ("row scales" in x["shape"] or "limit" in x["shape"])]
        if npec_rows:
            kernels[-1]["npec_instances"] = npec_rows
        cold = next((c for c in rows if c["kernel"] == name and c["dtype"] == r["dtype"]
                     and c["shape"] == shape + " cold L2"), None)
        if cold:
            kernels[-1]["cold_ms"] = cold["ms"]
            if cold["copy_ms"] is not None:
                kernels[-1]["copy_cold_ms"] = cold["copy_ms"]
        if r["yardstick"]:
            kernels[-1].update(yardstick=r["yardstick"], yardstick_ms=r["yardstick_ms"])
        for cell in ("glm4", "gemma3", "starcoder2", "granite", "npec_decoders", "rwkv6",
                     "hymba", "whisper"):
            cell_rows = [
                dict(shape=f"{x['shape']} {x['dtype']}", ms=x["ms"], plain_ms=x["plain_ms"],
                     bound_ms=x["bound_ms"], bound_by=x["bound_by"],
                     library_ms=x["library_ms"], max_abs_err=x["max_abs_err"])
                for x in rows if x["kernel"] == name and x["cell"] == cell]
            if cell_rows or cell == "glm4":
                kernels[-1][f"{cell}_rows"] = cell_rows
    qmm = next(k for k in kernels if k["name"] == "quant_matmul")
    qmm["train_scale_path_rows"] = [
        dict(shape=f"{x['shape']} {x['dtype']}", ms=x["ms"], plain_ms=x["plain_ms"],
             bound_ms=x["bound_ms"], bound_by=x["bound_by"], library_ms=x["library_ms"],
             max_abs_err=x["max_abs_err"])
        for x in rows if x["kernel"] == "quant_matmul_grad"]
    # the backward kernels, at the shapes of the NPE-8 train step, launches from it
    for name, shape in GRAD_MAIN_ROWS.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"] == shape)
        n = results["train_launches"][name]
        if n == 0:
            raise SystemExit(f"{name} was not launched on the training path")
        forward = name.removesuffix("_grad")
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{forward}.cu",
            replaces=REPLACES[forward], differentiates=GRAD_REFERENCE[name],
            launches=n, path="train", shape=f"{r['shape']} {r['dtype']}",
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            library=r["library"], yardstick=r["yardstick"], yardstick_ms=r["yardstick_ms"],
            rows=[dict(shape=f"{x['shape']} {x['dtype']}", ms=x["ms"], plain_ms=x["plain_ms"],
                       bound_ms=x["bound_ms"], bound_by=x["bound_by"],
                       library_ms=x["library_ms"], yardstick_ms=x["yardstick_ms"],
                       max_abs_err=x["max_abs_err"], cell=x["cell"])
                  for x in rows if x["kernel"] == name],
            **{f"launches_train_{arch}": results["dec_train_launches"][arch][name]
               for arch in DEC_TRAIN}))
    # the dense mode's backward, at StarCoder2's shape; launches from [16](a)'s
    # NPE-8 train step, (b)'s beside them
    r = next(r for r in rows if r["shape"] == ATTN_GRAD_MAIN_ROW)
    dec = results["dec_train_launches"]
    if any(dec[arch]["flash_attention_grad"] == 0 for arch in DEC_TRAIN):
        raise SystemExit("flash_attention_grad was not launched on the decoders' training path")
    kernels.append(dict(
        name="flash_attention_grad", route="cuda",
        source="src/repro_torch/csrc/flash_attention_grad.cu",
        replaces=REPLACES["flash_attention"],
        differentiates="src/repro/models/common.py:205 (attention_scores, jax.vjp)",
        launches=dec["starcoder2_3b"]["flash_attention_grad"], path="train",
        launches_train=dec["starcoder2_3b"]["flash_attention_grad"],
        launches_train_granite=dec["granite_moe_1b_a400m"]["flash_attention_grad"],
        launches_train_bert=results["train_launches"]["flash_attention_grad"],
        shape=f"{r['shape']} {r['dtype']}", max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], library=r["library"],
        rows=[dict(shape=f"{x['shape']} {x['dtype']}", ms=x["ms"], plain_ms=x["plain_ms"],
                   bound_ms=x["bound_ms"], bound_by=x["bound_by"], library_ms=x["library_ms"],
                   max_abs_err=x["max_abs_err"],
                   # launches a train step of the model whose shape the row takes ([16])
                   launches_train=dec[TRAINED_CELLS[x["cell"]]]["flash_attention_grad"]
                   if x["cell"] in TRAINED_CELLS else None)
              for x in rows if x["kernel"] == "flash_attention_grad"]))
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["mode"] = "dense"   # the decode path's attention: a mode of this kernel's source
    flash["dense_mode_replaces"] = "src/repro/models/common.py:205 (attention_scores, cache case)"
    flash["library_ms_exact_exp"] = exact_decode["library_ms"]
    flash["blocked_ms"] = by_shape["decode (8, 12, 1, 64) kv 192/256 pwl"]["ms"]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    phase("[17] summary")
    say("kernels: " + " ".join(KERNELS))
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
