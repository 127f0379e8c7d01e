"""npec — the NPE compiler: model -> overlay instruction stream
(counterpart of `repro/npec/__init__.py`).

The paper's headline claim is software-like programmability (§5, §6): the
FPGA bitstream is fixed and every model is *compiled* to an instruction
stream the ICU interprets.  The pipeline, as in the reference:

    trace    (npec.trace)    ModelConfig -> graph IR: per-head matmul /
                             softmax / norm / rope / activation dataflow
                             for the bert, dense and moe families (MoE
                             routing as topk / scatter_slot / gather ops
                             with capacity-bounded per-expert products);
                             prefill, one-token KV-cache decode (batch=B
                             slots in one stream, ring banks with
                             window=True) and serving prefill (whole, or
                             chunked slices over cache banks).
    lower    (npec.lower)    graph IR -> overlay instructions: matmuls tiled
                             to the MMU geometry, nonlinearities expanded to
                             NVU microprograms with VLIW bundles.
    schedule (npec.schedule) greedy earliest-start and tile-streaming
                             schedules over the per-unit timelines.
    exec     (npec.exec)     functional interpretation of a compiled
                             program on torch tensors, through the port's
                             Hopper kernels on the card.

The passes are copies of the reference's and compile a configuration to the
same graph, instructions and cycle totals (tests/test_torch_npec.py).
Cycles are the FPGA overlay model's (200 MHz), never time on the card.

Entry points:
    compile_model(cfg, seq, hw, ...)    trace + lower (prefill of any
                                        traced family).
    compile_decode(cfg, T, hw, ...)     one-token decode step over a KV
                                        cache of capacity T (batch=B: one
                                        merged B-slot stream).
    compile_prefill(cfg, S, hw, ...)    serving prefill with kv exports
                                        (cache_len=T: one chunked slice).
    compile_bert_shape(hw, shape, ...)  dims-only encoder stack.
    compile_decode_bert_shape(...)      dims-only decode step.
    greedy_schedule / issue_order / stream_schedule / schedule_for /
    transfer_cycles                     schedule a CompiledProgram.
    execute / DecodeSession             run it numerically.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import ModelConfig
from repro_torch.core.overlay import NPEHardware
from repro_torch.npec.ir import Graph, GraphBuilder, Node
from repro_torch.npec.lower import (CompiledProgram, LoweredInstr, lower,
                                    make_transfer, nvu_microprogram, tile_matmul)
from repro_torch.npec.schedule import (greedy_schedule, issue_order, schedule_for,
                                       stream_schedule, transfer_cycles)
from repro_torch.npec.trace import (CompileError, moe_capacity, trace_bert_shape,
                                    trace_decode, trace_decode_bert_shape, trace_model,
                                    trace_moe_block, trace_prefill,
                                    trace_prefill_slice_shape)
from repro_torch.npec.exec import (DecodeSession, ExecResult, ParamTree, execute,
                                   expected_launches)


def compile_model(cfg: ModelConfig, seq: int, hw: Optional[NPEHardware] = None,
                  *, bits: int = 16, nvu_source: str = "paper",
                  layers: Optional[int] = None,
                  include_embed: bool = True) -> CompiledProgram:
    """Trace `cfg` at sequence length `seq` and lower it to the overlay."""
    hw = hw if hw is not None else NPEHardware()
    return lower(trace_model(cfg, seq, layers=layers,
                             include_embed=include_embed),
                 hw, bits=bits, nvu_source=nvu_source)


def compile_bert_shape(hw: NPEHardware, shape, bits: int,
                       *, nvu_source: str = "paper",
                       layers: int = 1) -> CompiledProgram:
    """Compile a dims-only encoder stack: `shape` is any object with the
    attributes `seq`, `hidden`, `heads`, `head_dim` and `d_ff`."""
    return lower(trace_bert_shape(shape, layers=layers), hw, bits=bits,
                 nvu_source=nvu_source)


def compile_decode(cfg: ModelConfig, cache_len: int,
                   hw: Optional[NPEHardware] = None, *, bits: int = 16,
                   nvu_source: str = "paper", layers: Optional[int] = None,
                   include_embed: bool = True,
                   batch: int = 1, window: bool = False) -> CompiledProgram:
    """Trace one decode step of `cfg` over a KV cache of capacity
    `cache_len` and lower it; execute statefully with `DecodeSession`.
    batch=B compiles the merged B-slot stream; window=True the ring
    variant (see trace_decode)."""
    hw = hw if hw is not None else NPEHardware()
    return lower(trace_decode(cfg, cache_len, layers=layers,
                              include_embed=include_embed, batch=batch,
                              window=window),
                 hw, bits=bits, nvu_source=nvu_source)


def compile_prefill(cfg: ModelConfig, seq: int,
                    hw: Optional[NPEHardware] = None, *, bits: int = 16,
                    nvu_source: str = "paper", layers: Optional[int] = None,
                    include_embed: bool = True,
                    cache_len: Optional[int] = None,
                    window: bool = False) -> CompiledProgram:
    """Trace + lower the serving prefill stream for a `seq`-token prompt
    (causal, logits head, kv exports for `DecodeSession.load_slot`);
    cache_len=T compiles one chunked-prefill slice of `seq` rows over
    (T, head_dim) cache banks instead (see trace_prefill)."""
    hw = hw if hw is not None else NPEHardware()
    return lower(trace_prefill(cfg, seq, layers=layers,
                               include_embed=include_embed,
                               cache_len=cache_len, window=window),
                 hw, bits=bits, nvu_source=nvu_source)


def compile_prefill_slice_shape(hw: NPEHardware, shape, cache_len: int,
                                rows: int, bits: int, *,
                                nvu_source: str = "paper",
                                layers: int = 1) -> CompiledProgram:
    """Compile a dims-only chunked-prefill slice (see compile_bert_shape)."""
    return lower(trace_prefill_slice_shape(shape, cache_len, rows,
                                           layers=layers),
                 hw, bits=bits, nvu_source=nvu_source)


def compile_decode_bert_shape(hw: NPEHardware, shape, cache_len: int,
                              bits: int, *, nvu_source: str = "paper",
                              layers: int = 1, batch: int = 1,
                              window: bool = False) -> CompiledProgram:
    """Compile a dims-only decode step (see compile_bert_shape); batch=B
    merges B decode slots into one stream, window=True makes the banks
    rings."""
    return lower(trace_decode_bert_shape(shape, cache_len, layers=layers,
                                         batch=batch, window=window),
                 hw, bits=bits, nvu_source=nvu_source)
