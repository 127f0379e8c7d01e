"""Model and run configuration (counterpart of `repro/config.py`): the
model's fields and defaults, the input-shape cells, the mesh, and the
training run's optimizer, checkpoint and fault settings, field for field."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    # every `interleave`-th layer is MoE (1 = every layer, 2 = alternating)
    interleave: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    router_act: str = "softmax"        # softmax | sigmoid (llama4's top-1)
    ep_layout: str = "token_split"     # token_split | dsplit


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (hymba) / RWKV6 head parameters."""
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: int = 0           # 0 => max(1, d_model // 16)
    head_size: int = 64        # rwkv6 head size


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | bert
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention structure ---
    attention: str = "full"     # full | sliding | local_global | none
    window: int = 4096          # sliding-window size where applicable
    global_every: int = 6       # local_global: layer l is global iff (l+1) % global_every == 0
    causal: bool = True

    # --- norms / activations / blocks ---
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_bias: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    activation: str = "silu"    # silu | gelu | relu2
    mlp_type: str = "gated"     # gated (SwiGLU/GeGLU) | plain
    parallel_block: bool = False  # command-r: attention and MLP in parallel
    qk_norm: bool = False
    logit_softcap: float = 0.0

    # --- positions ---
    rope: str = "standard"      # standard | mrope | none | learned
    rope_theta: float = 10000.0
    max_position: int = 131072

    # --- family extensions ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0      # encdec only
    decoder_layers: int = 0
    encoder_seq: int = 1500      # whisper audio frames after the conv stub
    frontend: str = "none"       # none | audio_stub | vision_stub
    num_patches: int = 256       # vlm: patch embeddings per sample (stub)
    tie_embeddings: bool = False

    # --- numerics ---
    dtype: str = "bfloat16"

    # --- NPE overlay mode: quantized MMU + PWL NVU ---
    npe_quant: bool = False
    npe_quant_bits: int = 8      # 8 or 16
    npe_pwl: bool = False
    npe_pwl_segments: int = 16

    # --- long context: True iff the long_500k cell is runnable ---
    subquadratic: bool = False

    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    def with_npe(self, quant_bits: int = 8, segments: int = 16) -> "ModelConfig":
        """Enable the paper's technique (quantized MMU + PWL NVU)."""
        return dataclasses.replace(
            self, npe_quant=True, npe_quant_bits=quant_bits,
            npe_pwl=True, npe_pwl_segments=segments)

    def param_count(self) -> int:
        """Parameters of the port's model of this config."""
        from repro_torch.models import registry
        return registry.param_count(self)


# ---------------------------------------------------------------------------
# Input-shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# smoke-scale variants used by tests (same code paths, tiny extents)
SMOKE_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 64, 2),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 64, 2),
    "decode_32k": ShapeConfig("decode_32k", "decode", 64, 2),
    "long_500k": ShapeConfig("long_500k", "decode", 128, 1),
}


# ---------------------------------------------------------------------------
# Mesh (data only: one card runs the (1, 1) mesh)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    """Topology and sharding profile, as the reference records them: the
    axis names and sizes and the rule set ("tp", "fsdp" or "sp").  The port
    runs on one card, so the trainer takes the (1, 1) mesh only."""
    axis_names: Tuple[str, ...] = ("data", "model")
    axis_sizes: Tuple[int, ...] = (16, 16)
    profile: str = "tp"
    dcn_axes: Tuple[str, ...] = ("pod",)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def describe(self) -> str:
        return "x".join(f"{n}={s}" for n, s in zip(self.axis_names, self.axis_sizes))


SINGLE_POD = MeshConfig(("data", "model"), (16, 16))
MULTI_POD = MeshConfig(("pod", "data", "model"), (2, 16, 16))
SMOKE_MESH = MeshConfig(("data", "model"), (1, 1))


# ---------------------------------------------------------------------------
# Run configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    schedule: str = "cosine"      # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True            # shard optimizer state over data axis
    moment_dtype: str = "float32"  # float32 | bfloat16
    grad_compression: str = "none"  # none | int8_ef (error-feedback int8)


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/tmp/repro_ckpt"
    interval: int = 50
    keep: int = 3
    async_save: bool = True


@dataclass(frozen=True)
class FaultConfig:
    max_restarts: int = 3
    nan_is_failure: bool = True
    # simulated fault injection for tests/examples
    inject_nan_at_step: int = -1
    inject_crash_at_step: int = -1
    step_deadline_sec: float = 0.0   # >0 enables straggler watchdog


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    fault: FaultConfig = FaultConfig()
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    microbatch: int = 0           # >0 enables gradient accumulation
    remat: str = "block"          # none | block | full
    param_dtype: str = "float32"  # master params
