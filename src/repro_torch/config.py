"""Configuration system.

Three config kinds compose a run:
  * :class:`ModelConfig` — architecture definition (one per ``--arch``).
  * :class:`ShapeConfig` — the assigned input-shape cells.
  * :class:`MeshConfig` / :class:`RunConfig` — distribution + run options.

``ModelConfig`` covers every assigned family (dense GQA / MoE / SSM / hybrid /
enc-dec) so a single model zoo consumes it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    # DBRX-style fine-grained: router jitter etc. kept minimal.
    router_aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """RWKV6 / Mamba-style state config (per-head linear recurrence)."""

    state_size: int = 16       # recurrent state per channel (hymba) / head (rwkv)
    head_dim: int = 64         # rwkv6 head size
    expand: int = 2            # mamba-style inner expansion for hybrid heads


@dataclasses.dataclass(frozen=True)
class SoftmaxPhiConfig:
    """T1: unified-max softmax parameters (paper §3).

    ``phi`` is the static scaling factor; ``band=(a, b)`` is the safe range for
    ``x - phi`` (paper's Example uses (-3, 3); defaults here are wider because
    f32 exp is safe up to ~88). ``phi=None`` disables T1 (the paper does this
    for OPT-6.7B whose logit range is too wide) and the engine uses the
    synchronized two-pass softmax everywhere.
    """

    phi: Optional[float] = 0.0
    band: Tuple[float, float] = (-40.0, 40.0)
    enabled: bool = True

    @property
    def active(self) -> bool:
        return self.enabled and self.phi is not None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    max_seq_len: int = 1 << 20
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0     # enc-dec only
    sliding_window: int = 0     # 0 = full attention; >0 = sliding window (hybrid)
    frontend: Optional[str] = None  # None | audio | vision  (stub frontends)
    # T1 config
    softmax_phi: SoftmaxPhiConfig = dataclasses.field(default_factory=SoftmaxPhiConfig)
    # dtypes
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # source annotation (public literature reference)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0 and self.family != "ssm":
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.num_kv_heads}"
            )

    # -- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can decode at 500k context (SSM/hybrid/windowed)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_softmax_attention(self) -> bool:
        return self.family != "ssm"

    def param_count(self) -> int:
        """Analytical parameter count (embedding + per-layer + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        per_layer = 0
        if self.family in ("dense", "moe", "hybrid", "encdec"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                attn += self.q_dim + 2 * self.kv_dim
            per_layer += attn
        if self.family == "moe":
            assert self.moe is not None
            gates = 3 if self.activation in ("swiglu", "geglu") else 2
            per_layer += self.moe.num_experts * gates * d * f + d * self.moe.num_experts
        else:
            gates = 3 if self.activation in ("swiglu", "geglu") else 2
            per_layer += gates * d * f
        if self.family == "ssm":
            assert self.ssm is not None
            # rwkv6: r,k,v,g,o projections + time-mix lora + decay params
            per_layer += 5 * d * d + 2 * d * self.ssm.head_dim + 4 * d
        if self.family == "hybrid":
            assert self.ssm is not None
            # mamba head in/out projections (parallel to attention)
            inner = self.ssm.expand * d
            per_layer += d * inner * 2 + inner * self.ssm.state_size * 2 + inner
        per_layer += 2 * d  # norms
        n_layers = self.num_layers + self.encoder_layers
        return emb + head + n_layers * per_layer

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        assert self.moe is not None
        total = self.param_count()
        gates = 3 if self.activation in ("swiglu", "geglu") else 2
        expert_p = gates * self.d_model * self.d_ff
        inactive = (self.moe.num_experts - self.moe.num_experts_per_tok) * expert_p
        return total - self.num_layers * inactive


# ---------------------------------------------------------------------------
# Shapes (the assigned input-shape cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(model: ModelConfig) -> list[ShapeConfig]:
    """The assigned shape cells that are well-defined for this arch.

    ``long_500k`` requires sub-quadratic attention — skipped for pure
    full-attention archs per the assignment (recorded in DESIGN.md §4).
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if model.is_subquadratic:
        out.append(LONG_500K)
    return out


# ---------------------------------------------------------------------------
# Mesh / run
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Knobs for a training/serving run (also the perf-hillclimb surface)."""

    microbatch: int = 0              # 0 = no gradient accumulation
    remat: str = "selective"         # none | selective | full
    # kernel dispatch: a repro_torch.core.plan.ExecutionPlan (None =
    # untuned default); hosts with hard constraints override knobs on top
    plan: Optional[object] = None
    sync_softmax: bool = False       # force the pre-T1 synchronized scheme
    seq_shard_attention: bool = True  # T1-enabled split-KV decode sharding
    zero1: bool = True               # shard optimizer state over data axis
    grad_compression: str = "none"   # none | int8_ef
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    # serving
    max_decode_steps: int = 32
    temperature: float = 0.0
    # shape-dependent scheduling knobs used by the perf loop
    # (decode block_k lives in the plan: plan.attention_decode.block_k)
    flat_gemm_bn: int = 0            # 0 = auto (cost model picks)
    vocab_chunk: int = 0             # 0 = no chunking of the LM head / loss
