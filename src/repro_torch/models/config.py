"""Model configuration for all assigned architecture families.

A copy of ``repro.models.config`` (dimensions only), so ``param_count()``
and every field compare equal with the reference's.  ``remat`` and
``remat_policy`` choose what a training forward recomputes in the backward
(``models.transformer``).  ``seq_parallel`` acts on a mesh only (the
residual stream's layout, ``distributed.hints``); ``repeat_kv`` gives the
same numbers as the GQA grouping, with the heads sharded evenly on a
mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # attention (unused for pure ssm)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e6
    causal: bool = True
    # normalization: rmsnorm | nonparam_ln | layernorm
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): a shared attention block applied every N ssm layers
    shared_attn_every: int = 0
    num_shared_blocks: int = 2
    # modality frontend: tokens | patch_embed | frame_embed
    frontend: str = "tokens"
    num_frontend_tokens: int = 0    # vlm: image positions fed from the stub
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training-memory knobs (per-shape overrides live in launch configs)
    q_chunk: int = 1024
    kv_chunk: int = 2048
    loss_chunk: int = 2048
    remat: bool = True
    remat_policy: str = "none"   # none | dots
    # training-time GQA: materialize K/V at full head count so the head dim
    # shards exactly over the model axis (kv-heads < mesh size otherwise
    # forces GSPMD replication of every attention tensor); caches at decode
    # keep the compact KV layout
    repeat_kv: bool = False
    # EXPERIMENTAL (§Perf C3): shard the residual stream over the model
    # axis on the sequence dim between blocks (sequence parallelism) —
    # norms/elementwise run 1/16th-sized; GSPMD inserts all-gather before
    # attention/mlp and reduce-scatter after
    seq_parallel: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "vlm", "audio") or \
            self.shared_attn_every > 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid")

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
            raise ValueError(f"unknown family {self.family}")
        if self.family in ("dense", "moe", "vlm", "audio"):
            assert self.num_heads > 0 and self.head_dim > 0
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.family == "hybrid":
            assert self.shared_attn_every > 0 and self.num_heads > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D roofline sanity)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        n = 0
        # embeddings (+ untied head)
        if self.frontend == "tokens" or self.family == "vlm":
            n += V * d
            if not self.tie_embeddings:
                n += V * d
        elif self.family == "audio":
            n += V * d  # classifier head only (frame embeddings are the stub)
        if self.frontend in ("patch_embed", "frame_embed"):
            n += d * d  # frontend adapter projection
        def attn_params() -> int:
            H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
            p = d * H * hd + 2 * d * KV * hd + H * hd * d
            if self.qkv_bias:
                p += (H + 2 * KV) * hd
            return p
        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # SwiGLU
        def norm_params() -> int:
            if self.norm == "nonparam_ln":
                return 0
            return 2 * d if self.norm == "layernorm" else d
        def ssm_params() -> int:
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            G = 1  # single B/C group
            p = d * (2 * di + 2 * G * N + Hs)          # in_proj (z,x,B,C,dt)
            p += (self.ssm_conv + 1) * (di + 2 * G * N)  # conv w + bias
            p += Hs * 3                                 # A_log, D, dt_bias
            p += di                                     # gated rmsnorm scale
            p += di * d                                 # out_proj
            return p
        if self.family in ("dense", "vlm", "audio"):
            n += L * (attn_params() + mlp_params(f) + 2 * norm_params())
        elif self.family == "moe":
            n += L * (attn_params() + 2 * norm_params()
                      + self.num_experts * mlp_params(f) + d * self.num_experts)
        elif self.family == "ssm":
            n += L * (ssm_params() + norm_params())
        elif self.family == "hybrid":
            n += L * (ssm_params() + norm_params())
            shared = attn_params() + mlp_params(f) + 2 * norm_params()
            n += self.num_shared_blocks * shared
        n += norm_params()  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of the expert table)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        total = self.param_count()
        expert_all = L * self.num_experts * 3 * d * f
        expert_active = L * self.experts_per_token * 3 * d * f
        return total - expert_all + expert_active


@dataclasses.dataclass(frozen=True)
class MoEShareConfig(ModelConfig):
    """A dropless MoE model with OLMoE's layer (arXiv:2409.02060), of which
    this device holds a share of every layer's experts: the ``num_experts``
    experts from ``expert_offset`` on, of the router's ``router_experts``.

    Beside :class:`ModelConfig`'s fields, which the ten reference
    configurations carry and this one shares:
      * gating: an fp32 softmax over all ``router_experts`` logits, then
        the top ``experts_per_token`` probabilities as they are (no
        renormalisation); every (token, held expert) pair is computed
        (``moe_capacity_factor`` is not read; ``models.moe.MoEShare``);
      * QK-norm, always (``qk_norm``, a class constant, not a field): a
        weighted RMSNorm over the whole projected q and the whole
        projected k, before RoPE;
      * parametric norms with epsilon ``norm_eps``;
      * the router's losses, added to the cross entropy: the load-balancing
        loss ``lb_weight`` * sum over layers of E * sum_e f_e * P_e, and
        the z-loss ``z_weight`` * sum over layers of mean(logsumexp^2)
        (``models.transformer.loss_terms``).
    """
    router_experts: int = 64
    expert_offset: int = 0
    norm_eps: float = 1e-5
    lb_weight: float = 0.01
    z_weight: float = 0.001
    qk_norm = True

    def __post_init__(self):
        super().__post_init__()
        if self.family != "moe" or self.norm != "rmsnorm":
            raise ValueError("an expert share is of an rmsnorm moe model")
        last = self.expert_offset + self.num_experts
        if self.expert_offset < 0 or last > self.router_experts:
            raise ValueError(f"experts {self.expert_offset}..{last - 1} are "
                             f"not among the router's {self.router_experts}")
        if self.experts_per_token > self.router_experts:
            raise ValueError("more experts a token than the router has")

    def param_count(self) -> int:
        """The parameters held here: :meth:`ModelConfig.param_count` with
        the router at its full width and the QK-norms' scales."""
        qk = (self.num_heads + self.num_kv_heads) * self.head_dim
        return super().param_count() + self.num_layers * (
            self.d_model * (self.router_experts - self.num_experts) + qk)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: Optional[int] = None   # per-data-shard microbatch rows

SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
