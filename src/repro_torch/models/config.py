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
import math
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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature factor (``yarn_get_mscale`` of
    DeepSeek-V2's modeling code): 1 + 0.1 mscale ln(factor), 1 at a factor
    of 1 or less."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class MLAShareConfig(MoEShareConfig):
    """A share of DeepSeek-V2's model (arXiv:2405.04434 §2.1-2.2; V2-Lite's
    config): multi-head latent attention (MLA) without query compression,
    a leading dense SwiGLU, then DeepSeekMoE layers of which this device
    holds a share of the routed experts, beside the shared experts.

    Beside :class:`MoEShareConfig`'s fields (``head_dim`` is q's and k's
    width, ``qk_nope_head_dim + qk_rope_head_dim``; ``d_ff`` an expert's
    width; ``num_kv_heads`` the heads' count, MLA has no grouping):
      * MLA (``models.mla.MLAttention``): q = x W_Q (heads of
        ``qk_nope_head_dim`` + ``qk_rope_head_dim``); [c; k_R] = x W_KVa
        (``kv_lora_rank`` + ``qk_rope_head_dim``), c through its own
        RMSNorm; [k_C; v] = c W_KVb (heads of ``qk_nope_head_dim`` +
        ``v_head_dim``); RoPE on q's and k_R's rope parts only, the one
        k_R shared by every head; the scores scaled by ``softmax_scale``;
      * RoPE under YaRN: theta ``rope_theta``, ``rope_factor``,
        ``rope_original`` positions, ``beta_fast``, ``beta_slow``,
        ``mscale``, ``mscale_all_dim`` (``models.mla.yarn_inv_freq``);
        the rotation pairs are the interleaved (2i, 2i + 1);
      * the first ``first_dense`` layers' FFN a SwiGLU of width
        ``dense_d_ff``; every later layer DeepSeekMoE: the routed share
        (:class:`MoEShareConfig`'s gating, no renormalisation) plus
        ``shared_experts`` shared experts, one SwiGLU of width
        ``shared_experts * d_ff`` run for every token;
      * the loss: the cross entropy plus ``lb_weight`` times the
        sequence-wise expert balance loss, summed over the MoE layers
        (``models.moe.sequence_balance_loss``); no z-loss
        (``z_weight`` 0); no QK-norm.
    """
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    shared_experts: int = 2
    first_dense: int = 1
    dense_d_ff: int = 10944
    rope_factor: float = 40.0
    rope_original: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    norm_eps: float = 1e-6
    lb_weight: float = 0.001
    z_weight: float = 0.0
    qk_norm = False

    def __post_init__(self):
        super().__post_init__()
        if self.head_dim != self.qk_nope_head_dim + self.qk_rope_head_dim:
            raise ValueError("head_dim is q's and k's width, "
                             "qk_nope_head_dim + qk_rope_head_dim")
        if self.num_kv_heads != self.num_heads or self.qk_rope_head_dim % 2:
            raise ValueError("MLA keeps one k and v a head, and rotates "
                             "pairs")
        if not 0 <= self.first_dense <= self.num_layers:
            raise ValueError("first_dense past the layers")

    @property
    def softmax_scale(self) -> float:
        """head_dim^-1/2 times YaRN's mscale(rope_factor,
        mscale_all_dim) squared (DeepSeek-V2's attention)."""
        m = yarn_mscale(self.rope_factor, self.mscale_all_dim)
        return self.head_dim ** -0.5 * m * m

    def param_count(self) -> int:
        """The parameters held here: the embedding, the untied head and
        the final norm; per layer two norms and MLA (W_Q, W_KVa, the
        latent norm, W_KVb, W_O); the leading dense SwiGLUs; per MoE layer
        the router at its full width, the held experts and the shared
        ones."""
        d, H, V = self.d_model, self.num_heads, self.vocab_size
        r, rd = self.kv_lora_rank, self.qk_rope_head_dim
        mla = d * H * self.head_dim + d * (r + rd) + r \
            + r * H * (self.qk_nope_head_dim + self.v_head_dim) \
            + H * self.v_head_dim * d
        moe = d * self.router_experts \
            + (self.num_experts + self.shared_experts) * 3 * d * self.d_ff
        dense = self.first_dense
        return 2 * V * d + d + self.num_layers * (mla + 2 * d) \
            + dense * 3 * d * self.dense_d_ff \
            + (self.num_layers - dense) * moe


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
