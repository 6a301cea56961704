"""Model/architecture configuration schema (the port's own copy).

Field for field the same as the JAX package's schema, so a config built
here describes the same model there.  Families of the port alone
(``arch_kind`` "mla_moe": latent attention and DeepSeek-V3's experts)
extend it in subclasses, `MLAModelConfig` and `DeepSeekMoEConfig`, whose
fields the JAX package's configs never carry; the knobs that the shared
MoE layer reads are class attributes of `MoEConfig`, not fields.  One `ModelConfig` describes any architecture in the assigned pool: dense GQA
transformers, MoE, Mamba2/xLSTM SSMs, the Zamba2 hybrid, Whisper enc-dec,
and the LLaVA VLM backbone.  Family-specific knobs live in optional
sub-configs; `arch_kind` drives which forward function the registry picks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                   # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # pad the expert dimension of the weight/dispatch tensors so EP can
    # shard a non-divisible expert count (granite: 40 → 48 on a 16-way
    # axis); padded experts receive no routing weight and no tokens
    padded_experts: Optional[int] = None

    # DeepSeek-V3's knobs at their olmoe / granite values: class
    # attributes, not fields (see the module's docstring);
    # `DeepSeekMoEConfig` makes them fields
    scoring = "softmax"             # softmax (Switch balance loss) |
                                    # sigmoid (a bias, sequence-wise loss)
    routed_scale = 1.0              # the routed experts' output scale
    d_shared = 0                    # shared experts' total width, 0: none
    held_first = 0                  # first expert id held here
    held = None                     # experts held here (None: all)

    @property
    def e_pad(self) -> int:
        return self.padded_experts or self.num_experts

    @property
    def n_held(self) -> int:
        """Experts whose weights this device holds."""
        return self.e_pad if self.held is None else self.held


@dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    """DeepSeek-V3's routed experts (Moonlight): sigmoid scores over all
    ``num_experts``, the top k chosen by score + a correction bias (a
    parameter the train step leaves alone), weighted by the scores
    renormalised over the k and × ``routed_scale``; ``d_shared`` wide
    shared experts on every token; the sequence-wise balance loss
    (× ``router_aux_weight``).  The device holds experts
    [``held_first``, ``held_first + held``) of the router's: the share of
    one rank of expert parallelism."""
    scoring: str = "sigmoid"
    routed_scale: float = 1.0
    d_shared: int = 0
    held_first: int = 0
    held: Optional[int] = None


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention without a query LoRA (DeepSeek-V2/V3):
    q = y·W_q, 16 heads of ``qk_nope`` + ``qk_rope``; [c_kv | k_rope] =
    y·W_kva; c_kv normed (its own scale, ε ``kv_norm_eps``) and lifted to
    [k_nope | v] per head by W_kvb; one ``k_rope`` shared by all heads."""
    kv_rank: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    kv_norm_eps: float = 1e-6

    @property
    def qk_dim(self) -> int:
        return self.qk_nope + self.qk_rope


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64             # N
    head_dim: int = 64              # P (per SSM head)
    conv_width: int = 4
    expand: int = 2                 # inner dim = expand * d_model
    chunk: int = 64                 # SSD chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 7            # one sLSTM block per N mLSTM blocks
    qk_dim_factor: float = 0.5
    v_dim_factor: float = 1.0
    chunk: int = 64


@dataclass(frozen=True)
class HybridConfig:
    attn_period: int = 6            # shared attention block every N blocks
    shared_attention: bool = True   # Zamba2-style weight-shared block


@dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 24
    encoder_seq: int = 1500         # whisper: 30 s of audio @ 50 Hz


@dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 576          # anyres base tile
    vision_dim: int = 1024          # stubbed vision tower output width


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_kind: str                  # dense | moe | mamba2_hybrid | xlstm |
                                    # whisper | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None   # sub-quadratic attention for
                                           # long-context hybrid cells
    long_context_window: Optional[int] = None  # window the launcher applies
                                               # to attn for long_500k only
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    parallel_block: bool = False    # command-r: attn ∥ FFN from one norm
    accum_steps: int = 1            # gradient-accumulation microbatches
                                    # (training memory / HBM fit)
    max_seq: int = 4_096            # learned-position table size (whisper)
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "xla"          # xla (einsum) | pallas (the hand-
                                    # written flash kernel on a CUDA
                                    # tensor) | pallas_interpret (its
                                    # plain PyTorch version)
    remat: str = "none"             # none | full | dots
    scan_layers: bool = True
    # long-context capability (drives the long_500k dry-run cell)
    subquadratic: bool = False
    # per-arch logical→mesh rule overrides (e.g. heads→None when the head
    # count does not divide the model axis); tuple-of-pairs for hashability
    rules_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()
    # leading layers without experts: a field of `MLAModelConfig` alone
    first_k_dense = 0

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (drives 6·N·D in the roofline)."""
        d, hd = self.d_model, self.head_dim_
        attn = (d * self.n_heads * hd              # wq
                + 2 * d * self.n_kv_heads * hd     # wk, wv
                + self.n_heads * hd * d)           # wo
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.moe is not None:
            ff = self.moe.num_experts * 3 * d * self.moe.d_expert \
                + d * self.moe.num_experts
        elif self.d_ff > 0:
            ff = 3 * d * self.d_ff                 # SwiGLU
        else:
            ff = 0
        norms = 2 * d
        if self.arch_kind in ("mamba2_hybrid", "xlstm"):
            # SSM blocks are sized separately; rough closed forms below
            return self._ssm_param_count()
        per_layer = attn + ff + norms
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = self.n_layers * per_layer + embed + d
        if self.encdec is not None:
            # encoder self-attn + ffn + cross-attn already included per
            # layer for decoder; add encoder stack
            enc = self.encdec.encoder_layers * (attn + 3 * d * self.d_ff
                                                + norms)
            cross = self.n_layers * attn
            total += enc + cross
        if self.vlm is not None:
            total += self.vlm.vision_dim * d + d
        return total

    def _ssm_param_count(self) -> int:
        d = self.d_model
        s = self.ssm or SSMConfig()
        inner = s.expand * d
        if self.arch_kind == "xlstm":
            x = self.xlstm or XLSTMConfig()
            qk = int(d * x.qk_dim_factor)
            per = d * (2 * qk + 2 * d) + 2 * d * self.d_ff if self.d_ff \
                else d * (2 * qk + 2 * d) + 8 * d * d // 3
            return self.n_layers * per + 2 * self.vocab * d
        # mamba2: in_proj (d → 2*inner + 2*n_groups*state + heads), out_proj
        nheads = inner // s.head_dim
        per = (d * (2 * inner + 2 * s.state_dim + nheads)
               + inner * d + s.conv_width * (inner + 2 * s.state_dim)
               + 2 * nheads + 2 * d)
        total = self.n_layers * per + 2 * self.vocab * d
        if self.hybrid is not None and self.hybrid.shared_attention:
            hd = self.head_dim_
            attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d + 3 * d * self.d_ff)
            total += attn        # one shared block
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_ff = self.moe.num_experts * 3 * d * self.moe.d_expert
        active_ff = self.moe.top_k * 3 * d * self.moe.d_expert
        return self.param_count() - self.n_layers * (full_ff - active_ff)


@dataclass(frozen=True)
class MLAModelConfig(ModelConfig):
    """A DeepSeek-V3 block (``arch_kind`` "mla_moe"): latent attention
    (``mla``), the first ``first_k_dense`` layers a SwiGLU of ``d_ff``,
    the rest ``moe`` (a `DeepSeekMoEConfig`).  ``n_layers`` counts both."""
    mla: MLAConfig = MLAConfig()
    first_k_dense: int = 0

    def param_count(self) -> int:
        from ..models import get_model
        return get_model(self).param_count()

    def active_param_count(self) -> int:
        from ..models import get_model
        return get_model(self).active_param_count()


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                       # train_4k | prefill_32k | ...
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
