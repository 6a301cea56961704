"""The plain reference of the dense decoder (smollm, mistral-large): fp32
PyTorch, TF32 off, no kernel, no cache, no batching, and nothing of the
program under test.

Pre-norm blocks: RMSNorm, q/k/v projections with rotary embeddings on the
two halves of each head, causal grouped-query attention, the output
projection, then RMSNorm and a SwiGLU MLP, each added onto the residual
stream; a final RMSNorm and the output head (the embedding's transpose
where the two are tied).  Weights come as the benchmark's stacked tree:
``{"embedding", "ln_f", ["unembedding"], "layers": {"ln", "ln2", "wq",
"wk", "wv", "wo", "w_gate", "w_up", "w_down"}}``, leaves [L, ...].

``fp8=True`` is the control: every product of a weight (the projections,
the MLP and the output head) takes both operands rounded to float8 e4m3,
one scale per tensor, the precision below the configuration's bf16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

LAYER_KEYS = ("ln", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
              "w_down")
E4M3_MAX = 448.0


def exact_fp32() -> None:
    """fp32 products in full fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor, back in
    fp32."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    # straight through: the gradient of the rounding is taken as 1
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        x, w = to_fp8(x), to_fp8(w)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D] rotated at positions pos [S]: the first half of each
    head against the second."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv).float()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x2 * ang.cos() + x1 * ang.sin()], -1)


def attention(q, k, v, block: int) -> torch.Tensor:
    """Causal GQA over one sequence: q [S, H, D], k/v [S, Hkv, D] →
    [S, H·D]; query rows in blocks of ``block``."""
    s, h, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(s, hkv, h // hkv, d)
    out = []
    for i in range(0, s, block):
        j = min(s, i + block)
        logits = torch.einsum("qhgd,khd->hgqk", qg[i:j], k[:j]) / math.sqrt(d)
        mask = torch.arange(j, device=q.device)[None, :] \
            <= torch.arange(i, j, device=q.device)[:, None]
        probs = logits.masked_fill(~mask, float("-inf")).softmax(-1)
        out.append(torch.einsum("hgqk,khd->qhgd", probs, v[:j])
                   .reshape(j - i, h * d))
    return torch.cat(out)


def block(x, p, m, pos, fp8: bool, attn_block: int):
    """One pre-norm block on one sequence x [S, d]."""
    s, hd = x.shape[0], m["head_dim"]
    y = rms_norm(x, p["ln"], m["norm_eps"])
    q = rope(mm(y, p["wq"], fp8).view(s, m["n_heads"], hd), pos,
             m["rope_theta"])
    k = rope(mm(y, p["wk"], fp8).view(s, m["n_kv_heads"], hd), pos,
             m["rope_theta"])
    v = mm(y, p["wv"], fp8).view(s, m["n_kv_heads"], hd)
    x = x + mm(attention(q, k, v, attn_block), p["wo"], fp8)
    y = rms_norm(x, p["ln2"], m["norm_eps"])
    h = F.silu(mm(y, p["w_gate"], fp8)) * mm(y, p["w_up"], fp8)
    return x + mm(h, p["w_down"], fp8)


def head(params: Dict) -> torch.Tensor:
    return params.get("unembedding", params["embedding"])


@torch.no_grad()
def served_logits(params: Dict, m: Dict, seqs: Sequence[torch.Tensor],
                  rows: Sequence[torch.Tensor], modes=("fp32",),
                  attn_block: int = 512) -> Dict[str, List[torch.Tensor]]:
    """fp32 logits [len(rows[i]), V] of each sequence ``seqs[i]`` (token
    ids) at positions ``rows[i]``, one layer at a time: each layer's
    weights are taken to fp32 once for all sequences.  ``modes`` runs the
    fp32 reference ("fp32") and the control ("fp8") side by side."""
    dev = seqs[0].device
    emb = params["embedding"]
    xs = {mode: [emb[t].float() for t in seqs] for mode in modes}
    pos = [torch.arange(len(t), device=dev) for t in seqs]
    for li in range(m["n_layers"]):
        p = {k: params["layers"][k][li].float() for k in LAYER_KEYS}
        for mode in modes:
            xs[mode] = [block(x, p, m, q, mode == "fp8", attn_block)
                        for x, q in zip(xs[mode], pos)]
        del p
    w, ln_f = head(params).float().T, params["ln_f"].float()
    return {mode: [mm(rms_norm(x[r], ln_f, m["norm_eps"]), w, mode == "fp8")
                   for x, r in zip(xs[mode], rows)] for mode in modes}


def loss(params: Dict, m: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         fp8: bool = False, attn_block: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence, fp32, differentiable
    in ``params`` (a tree of fp32 leaves)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embedding"][tokens]
    per_layer = {k: params["layers"][k].unbind(0) for k in LAYER_KEYS}
    for li in range(m["n_layers"]):
        x = block(x, {k: v[li] for k, v in per_layer.items()}, m, pos, fp8,
                  attn_block)
    logits = mm(rms_norm(x, params["ln_f"], m["norm_eps"]), head(params).T,
                fp8)
    return F.cross_entropy(logits, labels.long())


def leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict's tensors by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def grads(params: Dict, m: Dict, tokens: torch.Tensor, labels: torch.Tensor,
          fp8: bool = False):
    """(mean loss over the batch, gradients by path) of a batch
    [B, S], one sequence at a time."""
    flat = leaves(params)
    live = {k: v.detach().requires_grad_() for k, v in flat.items()}
    tree = {"layers": {}}
    for k, v in live.items():
        if k.startswith("layers/"):
            tree["layers"][k[len("layers/"):]] = v
        else:
            tree[k] = v
    total = 0.0
    acc = {k: torch.zeros_like(v) for k, v in flat.items()}
    b = tokens.shape[0]
    for i in range(b):
        li = loss(tree, m, tokens[i], labels[i], fp8) / b
        g = torch.autograd.grad(li, list(live.values()), allow_unused=True)
        for k, gi in zip(live, g):
            if gi is not None:
                acc[k] += gi
        total += float(li.detach())
    return total, acc


def schedule(h: Dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_ratio`` · lr at ``decay_steps``."""
    if step < h["warmup_steps"]:
        return h["lr"] * step / max(1, h["warmup_steps"])
    prog = min(max((step - h["warmup_steps"])
                   / max(1, h["decay_steps"] - h["warmup_steps"]), 0.0), 1.0)
    return h["lr"] * (h["min_lr_ratio"] + (1 - h["min_lr_ratio"]) * 0.5
                      * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(h: Dict, params: Dict[str, torch.Tensor],
          grads_: Dict[str, torch.Tensor], state: Dict, step: int) -> float:
    """One AdamW step in place over flat fp32 ``params`` (by path):
    gradients clipped to a global norm of ``grad_clip``, bias-corrected
    moments, decoupled weight decay on every leaf of two or more dims.
    Returns the global norm before clipping."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads_.values()))
    scale = min(1.0, h["grad_clip"] / (gnorm + 1e-9))
    lr = schedule(h, step)
    bc1, bc2 = 1 - h["b1"] ** step, 1 - h["b2"] ** step
    for k, p in params.items():
        g = grads_[k] * scale
        mk = state.setdefault(("m", k), torch.zeros_like(p))
        vk = state.setdefault(("v", k), torch.zeros_like(p))
        mk.mul_(h["b1"]).add_((1 - h["b1"]) * g)
        vk.mul_(h["b2"]).add_((1 - h["b2"]) * g.square())
        upd = (mk / bc1) / ((vk / bc2).sqrt() + h["eps"])
        if p.ndim >= 2:
            upd = upd + h["weight_decay"] * p
        p.sub_(lr * upd)
    return gnorm
