"""The plain reference of the DeepSeek-V3 block (Moonlight-16B-A3B): fp32
PyTorch, TF32 off, no kernel, no cache, and nothing of the program under
test.

Pre-norm blocks of multi-head latent attention and then, in the first
``first_k_dense`` layers, a SwiGLU, in the others the routed experts:

- attention: q = y·W_q, H heads of nope + rope dims; [c_kv | k_rope] =
  y·W_kva; c_kv ← RMSNorm(c_kv) with its own scale (ε ``kv_norm_eps``);
  [k_nope | v] = c_kv·W_kvb per head; rotary (θ ``rope_theta``, the two
  halves of the rope dims) on each head's q_rope and on the one k_rope
  that all heads share; causal softmax(QKᵀ / sqrt(nope + rope))·V, then
  W_o;
- experts: s = sigmoid(y·W_r) in fp32 over all ``n_experts``; the top k
  by s + b (b the correction bias, which only selects); weights
  ``routed_scale`` · s_i / (Σ_top s_j + 1e-20); each choice's slot is the
  count of earlier choices of its expert over the microbatch's tokens in
  order, and a choice at a slot past ceil(T·k / E · ``capacity_factor``)
  is dropped; only the experts held, [``held_first``, ``held_first`` +
  ``held``), compute their choices (an absent expert adds nothing); the
  shared experts, one SwiGLU of ``d_shared``, on every token;
- the sequence-wise balance loss, per sequence of S tokens: f_i =
  E / (k·S) · (choices of expert i), P_i = mean over its tokens of
  s_i / Σ_j s_j, ``aux_alpha`` · Σ_i f_i P_i, summed over the layers and
  added to the mean next-token cross-entropy of the microbatch.

A batch is taken in microbatches of ``microbatch_rows`` rows, as the
program's step takes it (capacity and slots count a microbatch's tokens),
the loss and gradients the mean over them.  Each layer is recomputed in
the backward from its input, kept from a forward without gradients, so
that a step at 8 × 4096 fits beside the harness's copies.  The AdamW
moments live on the host.

Weights come as the benchmark's tree (`bench/families/mla_moe.py`): the
dense layers' leaves ``dense_<leaf>`` [K, ...] at the top, the expert
layers' under ``layers``.  ``fp8=True`` is the control: every product of
a weight but the router's (the projections, the experts, the dense and
shared SwiGLUs, the output head; the program computes the router in fp32)
takes both operands rounded to float8 e4m3, one scale per tensor.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

# the dense reference's plain pieces: fp32 set-up, the fp8 control's
# rounding, RMSNorm, half-split rotary, the output head, the tree's paths,
# the schedule
from .dense import (exact_fp32, head, leaves, mm, rms_norm,  # noqa: F401
                    rope, schedule)

ATTN_KEYS = ("ln", "wq", "wkva", "kv_ln", "wkvb", "wo", "ln2")
FFN_KEYS = ("w_gate", "w_up", "w_down")
MOE_KEYS = ATTN_KEYS + FFN_KEYS + ("router", "router_bias", "shared_gate",
                                   "shared_up", "shared_down")
DENSE = "dense_"
# never trained: selection reads it, nothing differentiates through it
FROZEN = ("layers/router_bias",)

# While a list, every expert layer appends its routing: "top_e" [T, k]
# and "keep" [T, k] (the choices within capacity), for comparing with the
# program's `layers.ROUTE_LOG`.
ROUTE_LOG: Optional[List[Dict[str, torch.Tensor]]] = None
# While a list, each expert layer takes its choices top_e [T, k] from the
# front of it in place of choosing by s + b: another run's routing (the
# program's `layers.ROUTE_LOG`), in the order the layers run here (each
# microbatch's forward, then its blocks' recompute in reverse), so that a
# comparison reads what is left with the routing flips taken out.  The
# weights still come from this run's s; slots and drops follow the
# choices given.
ROUTES_GIVEN: Optional[List[torch.Tensor]] = None


def attention(q, k, v, block: int) -> torch.Tensor:
    """Causal attention over one sequence: q, k [S, H, Dqk], v [S, H, Dv]
    → [S, H·Dv]; query rows in blocks of ``block``."""
    s, h, d = q.shape
    out = []
    for i in range(0, s, block):
        j = min(s, i + block)
        logits = torch.einsum("qhd,khd->hqk", q[i:j], k[:j]) / math.sqrt(d)
        mask = torch.arange(j, device=q.device)[None, :] \
            <= torch.arange(i, j, device=q.device)[:, None]
        probs = logits.masked_fill(~mask, float("-inf")).softmax(-1)
        out.append(torch.einsum("hqk,khd->qhd", probs, v[:j])
                   .reshape(j - i, -1))
    return torch.cat(out)


def mla(x, p, m, fp8: bool, block: int) -> torch.Tensor:
    """Latent attention of one sequence x [S, d] (already its own
    residual stream), before the residual add."""
    s, h = x.shape[0], m["n_heads"]
    nope, rdim = m["qk_nope"], m["qk_rope"]
    pos = torch.arange(s, device=x.device)
    y = rms_norm(x, p["ln"], m["norm_eps"])
    q = mm(y, p["wq"], fp8).view(s, h, nope + rdim)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, m["rope_theta"])],
                  -1)
    c_kv, k_rope = mm(y, p["wkva"], fp8).split([m["kv_rank"], rdim], -1)
    c_kv = rms_norm(c_kv, p["kv_ln"], m["kv_norm_eps"])
    k_nope, v = mm(c_kv, p["wkvb"], fp8).view(s, h, nope + m["v_dim"]) \
        .split([nope, m["v_dim"]], -1)
    k_rope = rope(k_rope.view(s, 1, rdim), pos, m["rope_theta"])
    k = torch.cat([k_nope, k_rope.expand(s, h, rdim)], -1)
    return mm(attention(q, k, v, block), p["wo"], fp8)


def swiglu(y, gate, up, down, fp8: bool) -> torch.Tensor:
    return mm(F.silu(mm(y, gate, fp8)) * mm(y, up, fp8), down, fp8)


def experts(x, p, m, rows: int, fp8: bool):
    """The expert layer on a microbatch x [T, d] of ``rows`` sequences:
    (the held experts' and the shared experts' sum [T, d], the balance
    loss)."""
    t, e, k = x.shape[0], m["n_experts"], m["top_k"]
    y = rms_norm(x, p["ln2"], m["norm_eps"])
    s = torch.sigmoid(y @ p["router"])                     # fp32 always
    if ROUTES_GIVEN is not None:
        top_e = ROUTES_GIVEN.pop(0)
        if top_e.shape != (t, k):
            raise ValueError(f"reference: routing given {tuple(top_e.shape)}"
                             f" for {t} tokens of {k} choices")
    else:
        top_e = torch.topk(s + p["router_bias"].detach(), k, dim=-1).indices
    w = s.gather(-1, top_e)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"]
    capacity = max(math.ceil(t * k / e * m["capacity_factor"]), 1)
    onehot = F.one_hot(top_e.reshape(-1), e)               # [T·k, E]
    slot = (onehot.cumsum(0) * onehot).sum(-1) - 1
    keep = (slot < capacity).view(t, k)
    if ROUTE_LOG is not None:
        ROUTE_LOG.append({"top_e": top_e, "keep": keep})
    out = swiglu(y, p["shared_gate"], p["shared_up"], p["shared_down"], fp8)
    for i in range(m["held"]):
        tok, j = torch.nonzero((top_e == m["held_first"] + i) & keep,
                               as_tuple=True)
        if tok.numel() == 0:
            continue
        h = swiglu(y[tok], p["w_gate"][i], p["w_up"][i], p["w_down"][i],
                   fp8)
        out = out.index_add(0, tok, h * w[tok, j, None])
    per_seq = t // rows
    counts = onehot.view(rows, per_seq * k, e).sum(1).float()
    f = counts * (e / (k * per_seq))
    share = (s / s.sum(-1, keepdim=True)).view(rows, per_seq, e).mean(1)
    aux = m["aux_alpha"] * (f * share).sum(-1).mean()
    return out, aux


def layer(x, p, m, dense: bool, rows: int, fp8: bool, block: int):
    """One block on a microbatch x [rows · S, d]: (x out, balance loss)."""
    s = x.shape[0] // rows
    x = x + torch.cat([mla(x[r * s:(r + 1) * s], p, m, fp8, block)
                       for r in range(rows)])
    if dense:
        y = rms_norm(x, p["ln2"], m["norm_eps"])
        return x + swiglu(y, p["w_gate"], p["w_up"], p["w_down"], fp8), \
            x.new_zeros(())
    out, aux = experts(x, p, m, rows, fp8)
    return x + out, aux


def blocks(params: Dict, m: Dict) -> List[tuple]:
    """Each block in order: (dense?, its index, its leaves by name)."""
    out = []
    for i in range(m["first_k_dense"]):
        out.append((True, i, {k: params[DENSE + k][i]
                              for k in ATTN_KEYS + FFN_KEYS}))
    per = {k: params["layers"][k].unbind(0) for k in MOE_KEYS}
    for i in range(m["n_layers"] - m["first_k_dense"]):
        out.append((False, i, {k: v[i] for k, v in per.items()}))
    return out


def forward(params: Dict, m: Dict, tokens: torch.Tensor, fp8: bool = False,
            attn_block: int = 1024):
    """(fp32 logits [rows · S, V], summed balance loss) of one microbatch
    of token rows [rows, S]."""
    rows = tokens.shape[0]
    x = params["embedding"][tokens.reshape(-1)]
    aux = x.new_zeros(())
    for dense, _, p in blocks(params, m):
        x, a = layer(x, p, m, dense, rows, fp8, attn_block)
        aux = aux + a
    logits = mm(rms_norm(x, params["ln_f"], m["norm_eps"]), head(params).T,
                fp8)
    return logits, aux


def grads(params: Dict, m: Dict, tokens: torch.Tensor, labels: torch.Tensor,
          fp8: bool = False, attn_block: int = 1024):
    """(mean loss over the batch, gradients by path) of a batch [B, S], in
    microbatches of ``m["microbatch_rows"]`` rows: each microbatch's loss
    is its mean cross-entropy plus its layers' balance losses, and the
    batch's the mean over the microbatches.  Each block's gradient comes
    from a recompute of the block alone."""
    flat = leaves(params)
    acc = {k: torch.zeros_like(v) for k, v in flat.items()}
    rows = m["microbatch_rows"]
    n_mb = tokens.shape[0] // rows
    total = 0.0
    for j in range(n_mb):
        tok = tokens[j * rows:(j + 1) * rows]
        lab = labels[j * rows:(j + 1) * rows].reshape(-1).long()
        bl = blocks(params, m)
        inputs = []
        with torch.no_grad():
            x = params["embedding"][tok.reshape(-1)]
            for dense, _, p in bl:
                inputs.append(x)
                x, _ = layer(x, p, m, dense, rows, fp8, attn_block)
        xl = x.requires_grad_()
        top = {k: params[k].detach().requires_grad_()
               for k in ("ln_f", "unembedding") if k in params}
        ce = F.cross_entropy(
            mm(rms_norm(xl, top["ln_f"], m["norm_eps"]),
               top.get("unembedding", params["embedding"]).T, fp8), lab)
        g = torch.autograd.grad(ce / n_mb, [xl, *top.values()])
        gx = g[0]
        for k, gk in zip(top, g[1:]):
            acc[k] += gk
        loss = float(ce.detach())
        for (dense, i, p), xin in zip(reversed(bl), reversed(inputs)):
            xin = xin.requires_grad_()
            live = {k: v.detach().requires_grad_() for k, v in p.items()
                    if k != "router_bias"}
            out, aux = layer(xin, {**p, **live}, m, dense, rows, fp8,
                             attn_block)
            outs, grad_outs = [out], [gx]
            if not dense:
                outs.append(aux)
                grad_outs.append(torch.full_like(aux, 1.0 / n_mb))
                loss += float(aux.detach())
            # an expert no choice reached has no gradient
            g = torch.autograd.grad(outs, [xin, *live.values()], grad_outs,
                                    allow_unused=True)
            gx = g[0]
            for k, gk in zip(live, g[1:]):
                if gk is not None:
                    acc[DENSE + k if dense else f"layers/{k}"][i] += gk
            del out, aux, g
        acc["embedding"].index_add_(0, tok.reshape(-1), gx)
        total += loss / n_mb
    return total, acc


def served_logits(*args, **kwargs):
    raise NotImplementedError("mla_moe: the port serves no latent "
                              "attention; this family is trained only")


@torch.no_grad()
def adamw(h: Dict, params: Dict[str, torch.Tensor],
          grads_: Dict[str, torch.Tensor], state: Dict, step: int) -> float:
    """One AdamW step in place over flat fp32 ``params`` (by path):
    gradients clipped to a global norm of ``grad_clip``, bias-corrected
    moments (kept on the host), decoupled weight decay on every leaf of
    two or more dims; the leaves in ``FROZEN`` get no step and no decay.
    Returns the global norm before clipping."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads_.values()))
    scale = min(1.0, h["grad_clip"] / (gnorm + 1e-9))
    lr = schedule(h, step)
    bc1, bc2 = 1 - h["b1"] ** step, 1 - h["b2"] ** step
    for k, p in params.items():
        if k in FROZEN:
            continue
        g = grads_[k] * scale
        host = (state.setdefault(("m", k), torch.zeros_like(p, device="cpu")),
                state.setdefault(("v", k), torch.zeros_like(p, device="cpu")))
        mk, vk = (t.to(p.device) for t in host)
        mk.mul_(h["b1"]).add_((1 - h["b1"]) * g)
        vk.mul_(h["b2"]).add_((1 - h["b2"]) * g.square())
        upd = (mk / bc1) / ((vk / bc2).sqrt() + h["eps"])
        if p.ndim >= 2:
            upd = upd + h["weight_decay"] * p
        p.sub_(lr * upd)
        host[0].copy_(mk)
        host[1].copy_(vk)
    return gnorm
