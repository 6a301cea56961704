"""xLSTM (xlstm-1.3b) in PyTorch: mLSTM blocks with one sLSTM block per
`xlstm.slstm_every` layers.

mLSTM (matrix memory, exponential gating) runs full sequences in the
stabilised *chunkwise* form: quadratic within a chunk, the (C, n, m) state
carried across chunks.  sLSTM (scalar memory, a true recurrence through
the hidden state) steps through time.  The JAX package's `lax.scan`s over
chunks, time steps, groups and layers are Python loops over PyTorch ops
here, under the config's remat policy per layer; no kernel is written for
them.

Layer layout: n_layers = G groups × (slstm_every - 1 mLSTM + 1 sLSTM);
mLSTM params are stacked [G, K, ...], sLSTM params [G, ...], as in the
JAX package.  Decode writes its caches in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import map_shards_by_axes
from ..parallel.sharding import logical_constraint as lc
from . import layers as L
from .common import (P, decode_specs, group_views, layer_views,
                     padded_vocab, remat, stacked, to_dtype, token_specs)

# While a list, every `mlstm_chunked` chunk appends how far its
# normaliser sits above its floor, (|den| - exp(-m)) / exp(-m) [B, Q, H]
# (detached, on its device, no sync).  Where that is near 0, which side of
# max(|den|, exp(-m)) a position takes turns on rounding, and the
# gradient jumps there (the JAX package's formula has the same floor).
# For observing that from outside, e.g. a train step on two devices;
# None, the default, records nothing.
DEN_LOG = None


def _dims(cfg):
    x = cfg.xlstm
    d = cfg.d_model
    dk = int(d * x.qk_dim_factor)
    dv = int(d * x.v_dim_factor)
    h = cfg.n_heads
    return d, dk, dv, h, dk // h, dv // h


def _groups(cfg) -> Tuple[int, int]:
    every = cfg.xlstm.slstm_every
    if cfg.n_layers % every:
        raise ValueError(f"n_layers {cfg.n_layers} % slstm_every {every} "
                         "!= 0")
    return cfg.n_layers // every, every - 1     # (G groups, K mLSTM each)


def _slstm_ff(d: int) -> int:
    return max(128, (8 * d // 9) // 128 * 128)  # xLSTM pf=4/3 SwiGLU


# ------------------------------------------------------------------ schema
def mlstm_schema(cfg) -> Dict[str, P]:
    d, dk, dv, h, _, _ = _dims(cfg)
    return {
        "ln": P((d,), ("act_embed",), init="ones"),
        "wq": P((d, dk), ("embed", "heads"), init="scaled"),
        "wk": P((d, dk), ("embed", "heads"), init="scaled"),
        "wv": P((d, dv), ("embed", "mlp"), init="scaled"),
        "wif": P((d, 2 * h), ("embed", None), init="scaled"),
        "b_if": P((2 * h,), (None,), init="zeros"),
        "wg": P((d, dv), ("embed", "mlp"), init="scaled"),
        "wo": P((dv, d), ("mlp", "embed"), init="scaled"),
    }


def slstm_schema(cfg) -> Dict[str, P]:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    ff = _slstm_ff(d)
    return {
        "ln": P((d,), ("act_embed",), init="ones"),
        "w_zifo": P((d, 4 * d), ("embed", "mlp"), init="scaled"),
        "r_zifo": P((h, dh, 4 * dh), ("heads", None, None), init="scaled",
                    scale=0.5),
        "b_zifo": P((4 * d,), ("mlp",), init="zeros"),
        "wo": P((d, d), ("embed", "embed2"), init="scaled"),
        "ln2": P((d,), ("act_embed",), init="ones"),
        "w_gate": P((d, ff), ("embed", "mlp"), init="scaled"),
        "w_up": P((d, ff), ("embed", "mlp"), init="scaled"),
        "w_down": P((ff, d), ("mlp", "embed"), init="scaled"),
    }


def schema(cfg) -> Dict[str, Any]:
    g, k = _groups(cfg)
    v = padded_vocab(cfg)
    return {
        "embedding": P((v, cfg.d_model), ("vocab", "embed")),
        "unembedding": P((v, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("act_embed",), init="ones"),
        "mlstm": stacked(g, stacked(k, mlstm_schema(cfg))),
        "slstm": stacked(g, slstm_schema(cfg)),
    }


# ------------------------------------------------------- mLSTM chunked fwd
def mlstm_chunked(q, k, v, ig, fg, chunk: int,
                  state: Optional[Tuple] = None):
    """Stabilised chunkwise mLSTM.

    q,k: [B,S,H,dk]; v: [B,S,H,dv]; ig,fg: [B,S,H] raw gate pre-activations.
    state: (C [B,H,dv,dk], n [B,H,dk], m [B,H]) or None.
    Returns (h [B,S,H,dv], state').  fp32 throughout.
    """
    b, s, h, dk = q.shape
    qc = min(chunk, s)
    if s % qc:
        raise ValueError(f"sequence {s} is not a multiple of chunk {qc}")
    scale = 1.0 / np.sqrt(dk)
    q, k, v = (t.float() for t in (q, k, v))
    logf = F.logsigmoid(fg.float())                       # [B,S,H]
    logi = ig.float()
    if state is None:
        c_st = q.new_zeros((b, h, v.shape[-1], dk))
        n_st = q.new_zeros((b, h, dk))
        m_st = q.new_full((b, h), -float("inf"))
    else:
        c_st, n_st, m_st = (t.float() for t in state)
    tri = torch.ones((qc, qc), dtype=torch.bool, device=q.device).tril()

    # one split per operand: a slice per chunk would have each slice's
    # backward write a zero gradient of the whole sequence, O(S^2) bytes
    outs = []
    for qq, kk, vv, lii, lff in zip(*(t.split(qc, dim=1)
                                      for t in (q, k, v, logi, logf))):
        fcum = lff.cumsum(dim=1)                          # [B,Q,H]
        # intra log-weights D[i,j] = Fcum_i − Fcum_j + logi_j  (j ≤ i)
        dlog = fcum[:, :, None, :] - fcum[:, None, :, :] \
            + lii[:, None, :, :]                          # [B,Q,Q,H]
        dlog = dlog.masked_fill(~tri[None, :, :, None], -float("inf"))
        w_inter = fcum + m_st[:, None, :]                 # [B,Q,H]
        m_i = torch.maximum(dlog.amax(dim=2), w_inter)
        m_i = m_i.clamp_min(-1e30)                        # avoid -inf − -inf
        sc = torch.einsum("bihk,bjhk->bijh", qq, kk) * scale
        sc = sc * torch.exp(dlog - m_i[:, :, None, :])
        inter_w = torch.exp(w_inter - m_i)                # [B,Q,H]
        num = torch.einsum("bijh,bjhv->bihv", sc, vv) \
            + inter_w[..., None] \
            * torch.einsum("bihk,bhvk->bihv", qq, c_st) * scale
        den = sc.sum(dim=2) \
            + inter_w * torch.einsum("bihk,bhk->bih", qq, n_st) * scale
        floor = torch.exp(-m_i)
        if DEN_LOG is not None:
            DEN_LOG.append(((den.abs() - floor) / floor).detach())
        den = torch.maximum(den.abs(), floor)
        outs.append(num / den[..., None])                 # [B,Q,H,dv]

        # end-of-chunk state
        f_tot = fcum[:, -1]                               # [B,H]
        dlog_end = f_tot[:, None, :] - fcum + lii         # [B,Q,H]
        m_new = torch.maximum(f_tot + m_st, dlog_end.amax(dim=1))
        w_old = torch.exp(f_tot + m_st - m_new)           # [B,H]
        w_j = torch.exp(dlog_end - m_new[:, None, :])     # [B,Q,H]
        c_st = c_st * w_old[:, :, None, None] \
            + torch.einsum("bjhv,bjhk->bhvk", vv * w_j[..., None], kk)
        n_st = n_st * w_old[:, :, None] \
            + torch.einsum("bjh,bjhk->bhk", w_j, kk)
        m_st = m_new
    return torch.cat(outs, dim=1), (c_st, n_st, m_st)


def mlstm_step(state, q, k, v, ig, fg):
    """Single-token recurrent mLSTM.  q,k: [B,H,dk]; v: [B,H,dv];
    ig,fg: [B,H].  Returns (h [B,H,dv], state'), fp32."""
    c, n, m = (t.float() for t in state)
    q, k, v = (t.float() for t in (q, k, v))
    scale = 1.0 / np.sqrt(q.shape[-1])
    logf = F.logsigmoid(fg.float())
    logi = ig.float()
    m_new = torch.maximum(logf + m, logi)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(logi - m_new)
    c = c * fw[:, :, None, None] \
        + iw[:, :, None, None] * v[..., :, None] * k[..., None, :]
    n = n * fw[..., None] + iw[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", c, q) * scale
    den = torch.maximum((n * q).sum(dim=-1).abs() * scale,
                        torch.exp(-m_new))
    return num / den[..., None], (c, n, m_new)


def mlstm_block(params, x, cfg, rules=None, state=None):
    """Pre-norm mLSTM block.  Returns (out, new_state): a full sequence
    with state=None (zero initial state, discarded), or one token x
    [B,1,d] against state = (C, n, m)."""
    _, _, dv, h, dkh, dvh = _dims(cfg)
    dt = to_dtype(cfg.compute_dtype)
    y = L.rms_norm(x, params["ln"], cfg.norm_eps)
    b, s, _ = y.shape

    def proj(name):
        # the 4 heads cannot shard a 16-wide model axis: computed on slices
        # of the weight, then gathered before the view
        w = lc(params[name], ("embed", "act_mlp"), rules)
        return L.gathered(L.linear(y, w, dt), rules)

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    gates = L.linear(y.float(), params["wif"], torch.float32) \
        + params["b_if"].float()
    ig, fg = gates[..., :h], gates[..., h:]

    if state is None:
        qh = lc(q.view(b, s, h, dkh), ("batch", "seq", "heads", None), rules)
        # the chunk recurrence runs on each rank's shards, the whole
        # sequence in hand
        seq4, seq3, st4 = (("batch", None, "heads", None),
                           ("batch", None, "heads"),
                           ("batch", "heads", None, None))
        hh, _ = map_shards_by_axes(
            lambda *t: mlstm_chunked(*t, cfg.xlstm.chunk),
            (qh, k.view(b, s, h, dkh), v.view(b, s, h, dvh), ig, fg),
            (seq4, seq4, seq4, seq3, seq3),
            (seq4, st4, st4[:3], st4[:2]), rules)
        new_state = None
    else:
        hh, new_state = mlstm_step(state, q[:, 0].view(b, h, dkh),
                                   k[:, 0].view(b, h, dkh),
                                   v[:, 0].view(b, h, dvh),
                                   ig[:, 0], fg[:, 0])
        hh = hh[:, None]
    # merged whole, and its gradient split into heads whole (the middle
    # constraint): the 4 heads cannot split a 16-wide model axis
    hv = lc(lc(lc(hh, ("batch", "seq", "heads", None), rules)
               .reshape(b, s, dv), ("batch", "seq", None), rules),
            ("batch", "seq", "act_mlp"), rules).to(dt)
    g = F.silu(L.linear(y, params["wg"], dt))
    out = L.linear(hv * g, params["wo"], dt)
    return lc(out, ("batch", "seq", "act_embed"), rules), new_state


# ------------------------------------------------------------------- sLSTM
def slstm_scan(params, y, cfg, state=None, rules=None):
    """y: [B,S,d] (already normed).  Returns (h [B,S,d], state'), fp32;
    state = (c, n, m, h_prev), each [B,H,dh].

    On a mesh, a call of one step (decode, or a prefill of one token) goes
    through DTensor with the recurrent weight sliced on its gate dim over
    the model axis, so the model ranks split the recurrent product; per
    shard each of them would compute it whole for its batch rows (the
    xlstm decode cell of `tests/test_torch_dryrun_sharded.py`: 1.28 × the
    JAX package's FLOPs per device, against 1.00 × through DTensor).  A
    call of many steps runs the time loop on each rank's shards
    (`map_shards_by_axes`): through DTensor every step would gather what
    it slices.  Both are held to the unsharded loop in
    `tests/test_torch_sharded_values.py`."""
    b, s, d = y.shape
    h = cfg.n_heads
    wx = L.linear(y.float(), params["w_zifo"], torch.float32) \
        + params["b_zifo"].float()                        # [B,S,4d]
    wx = L.gathered(wx, rules).view(b, s, h, 4 * d // h)
    if s == 1:
        # the 4 heads cannot shard the model axis: r_zifo's gate dim does
        return _slstm_loop(lc(params["r_zifo"], ("heads", None, "act_mlp"),
                              rules), wx, *(state or ()))
    st = ("batch", "heads", None)
    state = tuple(state or (None,) * 4)
    return map_shards_by_axes(
        _slstm_loop, (params["r_zifo"], wx) + state,
        (("heads", None, None), ("batch", None, "heads", None)) + (st,) * 4,
        (("batch", None, "heads"),) + (st,) * 4, rules)


def _slstm_loop(r, wx, c=None, n=None, m=None, h_prev=None):
    """The sLSTM recurrence over wx [B,S,H,4dh] with the recurrent
    weights r [H, dh, 4dh]; the state (c, n, m, h_prev) or a fresh one."""
    b, s, h, dh4 = wx.shape
    dh = dh4 // 4
    r = r.float()
    if c is None:
        zeros = wx.new_zeros((b, h, dh))
        c, n, m, h_prev = (zeros, zeros + 1e-6,
                           wx.new_full((b, h, dh), -1e30), zeros)
    c, n, m, h_prev = (t.float() for t in (c, n, m, h_prev))
    hs = []
    # unbound once, as the JAX package scans over the time-major wx: an
    # index per step would have each step's backward write a zero gradient
    # of the whole of wx, O(S^2) bytes
    for wt in wx.unbind(1):
        g = wt + torch.einsum("bhd,hdg->bhg", h_prev, r)
        zr, ir, fr, orr = g.split(dh, dim=-1)            # [B,H,dh] each
        logf = F.logsigmoid(fr)
        m_new = torch.maximum(logf + m, ir)
        fw = torch.exp(logf + m - m_new)
        iw = torch.exp(ir - m_new)
        c = fw * c + iw * torch.tanh(zr)
        n = fw * n + iw
        h_prev = torch.sigmoid(orr) * c / n.clamp_min(1e-6)
        m = m_new
        hs.append(h_prev)
    return torch.stack(hs, dim=1).reshape(b, s, h * dh), (c, n, m, h_prev)


def slstm_block(params, x, cfg, rules=None, state=None):
    """sLSTM block and its SwiGLU feed-forward, residuals included.
    Returns (x', new_state)."""
    dt = to_dtype(cfg.compute_dtype)
    y = L.rms_norm(x, params["ln"], cfg.norm_eps)
    hs, new_state = slstm_scan(params, y, cfg, state=state, rules=rules)
    hs = lc(hs, ("batch", "seq", "act_embed"), rules)
    # wo's output dim is not sharded by the rules ("embed2"): computed on
    # slices of it and gathered, as the gate projection is
    wo = lc(params["wo"], ("embed", "act_mlp"), rules)
    out = lc(L.gathered(L.linear(hs.to(dt), wo, dt), rules),
             ("batch", "seq", "act_embed"), rules)
    x = x + out
    x = x + L.swiglu({**params, "ln": params["ln2"]}, x, cfg, rules=rules)
    return x, new_state


# ----------------------------------------------------------------- forward
def forward(params, batch, cfg, rules=None) -> torch.Tensor:
    x = L.embed(params, batch["tokens"], cfg, rules)

    def mbody(p, x):
        return x + mlstm_block(p, x, cfg, rules=rules)[0]

    def sbody(p, x):
        return slstm_block(p, x, cfg, rules=rules)[0]

    mbody, sbody = remat(mbody, cfg), remat(sbody, cfg)
    for group, sp in zip(group_views(params["mlstm"]),
                         layer_views(params["slstm"])):
        for p in group:
            x = mbody(p, x)
        x = sbody(sp, x)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg, rules)


# ------------------------------------------------------------------ decode
def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """The recurrent state of every layer, fp32, of a size independent of
    ``max_len``; the stabilisers start at -1e30 and the sLSTM normaliser
    at 1e-6, as a fresh `slstm_scan` state."""
    g, k = _groups(cfg)
    d, _, _, h, dkh, dvh = _dims(cfg)
    dh = d // h
    s_axes = (None, "batch", "heads", None)
    return {
        "m_c": P((g, k, batch, h, dvh, dkh),
                 (None, "layers", "batch", "heads", "mlp", None),
                 init="zeros", dtype="float32"),
        "m_n": P((g, k, batch, h, dkh),
                 (None, "layers", "batch", "heads", None),
                 init="zeros", dtype="float32"),
        "m_m": P((g, k, batch, h),
                 (None, "layers", "batch", "heads"),
                 init="neg_large", dtype="float32"),
        "s_c": P((g, batch, h, dh), s_axes, init="zeros", dtype="float32"),
        "s_n": P((g, batch, h, dh), s_axes, init="eps", dtype="float32"),
        "s_m": P((g, batch, h, dh), s_axes, init="neg_large",
                 dtype="float32"),
        "s_h": P((g, batch, h, dh), s_axes, init="zeros", dtype="float32"),
    }


def decode_step(params, cache, batch, cfg, rules=None):
    """One token: batch = {"tokens": [B,1], "pos": [B]} (the state holds
    the history, so positions are not read).  Returns (logits [B,1,V],
    cache); every state leaf is updated in place."""
    x = L.embed(params, batch["tokens"], cfg, rules)
    for g, (group, sp) in enumerate(zip(group_views(params["mlstm"]),
                                        layer_views(params["slstm"]))):
        for i, p in enumerate(group):
            st = (cache["m_c"][g, i], cache["m_n"][g, i], cache["m_m"][g, i])
            out, new = mlstm_block(p, x, cfg, rules=rules, state=st)
            for dst, src in zip(st, new):
                dst.copy_(src)
            x = x + out
        st = tuple(cache[name][g] for name in ("s_c", "s_n", "s_m", "s_h"))
        x, new = slstm_block(sp, x, cfg, rules=rules, state=st)
        for dst, src in zip(st, new):
            dst.copy_(src)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params, x, cfg, rules), cache


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """The step's inputs at ``shape`` as meta tensors."""
    if shape.kind == "decode":
        return decode_specs(shape.global_batch)
    return token_specs(shape.global_batch, shape.seq_len)
