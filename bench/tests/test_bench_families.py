"""Model families found by name.

The dense family draws the same weights and counts the same work as the
harness did before it had families (kept here as the oracle); a family
that lives in the test tree alone runs a serving and a training cell; a
family or reference that is not there fails at once, naming the file it
looked for; a serving mix with no shared prompts runs without a fork."""
import math
import re
import sys

import pytest
import torch

from bench.families import dense
from bench.harness import arith, cell, weights
from bench.reference import dense as dense_ref
from bench.tests import probe_family, smoke

# --- the harness before families: its sizes, leaves, draw and counts -----

OLD_KEYS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
            "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
            "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
            "vocab_size": "vocab", "rope_theta": "rope_theta",
            "rms_norm_eps": "norm_eps",
            "tie_word_embeddings": "tie_embeddings"}


def old_sizes(config):
    return {ours: config[theirs] for theirs, ours in OLD_KEYS.items()}


def old_shapes(m):
    d, hd, n = m["d_model"], m["head_dim"], m["n_layers"]
    out = {
        "embedding": ((m["vocab"], d), "embed"),
        "ln_f": ((d,), "norm"),
        "layers/ln": ((n, d), "norm"),
        "layers/ln2": ((n, d), "norm"),
        "layers/wq": ((n, d, m["n_heads"] * hd), "fan_in"),
        "layers/wk": ((n, d, m["n_kv_heads"] * hd), "fan_in"),
        "layers/wv": ((n, d, m["n_kv_heads"] * hd), "fan_in"),
        "layers/wo": ((n, m["n_heads"] * hd, d), "fan_in"),
        "layers/w_gate": ((n, d, m["d_ff"]), "fan_in"),
        "layers/w_up": ((n, d, m["d_ff"]), "fan_in"),
        "layers/w_down": ((n, m["d_ff"], d), "fan_in"),
    }
    if not m["tie_embeddings"]:
        out["unembedding"] = ((m["vocab"], d), "embed")
    return out


@torch.no_grad()
def old_draw(m, seed, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {"layers": {}}
    for name, (shape, kind) in old_shapes(m).items():
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if kind == "fan_in":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "embed":
            t.mul_(0.02)
        else:
            t.mul_(0.1).add_(1.0)
        if name.startswith("layers/"):
            tree["layers"][name[len("layers/"):]] = t
        else:
            tree[name] = t
    return tree


def old_layer_matmul_params(cfg):
    d, h, hkv, hd, ff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                         cfg["head_dim"], cfg["d_ff"])
    return d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * ff


def old_matmul_params(cfg):
    return cfg["n_layers"] * old_layer_matmul_params(cfg) \
        + cfg["vocab"] * cfg["d_model"]


def old_weight_bytes(cfg, itemsize=2):
    norms = cfg["n_layers"] * 2 * cfg["d_model"] + cfg["d_model"]
    return (old_matmul_params(cfg) + norms) * itemsize


def old_attention_flops(cfg, s, cached=0):
    return cfg["n_layers"] * 4 * cfg["n_heads"] * cfg["head_dim"] \
        * (arith.causal_pairs(s) - arith.causal_pairs(cached))


def old_prefill_flops(cfg, s, cached=0):
    return 2 * cfg["n_layers"] * old_layer_matmul_params(cfg) * (s - cached) \
        + 2 * cfg["vocab"] * cfg["d_model"] \
        + old_attention_flops(cfg, s, cached)


def old_decode_flops(cfg, rows, keys):
    per_key = cfg["n_layers"] * 4 * cfg["n_heads"] * cfg["head_dim"]
    return 2 * old_matmul_params(cfg) * rows + per_key * keys


def old_decode_bytes(cfg, unique_tokens):
    return old_weight_bytes(cfg) + cfg["n_layers"] * 2 * cfg["n_kv_heads"] \
        * cfg["head_dim"] * unique_tokens * 2


def old_train_flops(cfg, batch, s):
    return 6 * old_matmul_params(cfg) * batch * s \
        + 3 * batch * old_attention_flops(cfg, s)


def old_bwd_bound_s(b, s, h, hkv, d):
    flops = 10 * d * b * h * arith.causal_pairs(s)
    nbytes = arith.BF16_BYTES * (4 * b * s * h * d + 4 * b * s * hkv * d)
    return arith.bound_s(nbytes, flops)


def _adds(ctx):
    return [s for s in ctx["spans"] if s[0] == "engine.add"]


def old_mfu_prefill(ctx):
    adds = _adds(ctx)
    flops = sum(old_prefill_flops(ctx["sizes"], n, cached)
                for *_, n, cached in adds)
    secs = sum(t1 - t0 for _, t0, t1, *_ in adds)
    return 100 * flops / (secs * arith.BF16_FLOPS)


def old_mfu_decode(ctx):
    m, steps = ctx["sizes"], ctx["steps"]
    least = sum(arith.bound_s(old_decode_bytes(m, unique),
                              old_decode_flops(m, rows, keys))
                for _, _, rows, keys, _, unique in steps)
    return 100 * least / sum(t1 - t0 for t0, t1, *_ in steps)


def old_flash_roofline_prefill(ctx):
    m = ctx["sizes"]
    least = m["n_layers"] * sum(
        arith.flash_bound_s(1, n, m["n_heads"], m["n_kv_heads"],
                            m["head_dim"], cached)
        for *_, n, cached in _adds(ctx))
    return 100 * least / ctx["trace"].seconds(["flash_bf16"])


def old_paged_roofline_decode(ctx):
    m = ctx["sizes"]
    least = m["n_layers"] * sum(
        arith.paged_bound_s(m["n_heads"], m["n_kv_heads"], m["head_dim"],
                            rows, keys, longest, unique, ctx["page_tokens"])
        for _, _, rows, keys, longest, unique in ctx["steps"])
    return 100 * least / ctx["trace"].seconds(["paged_fwd", "paged_merge"])


def old_mfu_train(ctx):
    # the parent's count over the steps' time on the card
    secs = ctx["step_ends"][-1] - ctx["window_start"]
    flops = len(ctx["step_ends"]) * old_train_flops(
        ctx["sizes"], ctx["batch"], ctx["seq_len"])
    return 100 * flops / (secs * arith.BF16_FLOPS)


def old_train_roofline(per_call, kernel):
    def read(ctx):
        m, k = ctx["sizes"], ctx["accum_steps"]
        least = ctx["steps"] * k * m["n_layers"] * per_call(
            ctx["batch"] // k, ctx["seq_len"], m["n_heads"],
            m["n_kv_heads"], m["head_dim"])
        return 100 * least / ctx["trace"].seconds([kernel])
    return read


class Trace:
    """A device trace that holds ``secs`` seconds of each named kernel."""

    def __init__(self, **secs):
        self.secs = secs

    def seconds(self, names):
        hits = [self.secs[n] for n in names if n in self.secs]
        return sum(hits) if hits else None


SERVE_CTX = {
    "sizes": dense.sizes(weights.load_config("mistral-large-123b.pp4")),
    "family": dense, "page_tokens": 16,
    "spans": [("engine.add", 10.0, 10.93, 1000, 600),
              ("engine.step", 10.93, 10.97, 2),
              ("engine.add", 11.0, 11.31, 2216, 2200),
              ("engine.add", 11.4, 11.47, 37, 0)],
    "steps": [(11.0, 11.0371, 2, 1640, 1001, 1040),
              (11.5, 11.5383, 3, 4000, 2300, 2805),
              (11.6, 11.6379, 5, 6001, 2301, 3377)],
    "trace": Trace(flash_bf16=0.0123, paged_fwd=0.0301, paged_merge=0.0017)}
TRAIN_CTX = {
    "sizes": dense.sizes(weights.load_config("smollm-360m")),
    "family": dense, "steps": 17, "batch": 8, "seq_len": 2048,
    "accum_steps": 2, "window_start": 0.0, "step_ends": [0.38, 0.771],
    "spans": [("pipeline.next", 0.0, 0.0011, 0),
              ("train_step", 0.0011, 0.38, 0),
              ("pipeline.next", 0.38, 0.3817, 0),
              ("train_step", 0.3817, 0.771, 0)],
    "trace": Trace(flash_bf16=0.31, flash_bwd=0.77)}
ORACLE = {
    "mfu.prefill": (SERVE_CTX, old_mfu_prefill),
    "mfu.decode": (SERVE_CTX, old_mfu_decode),
    "flash_roofline.prefill": (SERVE_CTX, old_flash_roofline_prefill),
    "paged_roofline.decode": (SERVE_CTX, old_paged_roofline_decode),
    "mfu.train": (TRAIN_CTX, old_mfu_train),
    "flash_roofline.train": (TRAIN_CTX, old_train_roofline(
        arith.flash_bound_s, "flash_bf16")),
    "flash_bwd_roofline.train": (TRAIN_CTX, old_train_roofline(
        old_bwd_bound_s, "flash_bwd")),
}


# --- the dense family against the oracle ---------------------------------

@pytest.mark.parametrize("name", smoke.CELLS)
def test_dense_family_draws_the_weights_drawn_before(name):
    config = smoke.config(name)
    section = config["serving" if name == smoke.SERVE else "training"]
    dtype = getattr(torch, section["param_dtype"])
    assert dense.sizes(config) == old_sizes(config)
    got = weights.draw(dense.shapes(dense.sizes(config)), smoke.SEED, dtype,
                       smoke.CPU)
    want = old_draw(old_sizes(config), smoke.SEED, dtype, smoke.CPU)
    assert list(got) == list(want)
    got, want = weights.leaves(got), weights.leaves(want)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("metric", sorted(ORACLE))
def test_reader_reads_what_it_read_before(metric):
    ctx, old = ORACLE[metric]
    got = cell.reader(metric)(ctx)
    assert got is not None and got == old(ctx)


@pytest.mark.parametrize("metric", [
    "flash_roofline.prefill", "paged_roofline.decode",
    "flash_roofline.train", "flash_bwd_roofline.train"])
def test_roofline_readers_charge_the_familys_attention_layers(metric):
    ctx, _ = ORACLE[metric]
    probe_family.CALLS.clear()
    got = cell.reader(metric)(dict(ctx, family=probe_family))
    assert probe_family.CALLS == ["attention_layers"]
    assert got == pytest.approx(
        probe_family.SCALE * cell.reader(metric)(ctx), rel=1e-12)


# --- a family that the harness does not know of --------------------------

@pytest.fixture
def probe(monkeypatch):
    """The probe family where ``bench/families/probe.py`` would be; what
    the harness called of the dense reference, drew, and read from."""
    monkeypatch.setitem(sys.modules, "bench.families.probe", probe_family)
    probe_family.CALLS.clear()
    seen = {"reference": [], "drawn": []}
    for fn in ("served_logits", "grads"):
        def wrapped(*a, _real=getattr(dense_ref, fn), _fn=fn, **k):
            seen["reference"].append(_fn)
            return _real(*a, **k)
        monkeypatch.setattr(dense_ref, fn, wrapped)
    draw, per_layer = weights.draw, cell.per_layer

    def drawn(shapes, *a, **k):
        seen["drawn"].append(list(shapes))
        return draw(shapes, *a, **k)

    def read(bench, name, ctx):
        seen["ctx"] = ctx
        return per_layer(bench, name, ctx)
    monkeypatch.setattr(weights, "draw", drawn)
    monkeypatch.setattr(cell, "per_layer", read)
    return seen


@pytest.mark.parametrize("name", smoke.CELLS)
def test_a_family_in_the_test_tree_runs_a_cell(name, probe):
    config = probe_family.config_of(smoke.config(name))
    assert not set(config) & set(dense.KEYS)
    line = cell.run(name, smoke.SEED, smoke.SECONDS, True, smoke.CPU,
                    t_process=0.0, config=config, mix=smoke.mix(name),
                    lim=smoke.limits(name))
    assert line["correct"] is True, line["checks"]
    serving = name == smoke.SERVE
    metrics = ("mfu.prefill", "mfu.decode") if serving else ("mfu.train",)
    counts = {"prefill_flops", "decode_flops", "decode_bytes"} if serving \
        else {"train_flops"}
    assert {"sizes", "shapes", "program_config"} | counts \
        <= set(probe_family.CALLS)
    # the leaves in the probe's order, the reference that the key names
    m = probe_family.sizes(config)
    assert probe["drawn"] == [list(probe_family.shapes(m))]
    assert list(probe_family.shapes(m)) != list(dense.shapes(m))
    assert probe["reference"] and set(probe["reference"]) == {
        "served_logits" if serving else "grads"}
    # the readers counted with the probe's arithmetic
    ctx = probe["ctx"]
    assert ctx["family"] is probe_family
    for metric in metrics:
        as_dense = cell.reader(metric)(dict(ctx, family=dense))
        assert line["metrics"][metric]["value"] == pytest.approx(
            probe_family.SCALE * as_dense, rel=1e-9)


@pytest.mark.parametrize("key,value", [
    ("family", "nope"), ("reference", "bench/reference/nope.py")])
def test_a_missing_family_or_reference_names_the_file(key, value):
    config = {**smoke.config(smoke.SERVE), key: value}
    path = "bench/families/nope.py" if key == "family" else value
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        cell.run(smoke.SERVE, smoke.SEED, smoke.SECONDS, False, smoke.CPU,
                 t_process=0.0, config=config, mix=smoke.mix(smoke.SERVE),
                 lim=smoke.limits(smoke.SERVE))


# --- a serving mix with no shared prompts --------------------------------

def test_a_mix_without_shared_prompts_runs_with_no_fork(monkeypatch):
    from repro_torch.serving.engine import Engine
    forks = []
    add = Engine.add

    def recorded(self, prompt, max_new=16, fork_from=None):
        forks.append(fork_from)
        return add(self, prompt, max_new, fork_from)
    monkeypatch.setattr(Engine, "add", recorded)
    mix = {**smoke.mix(smoke.SERVE), "prefixes": []}
    line = cell.run(smoke.SERVE, smoke.SEED, smoke.SECONDS, False,
                    smoke.CPU, t_process=0.0, config=smoke.config(smoke.SERVE),
                    mix=mix, lim=smoke.limits(smoke.SERVE))
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert forks and set(forks) == {None}
