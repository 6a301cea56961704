"""A model family that lives in the test tree alone: the harness's contract
(``bench/harness/family.py``) kept by a module that no file of the harness
names.

Its configuration uses keys of its own (``probe_*``); it draws the dense
model's leaves in the reverse order, so that its weights for a seed are
not the dense family's; its counts are the dense family's times
``SCALE``.  Every call is recorded in ``CALLS``, by name, so that a test
can see which of them the harness made.
"""
from bench.families import dense

KEYS = {"probe_width": "d_model", "probe_ffn": "d_ff",
        "probe_depth": "n_layers", "probe_heads": "n_heads",
        "probe_kv_heads": "n_kv_heads", "probe_head_size": "head_dim",
        "probe_vocab": "vocab", "probe_theta": "rope_theta",
        "probe_eps": "norm_eps", "probe_tied": "tie_embeddings"}
SCALE = 1000
CALLS = []


def _called(name):
    CALLS.append(name)


def config_of(dense_config: dict) -> dict:
    """A dense configuration under the probe's keys and family."""
    out = {k: v for k, v in dense_config.items() if k not in dense.KEYS}
    out.update({ours: dense_config[theirs] for theirs, ours in
                zip(dense.KEYS, KEYS)})
    out["family"] = "probe"
    return out


def sizes(config):
    _called("sizes")
    return {theirs: config[ours] for ours, theirs in KEYS.items()}


def shapes(m):
    _called("shapes")
    return dict(reversed(dense.shapes(m).items()))


def program_config(config, m, section, **extra):
    _called("program_config")
    from repro_torch.configs.base import ModelConfig
    s = config[section]
    return ModelConfig(name="probe", arch_kind="dense",
                       param_dtype=s["param_dtype"],
                       compute_dtype=s["compute_dtype"],
                       attn_impl=s["attn_impl"],
                       **{k: s[k] for k in ("remat",) if k in s},
                       **extra, **m)


def _count(name, *a, **k):
    _called(name)
    return SCALE * getattr(dense, name)(*a, **k)


def prefill_flops(*a, **k):
    return _count("prefill_flops", *a, **k)


def decode_flops(*a, **k):
    return _count("decode_flops", *a, **k)


def decode_bytes(*a, **k):
    return _count("decode_bytes", *a, **k)


def train_flops(*a, **k):
    return _count("train_flops", *a, **k)


def attention_layers(m):
    _called("attention_layers")
    return [(SCALE * n, h, hkv, d)
            for n, h, hkv, d in dense.attention_layers(m)]
