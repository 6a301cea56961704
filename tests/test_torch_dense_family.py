"""The rest of the port's dense family on the CPU: command-r's parallel
blocks, the llava backbone (patch embeddings) and mistral-large, against
the JAX package on the same inputs (numpy, from a seed) and the same
params (JAX `Model.init`, carried across with
`repro_torch.weights.from_numpy`), fp32 compute.  command-r's train step
is held against JAX in tests/test_torch_train.py.

The paged engine is held two ways.  The JAX engine ignores
`parallel_block` (it runs command-r as a sequential block), so for
command-r, and for qwen2, the port's engine is held against the port's
own `make_serve_step` on the four scenarios of
tests/test_serving_engine.py; mistral-large and llava text prompts are
held against the JAX engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as jax_get_model
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig
from repro_torch.train import make_serve_step
from repro_torch.weights import from_numpy
from test_torch_serving import SCENARIOS
from test_torch_train import _close_trees, _flat, _np

B, S = 2, 16
TOL = 2e-3                       # the reference's decode/forward tolerance


def _cfg(arch, **kw):
    return tconfigs.get_smoke_config(arch).replace(compute_dtype="float32",
                                                   **kw)


def _params(cfg, seed=0):
    jparams = jax_get_model(cfg).init(jax.random.PRNGKey(seed))
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
@pytest.mark.parametrize("patches", [True, False])
def test_llava_forward_matches_jax(patches, impl):
    """Projected patch embeddings prepended, positions renumbered over
    patches and text, the patches' logits stripped; without patches the
    backbone is a dense model."""
    cfg = _cfg("llava-next-34b")
    jparams, tparams = _params(cfg, seed=3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    batch = {"tokens": tokens}
    if patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.vlm.num_patches, cfg.vlm.vision_dim)).astype(np.float32)
    ref = jax_get_model(cfg).forward(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    ours = get_model(cfg.replace(attn_impl=impl)).forward(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ours.shape == ref.shape == (B, S, 512)
    np.testing.assert_allclose(_np(ours), _np(ref), atol=TOL, rtol=TOL)


def test_parallel_block_schema_and_branches():
    """command-r: one shared norm (no ln2), and the block is x + attn(y) +
    mlp(y) from the same y; the same weights as a sequential block give
    other logits."""
    cfg = _cfg("command-r-35b")
    assert cfg.parallel_block
    model = get_model(cfg)
    assert "ln2" not in model.schema()["layers"]
    params = model.init(0, device="cpu")
    seq = get_model(cfg.replace(parallel_block=False))
    seq_params = {**params, "layers": {**params["layers"],
                                       "ln2": params["layers"]["ln"]}}
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    par = model.forward(params, {"tokens": tokens})
    assert (par - seq.forward(seq_params, {"tokens": tokens})).abs().max() \
        > 10 * TOL


# ------------------------------------------------------------------ decode
def _decode(model, params, tokens):
    cache = model.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tokens[:, t:t + 1],
                            "pos": torch.full((B,), t, dtype=torch.int32)})
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1), cache


@pytest.mark.parametrize("arch", ["command-r-35b", "mistral-large-123b",
                                  "llava-next-34b"])
def test_decode_matches_forward(arch):
    cfg = _cfg(arch, max_seq=S)
    model = get_model(cfg)
    params = model.init(3, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (B, S)))
    full = model.forward(params, {"tokens": tokens})
    np.testing.assert_allclose(_np(_decode(model, params, tokens)[0]),
                               _np(full), atol=TOL, rtol=TOL)


def test_command_r_decode_matches_jax():
    """The port's parallel-block decode against JAX's `decode_step`,
    logits at every step and the ring caches after the last."""
    cfg = _cfg("command-r-35b", max_seq=S)
    jparams, tparams = _params(cfg, seed=5)
    jm = jax_get_model(cfg)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (B, S))
    jcache = jm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    ref = []
    for t in range(S):
        jl, jcache = step(jparams, jcache,
                          {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                           "pos": jnp.full((B,), t, jnp.int32)})
        ref.append(np.asarray(jl[:, 0]))
    ours, cache = _decode(get_model(cfg), tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(ours), np.stack(ref, axis=1), atol=TOL,
                               rtol=TOL)
    _close_trees(cache, jax.tree.map(np.asarray, jcache), 1e-4)


# ------------------------------------------------------------------ engine
def _reference_generate(model, params, prompt, max_new):
    """Greedy tokens from the port's ring-cache decode (`make_serve_step`),
    token by token, as tests/test_serving_engine.py builds its reference."""
    cache = model.init_cache(1, len(prompt) + max_new, device="cpu")
    serve_step = make_serve_step(model)
    out = []
    with torch.no_grad():
        for t in range(len(prompt) + max_new - 1):
            cur = prompt[t] if t < len(prompt) else out[-1]
            tok, cache = serve_step(params, cache, {
                "tokens": torch.tensor([[cur]]),
                "pos": torch.tensor([t], dtype=torch.int32)})
            if t >= len(prompt) - 1:
                out.append(int(tok[0]))
    return out[:max_new]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("arch", ["command-r-35b", "qwen2-7b"])
def test_engine_matches_serve_step(arch, scenario, impl):
    """The engine's greedy tokens (flash prefill, paged decode: their
    plain versions here) equal the ring-cache decode's, request by
    request, with the page statistics of each scenario."""
    cfg = _cfg(arch, attn_impl=impl)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    run, pages = SCENARIOS[scenario]
    eng = Engine(model, params, EngineConfig(page_tokens=4, num_pages=pages,
                                             device="cpu"))
    for sid in run(eng):
        req = eng._requests[sid]
        assert eng.result(sid) == _reference_generate(
            model, params, list(req.prompt), req.max_new), sid
    if scenario == "fork_aligned":
        assert eng.cache.stats["pages_shared"] >= 2
        assert eng.cache.stats["pages_copied"] == 0
    if scenario == "fork_mid_page":
        assert eng.cache.stats["pages_copied"] >= 1


@pytest.fixture(scope="module")
def jax_engine_outcomes():
    """The JAX engine's tokens and page statistics, once per (arch,
    scenario)."""
    cache = {}

    def get(arch, scenario):
        if (arch, scenario) not in cache:
            cfg = _cfg(arch)
            model = jax_get_model(cfg)
            params = model.init(jax.random.PRNGKey(0))
            run, pages = SCENARIOS[scenario]
            eng = JaxEngine(model, params, JaxEngineConfig(
                page_tokens=4, num_pages=pages))
            sids = run(eng)
            cache[arch, scenario] = (
                jax.tree.map(np.asarray, params),
                [eng.result(s) for s in sids], dict(eng.cache.stats))
        return cache[arch, scenario]

    return get


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("arch", ["mistral-large-123b", "llava-next-34b"])
def test_engine_matches_jax_engine(jax_engine_outcomes, arch, scenario):
    np_params, ref_tokens, ref_stats = jax_engine_outcomes(arch, scenario)
    model = get_model(_cfg(arch, attn_impl="pallas"))
    run, pages = SCENARIOS[scenario]
    eng = Engine(model, from_numpy(np_params, "cpu"), EngineConfig(
        page_tokens=4, num_pages=pages, device="cpu"))
    sids = run(eng)
    assert [eng.result(s) for s in sids] == ref_tokens
    assert dict(eng.cache.stats) == ref_stats


def test_jax_engine_runs_command_r_as_a_sequential_block(
        jax_engine_outcomes):
    """The reference's quirk, pinned: the JAX engine's command-r tokens are
    those of the port's engine on the sequential block with ln2 = ln, not
    those of the parallel block the model defines."""
    np_params, ref_tokens, _ = jax_engine_outcomes("command-r-35b",
                                                   "batched")
    cfg = _cfg("command-r-35b")
    params = from_numpy(np_params, "cpu")
    seq_params = {**params, "layers": {**params["layers"],
                                       "ln2": params["layers"]["ln"]}}
    outcomes = {}
    for name, c, p in (("sequential", cfg.replace(parallel_block=False),
                        seq_params), ("parallel", cfg, params)):
        eng = Engine(get_model(c), p, EngineConfig(
            page_tokens=4, num_pages=256, device="cpu"))
        outcomes[name] = [eng.result(s) for s in SCENARIOS["batched"][0](eng)]
    assert outcomes["sequential"] == ref_tokens
    assert outcomes["parallel"] != ref_tokens


# ----------------------------------------------------------------- weights
@pytest.mark.parametrize("arch,leaf,shape", [
    ("llava-next-34b", "vision_proj", (32, 128)),
    ("olmoe-1b-7b", "layers/w_gate", (2, 8, 64, 128)),
    ("granite-moe-3b-a800m:padded", "layers/w_down", (2, 12, 64, 64)),
])
def test_from_numpy_carries_the_new_leaves(arch, leaf, shape):
    """Patch projection, expert leaves and granite's padded experts come
    across from JAX `Model.init` with their shapes and values, in the
    port's own schema."""
    name, _, padded = arch.partition(":")
    cfg = tconfigs.get_smoke_config(name)
    if padded:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  padded_experts=12))
    jparams, tparams = _params(cfg, seed=7)
    ours, ref = _flat(tparams), _flat(jax.tree.map(np.asarray, jparams))
    schema = _flat(get_model(cfg).schema())
    assert ours.keys() == ref.keys() == schema.keys()
    assert tuple(ours[leaf].shape) == shape == schema[leaf].shape
    np.testing.assert_array_equal(_np(ours[leaf]), _np(ref[leaf]))


# -------------------------------------------------------------- launchers
@pytest.mark.parametrize("arch", ["command-r-35b", "llava-next-34b",
                                  "mistral-large-123b"])
def test_serve_launcher_runs_the_dense_family(arch, capsys):
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "5",
                "--max-new", "3", "--arch", arch])
    assert "2 requests, 6 tokens" in capsys.readouterr().out


def test_serve_example_runs_on_the_cpu(capsys):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" \
        / "torch_serve_lm.py"
    spec = importlib.util.spec_from_file_location("torch_serve_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    results = mod.main(["--arch", "command-r-35b", "--device", "cpu"])
    assert len(results) == 8 and all(len(r) == 8 for r in results.values())
    out = capsys.readouterr().out
    assert "command-r-35b: 8 requests" in out and "shared=" in out
