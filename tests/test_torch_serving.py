"""The port's paged serving engine on the CPU against the JAX engine, on
the four scenarios of tests/test_serving_engine.py (single, batched,
page-aligned fork, mid-page copy-on-write), in fp32 with the same params:
the tokens and the page statistics must be equal."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model as jax_get_model
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.kv_cache import CacheConfig, PagedKVCache
from repro_torch.weights import from_numpy


def _single(eng):
    sid = eng.add(np.array([5, 9, 2, 7, 11, 3], np.int32), max_new=6)
    while not eng._requests[sid].done:
        eng.step()
    return [sid]


def _batched(eng):
    sids = [eng.add(np.array(p, np.int32), max_new=4)
            for p in ([1, 2, 3], [10, 20, 30, 40, 50], [7, 7, 7, 7])]
    for _ in range(8):
        eng.step()
    return sids


def _fork_aligned(eng):
    base = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)   # 2 full pages
    a = eng.add(base, max_new=4)
    b = eng.add(np.concatenate([base, [8, 8]]).astype(np.int32), max_new=4,
                fork_from=a)
    while not (eng._requests[a].done and eng._requests[b].done):
        eng.step()
    return [a, b]


def _fork_mid_page(eng):
    base = np.array([3, 1, 4, 1, 5, 9], np.int32)          # 1.5 pages
    a = eng.add(base, max_new=3)
    b = eng.add(np.concatenate([base, [2, 2]]).astype(np.int32), max_new=3,
                fork_from=a)
    while not (eng._requests[a].done and eng._requests[b].done):
        eng.step()
    return [a, b]


SCENARIOS = {"single": (_single, 128), "batched": (_batched, 256),
             "fork_aligned": (_fork_aligned, 256),
             "fork_mid_page": (_fork_mid_page, 256)}


def _outcome(eng, run):
    sids = run(eng)
    return [eng.result(s) for s in sids], dict(eng.cache.stats)


@pytest.fixture(scope="module")
def reference():
    """JAX params and the JAX engine's outcome of every scenario, once."""
    cfg = get_smoke_config("smollm-360m").replace(compute_dtype="float32")
    model = jax_get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    outcomes = {
        name: _outcome(JaxEngine(model, params, JaxEngineConfig(
            page_tokens=4, num_pages=pages)), run)
        for name, (run, pages) in SCENARIOS.items()}
    return cfg, jax.tree.map(np.asarray, params), outcomes


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_jax_engine(reference, scenario, impl):
    cfg, np_params, outcomes = reference
    run, pages = SCENARIOS[scenario]
    model = get_model(tconfigs.get_smoke_config("smollm-360m").replace(
        compute_dtype="float32", attn_impl=impl))
    eng = Engine(model, from_numpy(np_params, "cpu"),
                 EngineConfig(page_tokens=4, num_pages=pages, device="cpu"))
    tokens, stats = _outcome(eng, run)
    ref_tokens, ref_stats = outcomes[scenario]
    assert tokens == ref_tokens
    assert stats == ref_stats
    if scenario == "fork_aligned":
        assert stats["pages_shared"] >= 2 and stats["pages_copied"] == 0
    if scenario == "fork_mid_page":
        assert stats["pages_copied"] >= 1


def test_engine_writes_pools_in_place():
    """Pages and COW copies land in the pools the engine allocated: no
    write rebuilds a pool."""
    model = get_model(tconfigs.get_smoke_config("qwen2-7b").replace(
        compute_dtype="float32"))
    eng = Engine(model, model.init(0, device="cpu"),
                 EngineConfig(page_tokens=4, num_pages=64, device="cpu"))
    kp, vp = eng.k_pool.data_ptr(), eng.v_pool.data_ptr()
    a = eng.add(np.array([3, 1, 4, 1, 5, 9], np.int32), max_new=3)
    b = eng.add(np.array([3, 1, 4, 1, 5, 9, 2], np.int32), max_new=3,
                fork_from=a)
    eng.step()
    assert (eng.k_pool.data_ptr(), eng.v_pool.data_ptr()) == (kp, vp)
    assert eng.cache.stats["pages_copied"] == 1
    ta, tb = eng.cache.page_table[a], eng.cache.page_table[b]
    assert ta[0] == tb[0] and ta[1] != tb[1]
    # the copied page holds the parent's first two open-page tokens
    torch.testing.assert_close(eng.k_pool[:, tb[1], :2],
                               eng.k_pool[:, ta[1], :2], rtol=0, atol=0)


def test_engine_refuses_parallel_blocks_and_other_families():
    """Only families outside the dense one are refused now: parallel
    blocks are served (test_engine_serves_parallel_blocks)."""
    cfg = tconfigs.get_smoke_config("qwen2-7b")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    other = get_model(cfg)
    object.__setattr__(other, "cfg", cfg.replace(arch_kind="moe"))
    with pytest.raises(ValueError, match="dense family"):
        Engine(other, params, EngineConfig(device="cpu"))


def test_engine_serves_parallel_blocks():
    """command-r's parallel block runs through the paged engine: prefill,
    a mid-page fork and decode give in-vocab tokens, and the first token
    of each request is the kernel-free forward's greedy token."""
    cfg = tconfigs.get_smoke_config("command-r-35b").replace(
        compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    eng = Engine(model, params, EngineConfig(page_tokens=4, num_pages=64,
                                             device="cpu"))
    prompts = [np.array([3, 1, 4, 1, 5, 9], np.int32),
               np.array([3, 1, 4, 1, 5, 9, 2], np.int32)]
    a = eng.add(prompts[0], max_new=3)
    b = eng.add(prompts[1], max_new=3, fork_from=a)
    while not (eng._requests[a].done and eng._requests[b].done):
        eng.step()
    for sid, prompt in zip((a, b), prompts):
        out = eng.result(sid)
        assert len(out) == 3 and all(0 <= t < cfg.vocab for t in out)
        logits = model.forward(params, {"tokens": torch.from_numpy(
            prompt.astype(np.int64))[None]})
        assert out[0] == int(logits[0, -1].argmax())
    assert eng.cache.stats["pages_copied"] == 1


def test_kv_cache_copy_matches_reference():
    """The port's copy of the numpy cache manager behaves as the JAX
    package's: append, fork, copy-on-write, gather, release."""
    from repro.serving.kv_cache import CacheConfig as JCacheConfig
    from repro.serving.kv_cache import PagedKVCache as JPagedKVCache
    rng = np.random.default_rng(5)
    caches = [cls(cc(num_layers=2, num_kv_heads=2, head_dim=8,
                     page_tokens=4, num_pages=16))
              for cls, cc in ((PagedKVCache, CacheConfig),
                              (JPagedKVCache, JCacheConfig))]
    for c in caches:
        c.create(0)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    for c in caches:
        c.append(0, k, -k)
        c.fork(0, 1)
        c.append(1, k[:, :3], k[:, :3])
        c.append(0, k[:, :1], k[:, :1])
    ours, ref = caches
    assert ours.stats == ref.stats and ours.page_table == ref.page_table
    for sid in (0, 1):
        for a, b in zip(ours.gather(sid, 1), ref.gather(sid, 1)):
            np.testing.assert_array_equal(a, b)
    for c in caches:
        c.release(1)
    assert ours.free_pages() == ref.free_pages()
    np.testing.assert_array_equal(ours.table_array([0])[0],
                                  ref.table_array([0])[0])


def test_serve_launcher_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "5",
                "--max-new", "3", "--arch", "smollm-360m"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "on cpu" in out


def test_serve_launcher_refuses_other_families():
    """As the JAX launcher does: the paged engine serves the dense family."""
    with pytest.raises(SystemExit, match="paged engine serves the dense "
                                         "family"):
        serve.main(["--device", "cpu", "--arch", "zamba2-1.2b"])
