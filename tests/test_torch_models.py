"""The port's configs, layers and dense forward against the JAX package,
on the same inputs (numpy, from a seed) and the same params (JAX
`Model.init`, carried across with `repro_torch.weights.from_numpy`)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.weights import from_numpy

ARCHS = ["qwen2-7b", "smollm-360m", "zamba2-1.2b", "command-r-35b",
         "llava-next-34b", "mistral-large-123b", "olmoe-1b-7b",
         "granite-moe-3b-a800m", "xlstm-1.3b", "whisper-medium"]
# the archs whose forward takes tokens alone (whisper's takes frames too:
# tests/test_torch_whisper.py)
TOKEN_ARCHS = [a for a in ARCHS if a != "whisper-medium"]
SRC = Path(__file__).resolve().parents[1] / "src"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_params(cfg, seed=0):
    params = jax_get_model(cfg).init(jax.random.PRNGKey(seed))
    return params, from_numpy(jax.tree.map(np.asarray, params), "cpu")


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = getattr(tconfigs, get)(arch)
        ref = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


def test_unported_archs_raise():
    """Every arch of the JAX package is ported, and this test covers them
    all; an unknown arch or arch_kind still raises KeyError."""
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS) == set(ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_smoke_config("gpt-5")
    with pytest.raises(KeyError, match="unknown arch_kind"):
        get_model(tconfigs.get_smoke_config("xlstm-1.3b").replace(
            arch_kind="rwkv"))


@pytest.mark.parametrize("arch", ARCHS + ["smollm-360m:full"])
def test_param_tree_matches_reference(arch):
    name, _, size = arch.partition(":")
    cfg = (tconfigs.get_config if size else tconfigs.get_smoke_config)(name)
    ours, ref = get_model(cfg), jax_get_model(cfg)
    shapes = jax.tree.map(lambda s: s.shape, ref.abstract_params())
    flat_ref = {jax.tree_util.keystr(k): tuple(v) for k, v in
                jax.tree_util.tree_flatten_with_path(
                    shapes, is_leaf=lambda x: isinstance(x, tuple))[0]}

    def flat(node, prefix=""):
        if hasattr(node, "shape"):
            return {prefix: tuple(node.shape)}
        out = {}
        for k, v in node.items():
            out.update(flat(v, f"{prefix}['{k}']"))
        return out

    assert flat(ours.schema()) == flat_ref
    assert ours.param_count() == ref.param_count()


def test_init_is_seeded_and_on_the_asked_device():
    model = get_model(tconfigs.get_smoke_config("qwen2-7b"))
    a = model.init(3, device="cpu")
    b = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert a["layers"]["wq"].device.type == "cpu"
    assert a["layers"]["wq"].shape == (2, 128, 128)
    torch.testing.assert_close(a["layers"]["wq"], b["layers"]["wq"],
                               rtol=0, atol=0)
    assert (a["layers"]["wq_b"] == 0).all() and (a["ln_f"] == 1).all()
    assert abs(float(a["embedding"].std()) - 0.02) < 2e-3


def test_from_numpy_takes_bf16_and_read_only_arrays():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    ro = x.copy()
    ro.setflags(write=False)
    bf = jnp.asarray(x + 0.5).astype(jnp.bfloat16)
    out = from_numpy({"a": ro, "b": {"c": np.asarray(bf)}}, "cpu")
    assert out["a"].dtype == torch.float32 and out["a"][2, 3] == 11
    assert out["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["b"]["c"].float().numpy(),
                                  np.asarray(bf, np.float32))
    out["a"][0, 0] = -1                    # a private, writable copy
    assert ro[0, 0] == 0
    assert from_numpy({"a": ro}, "cpu", torch.bfloat16)["a"].dtype \
        == torch.bfloat16


# ------------------------------------------------------------------ layers
def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 64), _rand(rng, 64)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        atol=1e-6, rtol=1e-6)
    h = _rand(rng, 2, 7, 3, 32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 500, 501, 502]])
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _np(TL.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                              theta)),
            _np(JL.apply_rope(jnp.asarray(h), jnp.asarray(pos), theta)),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
def test_attention_matches_reference(window, impl):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, 16, 6, 32), _rand(rng, 2, 16, 2, 32), \
        _rand(rng, 2, 16, 2, 32)
    ours = TL.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                        sliding_window=window, impl=impl)
    # the JAX pallas path drops the window: hold every port path to the
    # reference's einsum path, which keeps it
    ref = JL.attention(*map(jnp.asarray, (q, k, v)), causal=True,
                       sliding_window=window, impl="xla")
    np.testing.assert_allclose(_np(ours), _np(ref), atol=2e-5, rtol=2e-5)


def test_swiglu_embed_unembed():
    cfg = tconfigs.get_smoke_config("qwen2-7b").replace(
        compute_dtype="float32")
    jparams, tparams = _jax_params(cfg)
    lp = {k: v[0] for k, v in jparams["layers"].items()}
    tp = {k: v[0] for k, v in tparams["layers"].items()}
    x = _rand(np.random.default_rng(2), 2, 5, cfg.d_model)
    np.testing.assert_allclose(
        _np(TL.swiglu(tp, torch.from_numpy(x), cfg)),
        _np(JL.swiglu(lp, jnp.asarray(x), cfg)), atol=1e-5, rtol=1e-5)
    tokens = np.array([[1, 5, 511], [0, 3, 7]])
    np.testing.assert_array_equal(
        _np(TL.embed(tparams, torch.from_numpy(tokens), cfg)),
        _np(JL.embed(jparams, jnp.asarray(tokens), cfg)))
    np.testing.assert_allclose(
        _np(TL.unembed(tparams, torch.from_numpy(x), cfg)),
        _np(JL.unembed(jparams, jnp.asarray(x), cfg)), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", TOKEN_ARCHS)   # qkv bias / tied embeddings
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
def test_forward_matches_reference(arch, impl):
    cfg = tconfigs.get_smoke_config(arch).replace(compute_dtype="float32")
    jparams, tparams = _jax_params(cfg, seed=3)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    ref = jax_get_model(cfg).forward(jparams,
                                     {"tokens": jnp.asarray(tokens)})
    ours = get_model(cfg.replace(attn_impl=impl)).forward(
        tparams, {"tokens": torch.from_numpy(tokens)})
    assert ours.shape == ref.shape
    np.testing.assert_allclose(_np(ours), _np(ref), atol=2e-3, rtol=2e-3)


def test_forward_refuses_parallel_blocks():
    """Parallel blocks are ported: command-r's forward (one shared norm,
    x + attn + mlp) matches the JAX package's, and so does a parallel
    block on qwen2's shape (QKV bias, untied embeddings)."""
    for cfg in (tconfigs.get_smoke_config("command-r-35b"),
                tconfigs.get_smoke_config("qwen2-7b").replace(
                    parallel_block=True)):
        cfg = cfg.replace(compute_dtype="float32")
        assert "ln2" not in get_model(cfg).schema()["layers"]
        jparams, tparams = _jax_params(cfg, seed=3)
        tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
        ref = jax_get_model(cfg).forward(jparams,
                                         {"tokens": jnp.asarray(tokens)})
        ours = get_model(cfg).forward(tparams,
                                      {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(_np(ours), _np(ref), atol=2e-3,
                                   rtol=2e-3)


# ----------------------------------------------------------------- hygiene
def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serving.engine' in sys.modules\n"
        "assert 'repro_torch.launch.serve' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.serving import Engine
    model = get_model(tconfigs.get_smoke_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy({"a": np.zeros(2)}, "cuda")
