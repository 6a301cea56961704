"""The port's trainer on the WTF substrate, on the CPU: the JAX package's
trainer scenarios (loss improves with retention, restart resumes with a
consistent cursor, elastic rescale), the asynchronous save's host copy,
checkpoints restored across the two packages in both directions, and the
port's copies of the framework-free modules held against their originals
line by line."""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core import Cluster as JaxCluster
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.data.records import write_token_shard as jax_write_token_shard
from repro.models import get_model as jax_get_model
from repro.train import AdamWConfig as JaxAdamW
from repro.train import TrainHyper as JaxHyper
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serialize import flatten_tree
from repro_torch.configs import get_smoke_config
from repro_torch.core import Cluster
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.data.records import write_token_shard
from repro_torch.models import get_model
from repro_torch.train import AdamWConfig, TrainHyper
from repro_torch.train.trainer import Trainer, TrainerConfig, host_copy

SEQ, BATCH = 32, 4
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture()
def cluster(tmp_path):
    c = Cluster(n_servers=2, data_dir=str(tmp_path), replication=1)
    yield c
    c.close()


def _corpus(vocab):
    toks = np.zeros(BATCH * (SEQ + 1) * 32, np.int32)
    for i in range(1, len(toks)):
        toks[i] = (toks[i - 1] * 31 + 7) % vocab
    return toks


def _setup(cluster, steps, ckpt_every=10, *, cfg=None, prefetch=0,
           log_every=5):
    """The JAX package's `tests/test_trainer.py` set-up, on the port."""
    fs = cluster.client()
    cfg = cfg or get_smoke_config("smollm-360m").replace(max_seq=SEQ)
    if not fs.exists("/corpus"):
        fs.mkdir("/corpus")
        write_token_shard(fs, "/corpus/s0", iter(_corpus(cfg.vocab)),
                          SEQ + 1)
    pipe = DataPipeline(fs, PipelineConfig(
        src_paths=("/corpus/s0",), work_dir="/epochs",
        block_tokens=SEQ + 1, global_batch=BATCH, seed=0,
        prefetch=prefetch))
    ckpt = CheckpointManager(fs, "/ckpt", keep=2)
    return Trainer(get_model(cfg), pipe, ckpt,
                   hyper=TrainHyper(adamw=AdamWConfig(lr=1e-3,
                                                      warmup_steps=5,
                                                      decay_steps=steps)),
                   cfg=TrainerConfig(total_steps=steps,
                                     ckpt_every=ckpt_every,
                                     log_every=log_every),
                   device="cpu"), ckpt


# ------------------------------------------------ the reference's scenarios
def test_loss_improves_and_checkpoints(cluster):
    trainer, ckpt = _setup(cluster, steps=30)
    out = trainer.run()
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert ckpt.latest_step() == 30
    assert len(ckpt.list_steps()) <= 2          # retention


def test_restart_resumes_with_consistent_cursor(cluster):
    trainer, ckpt = _setup(cluster, steps=20)
    trainer.run()
    man = ckpt.read_manifest()
    assert man["step"] == 20
    cursor_at_20 = man["pipeline"]

    # "crash" after step 20; a fresh trainer continues to 40
    trainer2, ckpt2 = _setup(cluster, steps=40)
    state, pstate = trainer2.restore_or_init()
    assert int(state["step"]) == 20
    assert pstate.to_dict() == cursor_at_20
    trainer2.run()
    assert ckpt2.latest_step() == 40


def test_elastic_rescale_same_stream(cluster):
    trainer, _ = _setup(cluster, steps=10)
    t2 = trainer.with_hosts(host_id=1, num_hosts=2)
    # host 1 of 2 sees the second half of each global batch
    trainer.pipeline.state = t2.pipeline.state
    b_full = next(iter(trainer.pipeline))
    b_half = next(iter(t2.pipeline))
    np.testing.assert_array_equal(b_full["tokens"][BATCH // 2:],
                                  b_half["tokens"])
    assert t2.device == trainer.device


def test_cursor_is_the_consumed_batch_with_prefetch(cluster):
    """A prefetching pipeline's ``state`` runs ahead of the batches it has
    handed out; the saved cursor is the one after the last batch a step
    consumed."""
    trainer, ckpt = _setup(cluster, steps=10, ckpt_every=10, prefetch=2)
    trainer.run()
    assert ckpt.read_manifest()["pipeline"] == {"epoch": 0,
                                                "step_in_epoch": 10}


def test_pod_sync_hook_replaces_the_params(cluster):
    """Every ``pod_sync_every`` steps the hook takes the params and the
    trainer carries on with what it returns."""
    trainer, _ = _setup(cluster, steps=4, ckpt_every=100)
    returned = []

    def pod_sync(params):
        # the params of the steps since the last call are the tree the
        # last call returned
        assert not returned or params is returned[-1]
        returned.append(dict(params))
        return returned[-1]

    trainer.pod_sync = pod_sync
    trainer.cfg.pod_sync_every = 2
    assert trainer.run()["final_step"] == 4
    assert len(returned) == 2


def test_trainer_needs_a_card_unless_asked_for_the_cpu(cluster):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    trainer, ckpt = _setup(cluster, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(trainer.model, trainer.pipeline, ckpt)


# -------------------------------------------------------- the async save
def _state_arrays(state) -> dict:
    return {k: v.detach().clone() for k, v in flatten_tree(state).items()}


def test_host_copy_shares_no_memory_with_the_live_state(cluster):
    trainer, _ = _setup(cluster, steps=1)
    state, _ = trainer.restore_or_init()
    host = host_copy(state)
    live = flatten_tree(state)
    for name, arr in flatten_tree(host).items():
        assert isinstance(arr, np.ndarray)
        assert not np.shares_memory(arr, live[name].numpy()), name


def test_async_save_keeps_the_saved_state(cluster):
    """Save, take another step (which updates the params and moments in
    place), then restore: the checkpoint holds the state as saved."""
    trainer, _ = _setup(cluster, steps=5)
    state, pstate = trainer.restore_or_init()
    batches = iter(trainer.pipeline)
    state, _ = trainer.train_step(state, trainer._batch(next(batches)))
    saved = _state_arrays(state)
    trainer._save(state, pstate, 1)
    state, _ = trainer.train_step(state, trainer._batch(next(batches)))
    trainer.async_ckpt.wait()
    restored, _ = trainer.restore_or_init()
    restored, now = flatten_tree(restored), flatten_tree(state)
    assert restored.keys() == saved.keys()
    for name, t in saved.items():
        assert restored[name].dtype == t.dtype
        assert torch.equal(restored[name], t), name
    assert not torch.equal(restored["params/embedding"],
                           now["params/embedding"])


# ------------------------------------------- checkpoints across packages
def _fp32_cfg():
    return get_smoke_config("smollm-360m").replace(max_seq=SEQ,
                                                    compute_dtype="float32")


def _jax_trainer(cluster, steps, ckpt_every):
    fs = cluster.client()
    cfg = _fp32_cfg()
    if not fs.exists("/corpus"):
        fs.mkdir("/corpus")
        jax_write_token_shard(fs, "/corpus/s0", iter(_corpus(cfg.vocab)),
                              SEQ + 1)
    pipe = JaxPipeline(fs, JaxPipelineConfig(
        src_paths=("/corpus/s0",), work_dir="/epochs",
        block_tokens=SEQ + 1, global_batch=BATCH, seed=0, prefetch=0))
    ckpt = JaxCheckpointManager(fs, "/ckpt", keep=2)
    return JaxTrainer(jax_get_model(cfg), pipe, ckpt,
                      hyper=JaxHyper(adamw=JaxAdamW(lr=1e-3,
                                                    warmup_steps=5,
                                                    decay_steps=20)),
                      cfg=JaxTrainerConfig(total_steps=steps,
                                           ckpt_every=ckpt_every,
                                           log_every=1)), ckpt


def _copy_checkpoint(src_fs, dst_fs, step):
    """Copy checkpoint ``step`` (its files and the ``latest`` manifest)
    byte for byte from one cluster's /ckpt to another's."""
    src = f"/ckpt/step-{step:010d}"
    dst_fs.mkdir(src)
    for name in src_fs.listdir(src):
        with src_fs.open_file(f"{src}/{name}", "r") as f:
            data = f.read()
        with dst_fs.open_file(f"{src}/{name}", "w") as f:
            f.write(data)
    with src_fs.open_file(f"{src}/manifest", "r") as f, \
            dst_fs.open_file("/ckpt/latest", "w") as g:
        g.write(f.read())


def _losses(history, first, last):
    return {int(h["step"]): h["loss"] for h in history
            if first <= h["step"] <= last}


# fp32 on both sides: the losses of ten more AdamW steps agree to 1e-5
CROSS_TOL = 1e-5


@pytest.fixture()
def jax_cluster(tmp_path):
    c = JaxCluster(n_servers=2, data_dir=str(tmp_path / "jax"),
                   replication=1)
    yield c
    c.close()


def test_port_restores_a_jax_checkpoint(cluster, jax_cluster):
    """The JAX trainer checkpoints at step 10 and runs on to 20; the
    port's trainer restores step 10 bit for bit, cursor included, and
    its losses over steps 11-20 match JAX's."""
    jtrainer, jckpt = _jax_trainer(jax_cluster, 20, 10)
    jout = jtrainer.run()
    jstate = flatten_tree(jckpt.restore(
        jtrainer.restore_or_init()[0], 10))
    cluster.client().mkdir("/ckpt")
    _copy_checkpoint(jax_cluster.client(), cluster.client(), 10)

    trainer, ckpt = _setup(cluster, steps=20, ckpt_every=100,
                           cfg=_fp32_cfg(), log_every=1)
    state, pstate = trainer.restore_or_init()
    for name, t in flatten_tree(state).items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jstate[name]),
                                      err_msg=name)
        assert t.numpy().dtype == np.asarray(jstate[name]).dtype
    assert pstate.to_dict() == jckpt.read_manifest(10)["pipeline"]
    out = trainer.run()
    ours, ref = _losses(out["history"], 11, 20), _losses(jout["history"],
                                                          11, 20)
    assert list(ours) == list(range(11, 21)) and ours.keys() == ref.keys()
    np.testing.assert_allclose(list(ours.values()), list(ref.values()),
                               rtol=CROSS_TOL)


def test_jax_restores_a_port_checkpoint(cluster, jax_cluster):
    """The port's trainer checkpoints at step 10 and runs on to 20 after a
    restart; the JAX trainer restores the port's step 10 bit for bit and
    its losses over steps 11-20 match the port's."""
    trainer, ckpt = _setup(cluster, steps=10, ckpt_every=10,
                           cfg=_fp32_cfg(), log_every=1)
    trainer.run()
    saved = flatten_tree(trainer.restore_or_init()[0])
    trainer2, _ = _setup(cluster, steps=20, ckpt_every=100,
                         cfg=_fp32_cfg(), log_every=1)
    out = trainer2.run()

    jfs = jax_cluster.client()
    jfs.mkdir("/ckpt")
    _copy_checkpoint(cluster.client(), jfs, 10)
    jtrainer, jckpt = _jax_trainer(jax_cluster, 20, 100)
    jstate, jpstate = jtrainer.restore_or_init()
    for name, arr in flatten_tree(jax.tree.map(np.asarray, jstate)).items():
        np.testing.assert_array_equal(arr, saved[name].numpy(),
                                      err_msg=name)
    assert jpstate.to_dict() == ckpt.read_manifest(10)["pipeline"]
    jout = jtrainer.run()
    ours, ref = _losses(out["history"], 11, 20), _losses(jout["history"],
                                                          11, 20)
    assert list(ref) == list(range(11, 21)) and ours.keys() == ref.keys()
    np.testing.assert_allclose(list(ref.values()), list(ours.values()),
                               rtol=CROSS_TOL)


# -------------------------------------------- the copied modules, verbatim
COPIED = ("util", "analysis", "core", "data", "checkpoint")
PORT_COPIES = sorted(
    str(p.relative_to(SRC / "repro_torch"))
    for d in COPIED for p in (SRC / "repro_torch" / d).glob("*.py")
    if p.name != "__init__.py" or d != "analysis")


def _rewritten(text: str) -> str:
    """The JAX package's module with the port's import paths."""
    text = re.sub(r"^(\s*)from repro\.", r"\1from repro_torch.", text,
                  flags=re.M)
    return text.replace('f"repro.analysis.lockspec.LOCK_LEVELS"',
                        'f"repro_torch.analysis.lockspec.LOCK_LEVELS"')


@pytest.mark.parametrize("rel", PORT_COPIES)
def test_copy_equals_its_original(rel):
    ours = (SRC / "repro_torch" / rel).read_text()
    assert ours == _rewritten((SRC / "repro" / rel).read_text())


def test_every_original_is_copied():
    want = {str(p.relative_to(SRC / "repro"))
            for d in ("util", "core", "data", "checkpoint")
            for p in (SRC / "repro" / d).glob("*.py")}
    want.add("analysis/lockspec.py")
    assert set(PORT_COPIES) == want
    # the analyzer is not copied: the port's package holds the lock order
    assert sorted(p.name for p in (SRC / "repro_torch" / "analysis")
                  .glob("*.py")) == ["__init__.py", "lockspec.py"]
