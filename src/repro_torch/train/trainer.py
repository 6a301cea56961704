"""Host-level training loop: WTF data pipeline + transactional
checkpoint/restart + elastic hooks (the port of the JAX package's
``train/trainer.py``).

Fault-tolerance contract, as in the JAX package:
  * The checkpoint manifest atomically carries BOTH the model/optimizer
    state and the data-pipeline cursor — a restarted job can never replay
    or skip data relative to the weights (WTF multi-file transaction).
  * Saves are asynchronous (AsyncCheckpointer) — data writes off the
    critical path, metadata commit at a step barrier.
  * `restore_or_init` makes restart the SAME code path as cold start.
  * Elastic re-scale: `Trainer.with_hosts(n)` re-derives the pipeline for
    a new host count at the same global step.

The checkpoint holds the state as the JAX trainer writes it (fp32 params
and moments, int32 count and step, paths ``params/...``, ``opt/0|1|2``,
``step``), so either trainer restores the other's checkpoints.  The
cursor saved with a step is the one just after the batch that step
consumed, read from the batch itself: with a prefetching pipeline its
``state`` runs ahead of the batches handed out.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..checkpoint import AsyncCheckpointer, CheckpointManager
from ..data.pipeline import DataPipeline, PipelineState
from ..models.common import resolve_device, tree_map
from ..weights import from_numpy
from . import optimizer as opt
from .step import TrainHyper, init_state, make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    pod_sync_every: int = 0        # >0: local-steps mode w/ pod averaging


def host_copy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The state as numpy arrays that no later step can change: on the CPU
    ``t.cpu()`` is ``t`` itself and ``.numpy()`` would alias the live
    tensor, which the optimizer updates in place."""
    def arr(t):
        return t.detach().to("cpu", copy=True).numpy()
    o = state["opt"]
    return {"params": tree_map(arr, state["params"]),
            "opt": opt.OptState(tree_map(arr, o.m), tree_map(arr, o.v),
                                arr(o.count)),
            "step": arr(state["step"])}


class Trainer:
    def __init__(self, model, pipeline: DataPipeline,
                 ckpt: CheckpointManager, hyper: TrainHyper = TrainHyper(),
                 cfg: TrainerConfig = TrainerConfig(),
                 rules=None, pod_sync: Optional[Callable] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.pipeline = pipeline
        self.ckpt = ckpt
        # WtfClient is one-per-thread (it holds open-transaction state):
        # the async checkpoint thread gets its own client on the same
        # cluster, otherwise its commit transaction would interleave with
        # the main thread's data-pipeline reads
        async_mgr = CheckpointManager(ckpt.client.cluster.client(),
                                      ckpt.root, keep=ckpt.keep)
        self.async_ckpt = AsyncCheckpointer(async_mgr)
        self.cfg = cfg
        self.hyper = hyper
        self.rules = rules
        self.pod_sync = pod_sync
        self.train_step = make_train_step(model, hyper, rules)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------ restart
    def _template(self) -> Dict[str, Any]:
        """The state's tree structure (the restore reads only that)."""
        schema = self.model.schema()
        return {"params": schema, "opt": opt.OptState(schema, schema, None),
                "step": None}

    def restore_or_init(self):
        """Cold start or restart — one code path, transactional cursor."""
        step = self.ckpt.latest_step()
        if step is None:
            return (init_state(self.model, self.cfg.seed, self.device),
                    PipelineState())
        man = self.ckpt.read_manifest(step)
        # restored leaves are read-only views over the fetched bytes:
        # from_numpy copies them onto the device
        host = self.ckpt.restore(self._template(), step)
        o = host["opt"]
        state = {"params": from_numpy(host["params"], self.device),
                 "opt": opt.OptState(from_numpy(o.m, self.device),
                                     from_numpy(o.v, self.device),
                                     from_numpy(o.count, self.device)),
                 "step": from_numpy(host["step"], self.device)}
        pstate = PipelineState.from_dict(man.get("pipeline", {
            "epoch": 0, "step_in_epoch": 0}))
        return state, pstate

    # ---------------------------------------------------------------- run
    def _batch(self, raw: dict) -> Dict[str, torch.Tensor]:
        """One host-to-device copy of each of the batch's arrays."""
        return {k: torch.from_numpy(np.array(raw[k])).to(self.device)
                for k in ("tokens", "labels")}

    def run(self) -> Dict[str, Any]:
        state, pstate = self.restore_or_init()
        start = int(state["step"])
        self.pipeline.state = pstate
        it = iter(self.pipeline)
        t_last = time.time()
        for step in range(start, self.cfg.total_steps):
            raw = next(it)
            batch = self._batch(raw)
            pstate = PipelineState(raw["epoch"], raw["step_in_epoch"] + 1)
            state, metrics = self.train_step(state, batch)
            if self.pod_sync is not None and self.cfg.pod_sync_every \
                    and (step + 1) % self.cfg.pod_sync_every == 0:
                state["params"] = self.pod_sync(state["params"])
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["steps_per_s"] = self.cfg.log_every \
                    / max(time.time() - t_last, 1e-9)
                t_last = time.time()
                self.history.append(m)
                print(f"[train] step {step + 1}: loss={m['loss']:.4f} "
                      f"lr={m.get('lr', 0):.2e} "
                      f"({m['steps_per_s']:.2f} it/s)", flush=True)
            if (step + 1) % self.cfg.ckpt_every == 0:
                self._save(state, pstate, step + 1)
        self.async_ckpt.wait()
        return {"final_step": self.cfg.total_steps,
                "history": self.history}

    def _save(self, state, pstate: PipelineState, step: int) -> None:
        self.async_ckpt.save(step, host_copy(state),
                             extra={"pipeline": pstate.to_dict()},
                             prev_step=self.ckpt.latest_step())

    # -------------------------------------------------------------- elastic
    def with_hosts(self, host_id: int, num_hosts: int) -> "Trainer":
        """Elastic re-scale: same global step, new host topology.  Like
        the JAX package's, the new trainer has no ``rules`` and no
        ``pod_sync``."""
        return Trainer(self.model, self.pipeline.with_hosts(host_id,
                                                            num_hosts),
                       self.ckpt, self.hyper, self.cfg, device=self.device)
