"""Training loop with checkpoint/resume, and the paper's SpC pipelines
(port of ``repro.train.loop``).

  * resume: ``train_loop`` restarts from the newest complete checkpoint;
    data is a pure function of (seed, step), so replay is exact;
  * stragglers: a watchdog records step wall times and flags steps slower
    than ``factor`` x the median;
  * ``run_spc_pipeline``: sparse-coding training, then mask-frozen debias
    retraining (paper section 2.4);
  * ``run_spc_retrain_pipeline`` (SpC-Retrain): SpC training with the
    plan-aligned block group-l1 prox, compression with no prune step, and
    debias retraining ON the compressed params: only the BlockCSR block
    stores (and the dense residue) train, the weight gradient reaches them
    through ``sparse_matmul``'s SDDMM backward at the resident slots.

Under a rank mesh (``distributed.sharding.use_mesh``) the state holds
this rank's part: checkpoints gather it and rank 0 writes them in the
JAX package's format, a resume gives each rank its part again, reports
and telemetry read the whole params, and SpC-Retrain compresses the whole
model and places the compressed pytree again before debias.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import masks as masks_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.optimizers import ProxOptimizer
from repro_torch.distributed import sharding
from repro_torch.sparse.compress import (CompressionPlan, compress_params,
                                         compressed_size_bytes,
                                         split_trainable)
from repro_torch.train.state import TrainState

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 200
    log_every: int = 20
    straggler_factor: float = 3.0


class StragglerWatchdog:
    """Flags abnormally slow steps (an operator signal)."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.times: list[float] = []
        self.factor = factor
        self.window = window
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float):
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            med = float(np.median(hist))
            if dt > self.factor * med:
                self.flagged.append((step, dt))
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)


def _whole(tree):
    """The whole tree of a rank's part under a mesh (every rank calls)."""
    mesh = sharding.current_mesh()
    return tree if mesh is None else sharding.gather_state(tree, mesh)


def _save(checkpointer, state) -> None:
    mesh = sharding.current_mesh()
    whole = _whole(state)
    if mesh is None or mesh.rank == 0:
        checkpointer.save(int(state.step), whole)


def train_loop(train_step: Callable, state: TrainState,
               batch_fn: Callable[[int], dict], loop_cfg: LoopConfig,
               checkpointer=None,
               metrics_cb: Optional[Callable[[int, dict], None]] = None,
               telemetry=None, phase: str = "train",
               extra_fn: Optional[Callable] = None):
    """Run (and resume) one training phase. Returns (state, history).

    ``telemetry`` (an ``obs.TrainTelemetry``) gets one phase-tagged record
    per log step; ``extra_fn(params) -> dict`` adds host-side measurements
    to it. The step's metrics are read (and the device waited for) on log
    steps only."""
    start = int(state.step)
    if checkpointer is not None:
        latest = checkpointer.latest_step()
        if latest is not None and latest > start:
            log.info("resuming from checkpoint step %d", latest)
            state = checkpointer.restore(latest, state,
                                         mesh=sharding.current_mesh())
            start = int(state.step)

    watchdog = StragglerWatchdog(loop_cfg.straggler_factor)
    history: list[dict] = []
    for step in range(start, loop_cfg.total_steps):
        t0 = time.perf_counter()
        batch = batch_fn(step)
        state, metrics = train_step(state, batch)
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = step
            history.append(metrics)
            if metrics_cb:
                metrics_cb(step, metrics)
            if telemetry is not None:
                rec = {"phase": phase, **metrics}
                if extra_fn is not None:
                    rec.update(extra_fn(_whole(state.params)))
                telemetry.emit(rec)
        watchdog.record(step, time.perf_counter() - t0)
        if checkpointer is not None and (step + 1) % loop_cfg.ckpt_every == 0:
            _save(checkpointer, state)

    if checkpointer is not None:
        _save(checkpointer, state)
    return state, history


def run_spc_pipeline(params, make_train_step: Callable[..., Callable],
                     opt_spc: ProxOptimizer, opt_debias: ProxOptimizer,
                     batch_fn: Callable[[int], dict], spc_steps: int,
                     debias_steps: int = 0, checkpointer=None,
                     log_every: int = 50, telemetry=None,
                     sparsity_block: Optional[tuple] = None):
    """The paper's pipeline: SpC training, then debias retraining with the
    zero mask frozen and the regularizer off. Returns (final_state,
    spc_history, debias_history, compression_report)."""
    extra_fn = None
    if telemetry is not None and sparsity_block is not None:
        from repro_torch.obs.profile import sparsity_telemetry_fn
        extra_fn = sparsity_telemetry_fn(tuple(sparsity_block))
    state = TrainState.create(params, opt_spc)
    cfg = LoopConfig(total_steps=spc_steps, log_every=log_every)
    state, hist_spc = train_loop(make_train_step(opt_spc), state, batch_fn,
                                 cfg, checkpointer, telemetry=telemetry,
                                 phase="spc", extra_fn=extra_fn)
    report = {"spc": metrics_lib.total_compression(_whole(state.params))}

    hist_db: list[dict] = []
    if debias_steps:
        mask = masks_lib.zero_mask(state.params)
        state = TrainState(params=state.params,
                           opt_state=opt_debias.init(state.params),
                           mask=mask, step=0)
        cfg = LoopConfig(total_steps=debias_steps, log_every=log_every)
        state, hist_db = train_loop(make_train_step(opt_debias), state,
                                    batch_fn, cfg, None, telemetry=telemetry,
                                    phase="debias", extra_fn=extra_fn)
        report["debias"] = metrics_lib.total_compression(
            _whole(state.params))
    if telemetry is not None:
        telemetry.emit({"phase": "report", **report})
    return state, hist_spc, hist_db, report


def run_spc_retrain_pipeline(params, make_train_step: Callable,
                             opt_spc: ProxOptimizer,
                             opt_debias: ProxOptimizer,
                             batch_fn: Callable[[int], dict], spc_steps: int,
                             debias_steps: int, plan: CompressionPlan,
                             checkpointer=None, log_every: int = 50,
                             telemetry=None):
    """SpC -> compress -> mask-frozen debias ON the compressed params.

    ``opt_spc`` should carry ``sparse.compress.make_plan_prox(plan)``, so
    whole (out, in) blocks reach exact zero during training and compression
    needs no prune step. ``make_train_step(opt, param_transform=None)``
    must forward the transform to ``train.step.make_train_step``. Returns
    (compressed_params, hist_spc, hist_db, report)."""
    extra_fn = None
    if telemetry is not None:
        from repro_torch.obs.profile import sparsity_telemetry_fn
        extra_fn = sparsity_telemetry_fn(tuple(plan.block))
    state = TrainState.create(params, opt_spc)
    cfg = LoopConfig(total_steps=spc_steps, log_every=log_every)
    state, hist_spc = train_loop(make_train_step(opt_spc), state, batch_fn,
                                 cfg, checkpointer, telemetry=telemetry,
                                 phase="spc", extra_fn=extra_fn)
    whole = _whole(state.params)
    report = {"spc": metrics_lib.total_compression(whole)}

    cp = compress_params(whole, plan)
    report["bcsr_bytes"] = compressed_size_bytes(cp)
    report["dense_bytes"] = metrics_lib.model_size_bytes(whole)
    del whole
    mesh = sharding.current_mesh()
    if mesh is not None:
        cp = sharding.shard_params(cp, mesh)
    if telemetry is not None:
        telemetry.emit({"phase": "compress",
                        "bcsr_bytes": report["bcsr_bytes"],
                        "dense_bytes": report["dense_bytes"]})
    del state

    hist_db: list[dict] = []
    if debias_steps:
        trainable, rebuild = split_trainable(cp)
        del cp
        st = TrainState(params=trainable,
                        opt_state=opt_debias.init(trainable),
                        mask=masks_lib.zero_mask(trainable), step=0)
        cfg = LoopConfig(total_steps=debias_steps, log_every=log_every)
        st, hist_db = train_loop(
            make_train_step(opt_debias, param_transform=rebuild), st,
            batch_fn, cfg, None, telemetry=telemetry, phase="debias")
        cp = rebuild(st.params)
    return cp, hist_spc, hist_db, report
