"""End-to-end training driver: data pipeline -> train step -> coordination
agent (the paper's layer) -> checkpoint/restart.

The counterpart of ``repro.launch.train``. The coordination agent wraps
the dispatch loop as the paper prescribes: no change to the step
function, bounded pacing applied between iterations, per-phase timings
recorded for the diagnostics report. The dispatch ends in
``torch.cuda.synchronize()`` on the card, so the agent times the step and
not its enqueue.

Devices and backends: ``device=None`` is the card and raises
``RuntimeError`` without one; ``backend="cuda"`` (the default) runs the
hand-written kernels (K4, K5, K6 and K7, as the model's layers have
them, in every forward and remat recompute) and refuses the CPU. The CPU
is used only when asked for by name: ``device="cpu", backend="torch"``.

Checkpoints (``ckpt_dir``, ``ckpt_every``, ``resume``) follow the
reference: ``(params, opt_state)`` is saved in the reference's layout
(``ckpt.CheckpointManager``, ``models.convert.train_state_tree``) every
``ckpt_every`` steps with ``{"next_step", "arch"}``, and ``resume``
restarts from the newest one at its ``next_step``, the data stream
included (``Prefetcher(start_step=)``), so a resumed run takes the same
steps as a straight one. ``ckpt_every`` or ``resume`` without
``ckpt_dir``, and a ``ckpt_dir`` with neither, are refused.

``mesh`` (``launch.mesh``, over the running process group) trains on
it: ``make_train_step(..., mesh=)`` on every rank, each taking its slice
of the same global batch over ``pod x data``, and over a ``model`` axis
larger than 1 tensor parallel (the model is built on the mesh and holds
this rank's shards). A checkpoint gathers the moments' ZeRO-1 slices
(the optimizer's default) and the model-sharded leaves, rank 0 writes
whole leaves as the reference's one process does and the other ranks
wait at a barrier, and a restore reads whole leaves and keeps this rank's
shard and slice, so a checkpoint written at one ``(data, model)`` restores
at another.

Run it as ``PYTHONPATH=src python -m repro_torch.launch.train`` (smoke
configuration, seeded random weights); under ``torchrun`` it trains over
a ``(data, model)`` mesh of the ranks, ``model`` set by
``--model-parallel`` (1 by default).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch

import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager, Stacked
from repro_torch.ckpt.checkpoint import _flatten_with_paths
from repro_torch.configs import (OptimizerConfig, PacingConfig,
                                 get_model_config)
from repro_torch.core import CoordinationAgent
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.ft import RecoveryLog
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import make_train_step
from repro_torch.models import convert
from repro_torch.models.api import Model, build_model
from repro_torch.optim import init_opt_state


@dataclasses.dataclass
class TrainResult:
    steps: int
    losses: list
    summary: Dict[str, Any]
    final_loss: float


def train(
    *,
    arch: str,
    smoke: bool = True,
    steps: int = 20,
    seq_len: int = 128,
    global_batch: int = 8,
    seed: int = 0,
    pacing: Optional[PacingConfig] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
    mesh=None,
    opt_cfg: Optional[OptimizerConfig] = None,
    log_every: int = 5,
    model: Optional[Model] = None,
    device=None,
    backend: str = "cuda",
    stats: Optional[Dict[str, Any]] = None,
) -> TrainResult:
    """Train ``steps`` steps on the synthetic stream (seeded by ``seed``,
    as the parameters are). ``model`` stands for the reference's
    initialised parameters: a ``Model`` holding weights, whose
    configuration is then the one trained (it must be ``arch``'s) and
    whose device is used; its parameters are made trainable and updated
    in place. Without it the ``arch`` model is built on ``device`` and
    initialised from ``seed``. The default ``opt_cfg`` depends on
    ``steps`` (its warmup and total steps), so a resumed run must be
    given the same ``steps`` as the run that saved. ``stats``, when
    given, receives per step ``step_s`` (host clock around the
    synchronised step), ``loss``, ``lr`` and ``grad_norm``, and
    ``start_step``, ``recovery`` (the ``RecoveryLog``'s events) and the
    last save's ``ckpt`` figures (snapshot and write seconds, bytes) and a
    resume's ``restore_s``."""
    if (ckpt_every or resume) and ckpt_dir is None:
        raise ValueError("ckpt_every and resume need ckpt_dir")
    if ckpt_dir is not None and not (ckpt_every or resume):
        raise ValueError("ckpt_dir without ckpt_every or resume: nothing "
                         "would be saved or restored")
    cfg = model.cfg if model is not None else \
        get_model_config(arch, smoke=smoke)
    if cfg.name != get_model_config(arch).name:
        raise ValueError(f"model is {cfg.name!r}, arch is {arch!r}")
    if model is None:
        model = build_model(cfg, device=device, mesh=mesh)
        model.init(seed)
    elif device is not None and torch.device(device) != model.device:
        raise ValueError(f"model is on {model.device}, device={device!r}")
    dev = model.device
    model.requires_grad_(True)
    opt_cfg = opt_cfg or OptimizerConfig(warmup_steps=max(2, steps // 10),
                                         total_steps=max(steps, 10))
    params = dict(model.params.named_parameters())
    step_fn = make_train_step(model, opt_cfg, backend=backend, mesh=mesh)
    zero = step_fn.zero
    opt_state = init_opt_state(opt_cfg, params, zero)
    rank = dist.get_rank() if mesh is not None else 0

    mgr = CheckpointManager(ckpt_dir, keep=3, write=rank == 0) \
        if ckpt_dir else None
    start_step = 0
    log = {"step_s": [], "loss": [], "lr": [], "grad_norm": []}
    if mgr and resume and mgr.latest_step() is not None:
        s = mgr.latest_step()
        t = time.perf_counter()
        _, meta = mgr.restore(
            s, convert.train_state_tree(params, opt_state, cfg),
            placement_fn=_zero_placement(params, zero, cfg, model))
        log["restore_s"] = time.perf_counter() - t
        start_step = int(meta.get("next_step", s))

    source = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=global_batch, seed=seed)
    prefetch = Prefetcher(source, start_step=start_step, max_steps=steps)
    agent = CoordinationAgent(pacing or PacingConfig())
    recovery = RecoveryLog()
    losses = []
    try:
        for step in range(start_step, steps):
            np_batch = agent.timed_data(prefetch.next)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in np_batch.items()}

            def dispatch():
                nonlocal opt_state
                t = time.perf_counter()
                opt_state, metrics = step_fn(opt_state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                log["step_s"].append(time.perf_counter() - t)
                return metrics

            metrics = agent.timed_step(dispatch)
            rec = agent.end_iteration(step)
            loss = float(metrics["loss"])
            losses.append(loss)
            log["loss"].append(loss)
            log["lr"].append(float(metrics["lr"]))
            log["grad_norm"].append(float(metrics["grad_norm"]))
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {log['lr'][-1]:.2e} "
                      f"gnorm {log['grad_norm'][-1]:.2f} "
                      f"t {rec.total_time*1e3:.0f}ms")
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, _save_tree(params, opt_state, zero, cfg,
                                              model),
                         metadata={"next_step": step + 1, "arch": arch})
                if mesh is not None:
                    dist.barrier()
                    mesh_lib.count("barrier")
                recovery.record("resume", step + 1, "checkpoint saved")
        if mgr:
            mgr.wait()
            if mesh is not None:
                dist.barrier()
                mesh_lib.count("barrier")
    finally:
        prefetch.close()
    if stats is not None:
        stats.update(log, start_step=start_step,
                     recovery=[dataclasses.asdict(e)
                               for e in recovery.events],
                     ckpt=dict(mgr.last_save) if mgr else {})
    return TrainResult(steps=steps, losses=losses, summary=agent.summary(),
                       final_loss=losses[-1] if losses else float("nan"))


def _tp(model) -> bool:
    return model is not None and model.mesh is not None and \
        mesh_lib.model_size(model.mesh) > 1


def _save_tree(params, opt_state, zero, cfg, model=None):
    """The tree a checkpoint saves: under ZeRO-1 each sharded moment is
    gathered whole over ``pod x data``, and on a tensor-parallel
    ``model`` each model-sharded leaf (parameter or moment) over
    ``model``, when the snapshot reaches it (every rank joins)."""
    tp = _tp(model)
    if zero is None and not tp:
        return convert.train_state_tree(params, opt_state, cfg)

    def whole(n, t):
        if zero is not None:
            t = zero.gather(n, t)
        return model.gather(n, t) if tp else t

    lazy = lambda tree: {n: (lambda n=n, t=t: whole(n, t))
                         for n, t in tree.items()}
    ptree = {n: (lambda n=n, t=t: model.gather(n, t))
             for n, t in params.items()} if tp else params
    return convert.train_state_tree(
        ptree, opt_state._replace(mu=lazy(opt_state.mu),
                                  nu=lazy(opt_state.nu)), cfg)


def _zero_placement(params, zero, cfg, model=None):
    """``placement_fn`` for a restore under ZeRO-1 and on a
    tensor-parallel ``model``: a whole host leaf is cut to this rank's
    shard over ``model`` (a parameter or a moment), and a moment further
    to its ZeRO-1 slice; ``None`` when nothing is cut."""
    tp = _tp(model)
    if zero is None and not tp:
        return None
    names = {}
    tree = convert.reference_tree({n: n for n in params}, cfg)
    for path, leaf in _flatten_with_paths(tree):
        for which in ("/0", "/1/1", "/1/2"):          # params, mu, nu
            if isinstance(leaf, Stacked):
                names.update({f"{which}{path}[{t}]": (which, n)
                              for t, n in enumerate(leaf)})
            else:
                names[f"{which}{path}"] = (which, leaf)

    def place(path, host):
        which, n = names.get(path, (None, None))
        if n is None:
            return host
        if tp:
            host = model.shard(n, host)
        if which != "/0" and zero is not None:
            host = zero.shard(n, host)
        return host
    return place


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's 'model' axis under torchrun (tensor "
                         "parallelism); the rest of the ranks are 'data'")
    args = ap.parse_args()
    mesh, device = mesh_lib.mesh_from_torchrun(args.device,
                                               args.model_parallel)
    try:
        res = train(arch=args.arch, smoke=args.smoke, steps=args.steps,
                    seq_len=args.seq_len, global_batch=args.global_batch,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    resume=args.resume, mesh=mesh, device=device,
                    backend=args.backend)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    print(json.dumps({"final_loss": res.final_loss,
                      "summary": res.summary}, indent=1, default=str))


if __name__ == "__main__":
    main()
