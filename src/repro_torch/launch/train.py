"""End-to-end training driver: data pipeline -> train step -> coordination
agent (the paper's layer).

The counterpart of ``repro.launch.train`` on one card. The coordination
agent wraps the dispatch loop as the paper prescribes: no change to the
step function, bounded pacing applied between iterations, per-phase
timings recorded for the diagnostics report. The dispatch ends in
``torch.cuda.synchronize()`` on the card, so the agent times the step and
not its enqueue.

Devices and backends: ``device=None`` is the card and raises
``RuntimeError`` without one; ``backend="cuda"`` (the default) runs the
hand-written kernels (K4, K5, K6 and K7, as the model's layers have
them, in every forward and remat recompute) and refuses the CPU. The CPU
is used only when asked for by name: ``device="cpu", backend="torch"``. Checkpointing (``ckpt_dir``,
``ckpt_every``, ``resume``) is refused until ``CheckpointManager`` is
ported (``ROADMAP.md`` Queue 1 item 11), and so is the mesh.

Run it as ``PYTHONPATH=src python -m repro_torch.launch.train`` (smoke
configuration, seeded random weights).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (OptimizerConfig, PacingConfig,
                                 get_model_config)
from repro_torch.core import CoordinationAgent
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.launch.steps import make_train_step
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
    initialised from ``seed``. ``stats``, when given, receives per step
    ``step_s`` (host clock around the synchronised step), ``loss``,
    ``lr`` and ``grad_norm``."""
    if ckpt_dir is not None or ckpt_every or resume:
        raise NotImplementedError(
            "checkpointing is not ported yet: CheckpointManager comes with "
            "ROADMAP.md Queue 1 item 11")
    cfg = model.cfg if model is not None else \
        get_model_config(arch, smoke=smoke)
    if cfg.name != get_model_config(arch).name:
        raise ValueError(f"model is {cfg.name!r}, arch is {arch!r}")
    if model is None:
        model = build_model(cfg, device=device)
        model.init(seed)
    elif device is not None and torch.device(device) != model.device:
        raise ValueError(f"model is on {model.device}, device={device!r}")
    dev = model.device
    model.requires_grad_(True)
    opt_cfg = opt_cfg or OptimizerConfig(warmup_steps=max(2, steps // 10),
                                         total_steps=max(steps, 10))
    opt_state = init_opt_state(opt_cfg,
                               dict(model.params.named_parameters()))
    step_fn = make_train_step(model, opt_cfg, backend=backend)

    source = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=global_batch, seed=seed)
    prefetch = Prefetcher(source, start_step=0, max_steps=steps)
    agent = CoordinationAgent(pacing or PacingConfig())
    losses = []
    log = {"step_s": [], "loss": [], "lr": [], "grad_norm": []}
    try:
        for step in range(steps):
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
    finally:
        prefetch.close()
    if stats is not None:
        stats.update(log)
    return TrainResult(steps=steps, losses=losses, summary=agent.summary(),
                       final_loss=losses[-1] if losses else float("nan"))


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
    args = ap.parse_args()
    res = train(arch=args.arch, smoke=args.smoke, steps=args.steps,
                seq_len=args.seq_len, global_batch=args.global_batch,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume, device=args.device,
                backend=args.backend)
    print(json.dumps({"final_loss": res.final_loss,
                      "summary": res.summary}, indent=1, default=str))


if __name__ == "__main__":
    main()
