"""Serving: prefill + batched greedy decode with a KV cache.

The counterpart of ``repro.launch.serve``. A prefill fills the cache for a
request batch, then the decode step runs one token per iteration for the
whole batch, writing the cache in place (the reference donates it to the
jitted step). The coordination agent wraps each decode dispatch as it
wraps a training step; the dispatch ends in ``torch.cuda.synchronize()``
on the card, so the agent times the step and not its enqueue.

Devices and backends: ``device=None`` is the card and raises
``RuntimeError`` without one; ``backend="cuda"`` (the default) runs the
hand-written kernels and refuses the CPU. The CPU is used only when asked
for by name: ``device="cpu", backend="torch"``.

``mesh`` (``launch.mesh``, over the running process group) serves on
it, as the reference's ``generate(mesh=)``: the model is built on the
mesh (tensor parallel over a ``model`` axis larger than 1, each rank
holding its shards), each rank serves its slice of the request batch by
its coordinate on the axes its resolved spec cuts it on (``pod x data``
where they divide it; the whole batch where none does, as the reference
replicates it), and the tokens are gathered over those axes at the end,
so every rank returns the whole batch (``launch.steps.rank_slice``,
which keeps the global batch's size bound while the rank serves its
slice). Under rules the caller binds on the mesh
(``launch.sharding.axis_rules(mesh, {"seq": "data"})`` or ``{"seq":
"model"}`` around the call) the prompt is context parallel wherever the
reference cuts it: each rank prefills its block of the prompt
(``models.transformer.forward``) into its blocks of the cache, which the
decode steps then run on.

Run it as ``PYTHONPATH=src python -m repro_torch.launch.serve`` (smoke
configuration, seeded random weights); under ``torchrun`` it serves over
a ``(data, model)`` mesh of the ranks, ``model`` set by
``--model-parallel``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import PacingConfig, get_model_config
from repro_torch.core import CoordinationAgent
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (batch_cut, make_decode_step,
                                      make_prefill_step, rank_slice)
from repro_torch.models.api import Model, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    *,
    arch: str,
    prompt_tokens,                     # (B, S_prompt) integer tensor/array
    max_new_tokens: int = 16,
    smoke: bool = True,
    model: Optional[Model] = None,
    seed: int = 0,
    pacing: Optional[PacingConfig] = None,
    device=None,
    backend: str = "cuda",
    stats: Optional[Dict[str, Any]] = None,
    enc_embeds=None,                   # (B, S_enc, D), encoder-decoders
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy decode. Returns (tokens (B, S_prompt+new), agent summary).

    ``model`` stands for the reference's ``params``: a ``Model`` holding
    weights, whose configuration is then the one served (it must be
    ``arch``'s) and whose device is used; without it the ``arch`` model is
    built on ``device`` and initialised from ``seed``. An encoder-decoder
    needs ``enc_embeds`` (``ValueError`` without them): they are encoded
    once, and the memory goes into the prefill and every decode step.
    ``mesh``: the module's docstring; a given ``model`` must have been
    built on it when its ``model`` axis is larger than 1.
    ``stats``, when given, receives ``prefill_s`` (the encoder's time
    included) and ``decode_s`` (one entry per step), host clock around
    synchronised work."""
    cfg = model.cfg if model is not None else \
        get_model_config(arch, smoke=smoke)
    if cfg.name != get_model_config(arch).name:
        raise ValueError(f"model is {cfg.name!r}, arch is {arch!r}")
    if cfg.is_encoder_decoder and enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: serving it "
                         f"needs enc_embeds")
    if model is None:
        model = build_model(cfg, device=device, mesh=mesh)
        model.init(seed)
    elif device is not None and torch.device(device) != model.device:
        raise ValueError(f"model is on {model.device}, device={device!r}")
    dev = model.device
    agent = CoordinationAgent(pacing or PacingConfig())

    if not isinstance(prompt_tokens, torch.Tensor):
        prompt_tokens = torch.from_numpy(np.asarray(prompt_tokens))
    tokens = prompt_tokens.to(device=dev, dtype=torch.long)
    axes, dp, _ = ((), 1, 0) if mesh is None else \
        batch_cut(mesh, tokens.shape[0])
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        if not isinstance(enc_embeds, torch.Tensor):
            enc_embeds = torch.from_numpy(np.asarray(enc_embeds))
        batch["enc_embeds"] = enc_embeds.to(dev)
    max_len = tokens.shape[1] + max_new_tokens
    prefill = make_prefill_step(model, max_len=max_len, backend=backend,
                                mesh=mesh)
    decode = make_decode_step(model, backend=backend, mesh=mesh)
    step_s = []

    with torch.inference_mode(), rank_slice(batch, mesh) as local:
        tokens = local["tokens"]
        B, S = tokens.shape
        t0 = time.perf_counter()
        memory = None
        if cfg.is_encoder_decoder:
            memory = model.encode(local["enc_embeds"], backend=backend)
        logits, cache = prefill({"tokens": batch["tokens"]}, memory)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        out = [tokens]
        tok = torch.argmax(logits, -1)
        for i in range(max_new_tokens):
            out.append(tok[:, None])
            kv_len = torch.full((B,), S + i + 1, dtype=torch.int32,
                                device=dev)

            def dispatch():
                nonlocal cache
                t = time.perf_counter()
                lg, cache = decode(tok, S + i, kv_len, cache, memory)
                _sync(dev)
                step_s.append(time.perf_counter() - t)
                return lg

            lg = agent.timed_step(dispatch)
            agent.end_iteration(i)
            tok = torch.argmax(lg, -1)
    if stats is not None:
        stats.update(prefill_s=prefill_s, decode_s=step_s)
    out = torch.cat(out, dim=1)
    if dp > 1:
        out = mesh_lib.all_gather(out, mesh_lib.axes_group(mesh, axes), 0)
    return out, agent.summary()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's 'model' axis under torchrun (tensor "
                         "parallelism); the rest of the ranks are 'data'")
    args = ap.parse_args()
    mesh, device = mesh_lib.mesh_from_torchrun(args.device,
                                               args.model_parallel)
    cfg = get_model_config(args.arch, smoke=True)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len))
    enc = None
    if cfg.is_encoder_decoder:
        enc = (rng.standard_normal((args.batch, args.prompt_len,
                                    cfg.d_model)) * 0.02).astype(np.float32)
    try:
        toks, summary = generate(arch=args.arch, prompt_tokens=prompts,
                                 max_new_tokens=args.max_new_tokens,
                                 device=device, backend=args.backend,
                                 enc_embeds=enc, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    print("generated shape:", tuple(toks.shape))
    print(json.dumps(summary, indent=1, default=str))


if __name__ == "__main__":
    main()
