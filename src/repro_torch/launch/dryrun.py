"""Multi-pod dry run: show that the distribution is coherent without the
hardware, and reckon each cell's roofline on the H100.

The counterpart of ``repro.launch.dryrun``. For every (architecture x
input shape) cell, one rank's step (train step, prefill or decode, as the
shape says) is traced on the meta device (``launch.steps.lower_*``) on
the single-pod 16 x 16 mesh (256 ranks) and the 2 x 16 x 16 multi-pod
mesh (512), and the result records:

  * ``memory_analysis`` -- the rank's argument, output, aliased, peak and
    temporary bytes (the trace's, where the reference reads
    ``compiled.memory_analysis()``),
  * ``roofline`` -- the compute, memory and collective terms at the H100's
    constants (``launch.roofline``), from the trace's FLOPs, bytes
    accessed and collective operand bytes,
  * ``collectives`` -- ``total_bytes``, ``bytes_by_op``, ``counts``,
  * ``model_flops_global`` and ``useful_flops_ratio`` -- the analytic
    useful work against the traced FLOPs of all ranks,
  * ``fallbacks`` -- the dims the reference's rules replicate
    (divisibility), from the parameters' specs.

There is no device to fake: the mesh is built over the fake process group
of ``torch.testing._internal.distributed.fake_pg`` (every collective
returns at once), one process per mesh size, which traces rank 0
(:func:`fake_group`). ``trace_s`` stands where the reference has
``lower_s`` / ``compile_s``. The Python layer loop runs every layer, so
there is no per-period extrapolation in a cell (:func:`reduced_depth` is
kept for the tests, which hold the full depth to ``c1 + (n - 1)(c2 -
c1)``). The reference's ``REPRO_ATTN_BLOCK_K`` is not carried over: its
``cost_analysis`` counts a while loop's body once, while the port's
chunked attention runs every kv block in Python, so the count is the
whole S x S work at any ``block_k``.

A cell that fails, or that the port refuses, is recorded ``ok: false``
with its error, as the reference records failures; the command prints a
refused cell (``NotImplementedError``) as ``[REFUSED]`` and exits non-zero
only for a cell that failed otherwise. The ``long_500k`` cells and the
``seqkv`` variant's decode cells trace context-parallel decode (their
``seq`` rule cuts each attention cache's sequence over ``data`` or
``model``: ``launch.sharding.seq_cut``), the merge's all-reduces and the
query's all-gather counted among the collectives. The ``long_500k``
cells stay decode cells, as in the reference. The ``seqkv`` variant's
``train_4k`` and ``prefill_32k`` cells fail with ``ValueError``, as the
reference's fail with ``DuplicateSpecError``: the logits' spec
``("batch", "seq", "vocab")`` maps ``model`` twice wherever the axis
divides the padded vocabulary, which every configuration's does
(``launch.sharding.activation_axes``); so does a ``seqkv`` decode cell
whose cache spec maps ``model`` twice (KV heads that the axis divides).

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>[__variant]
.json``. Run ``python -m repro_torch.launch.dryrun --mesh both`` (every
cell of ``applicable_shapes`` for the ten configurations).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional

import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, OptimizerConfig,
                                 applicable_shapes, get_model_config)
from repro_torch.launch import sharding as shd
from repro_torch.launch.dryrun_variants import apply_variant_pure
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import extract_terms, model_flops
from repro_torch.launch.steps import lower_step_for, lower_train_step
from repro_torch.models.api import build_model

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESH_WORLD = {"single": 256, "multi": 512}


def cell_rules(shape_name: str) -> Optional[Dict]:
    """Axis-rule overrides per cell. long_500k decodes context-parallel:
    the KV/state sequence dim shards over the `data` axis."""
    if shape_name == "long_500k":
        return {"seq": "data"}
    return None


def reduced_depth(cfg, k: int):
    """Config with ``prefix + k`` scan periods (and a proportionally reduced
    encoder). Used for exact per-period cost extrapolation: XLA's
    ``cost_analysis`` counts a while-loop body ONCE, so the full-depth module
    underreports FLOPs/bytes by ~n_periods; lowering k=1 and k=2 and taking
    the difference isolates one period exactly (scan bodies are identical).
    """
    from repro_torch.models.transformer import layer_layout
    prefix, kinds, n_periods = layer_layout(cfg)
    P = len(kinds)
    kw = {"num_layers": prefix + k * P, "scan_layers": False}
    if cfg.num_encoder_layers:
        enc_per = max(1, cfg.num_encoder_layers // n_periods)
        kw["num_encoder_layers"] = k * enc_per
    return cfg.replace(**kw), n_periods


def apply_variant(cfg, variant: str):
    """See repro_torch.launch.dryrun_variants.apply_variant_pure."""
    return apply_variant_pure(cfg, variant)


def fake_group(world: int) -> None:
    """Start the fake process group of ``world`` ranks, this process rank
    0 (nothing when one of that size runs already)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks runs; the mesh needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _lower_variant(model, opt_cfg, mesh, shape, mb: int, int8pod: bool):
    if int8pod:
        from repro_torch.launch.compressed import lower_compressed_train_step
        assert shape.kind == "train", "int8pod applies to train cells"
        return lower_compressed_train_step(model, opt_cfg, mesh, shape)
    if shape.kind == "train" and mb > 1:
        return lower_train_step(model, opt_cfg, mesh, shape,
                                microbatches=mb)
    return lower_step_for(model, opt_cfg, mesh, shape)


def _fallbacks(model) -> list:
    """The (logical name, dim, divisor) fallbacks of the reference's rules
    on the model's whole parameters, under the bound rules
    (``Model.fallbacks``)."""
    return [list(f) for f in model.fallbacks()]


def cell_tag(arch: str, shape_name: str, mesh_name: str,
             variant: str = "") -> str:
    return f"{arch}__{shape_name}__{mesh_name}" + \
        (f"__{variant.replace('+', '_')}" if variant else "")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             optimized: bool = False, variant: str = "",
             out_dir: str = RESULTS_DIR, save: bool = True) -> Dict:
    """Trace one cell in this process, whose fake process group (of the
    mesh's size) must run (:func:`fake_group`)."""
    shape = SHAPES_BY_NAME[shape_name]
    if optimized and not variant:
        variant = "opt"
    cfg, mb, int8pod, noz1, vrules, venv = apply_variant(
        get_model_config(arch), variant)
    mesh_name = "multi" if multi_pod else "single"
    tag = cell_tag(arch, shape_name, mesh_name, variant)
    t0 = time.time()
    result: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "variant": variant}
    prev_env = {k: os.environ.get(k) for k in venv}
    os.environ.update(venv)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        opt_cfg = OptimizerConfig(zero1=not noz1)
        rules = dict(cell_rules(shape_name) or {})
        rules.update(vrules)
        with shd.axis_rules(mesh, rules or None):
            model = build_model(cfg, device="meta", mesh=mesh)
            trace = _lower_variant(model, opt_cfg, mesh, shape, mb, int8pod)
        with shd.axis_rules(mesh, rules or None):
            fallbacks = _fallbacks(model)
        terms, coll = extract_terms(trace, chips=mesh.size())
        mf = model_flops(cfg, shape)
        flops_global = terms.flops_per_device * mesh.size()
        result.update({
            "ok": True,
            "chips": mesh.size(),
            "trace_s": round(trace.trace_s, 2),
            "memory_analysis": trace.memory,
            "roofline": terms.to_dict(),
            "collectives": coll,
            "model_flops_global": mf,
            "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
            "fallbacks": fallbacks,
        })
    except Exception as e:  # noqa: BLE001 -- the dry run reports failures
        result.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
    for k, v in prev_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    result["wall_s"] = round(time.time() - t0, 2)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def _run_mesh(args, mesh_name: str) -> int:
    """Every requested cell on one mesh, in this process; the failures."""
    fake_group(MESH_WORLD[mesh_name])
    archs = [args.arch] if args.arch else ARCH_IDS
    failures = 0
    for arch in archs:
        shapes = ([args.shape] if args.shape
                  else [s.name for s in applicable_shapes(arch)])
        for shape_name in shapes:
            v = args.variant or ("opt" if args.optimized else "")
            tag = cell_tag(arch, shape_name, mesh_name, v)
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[skip] {tag}", flush=True)
                        continue
            r = run_cell(arch, shape_name, multi_pod=(mesh_name == "multi"),
                         optimized=args.optimized, variant=args.variant,
                         out_dir=args.out)
            if r["ok"]:
                t = r["roofline"]
                print(f"[ok]   {tag}: trace {r['trace_s']}s "
                      f"compute {t['compute_s']:.4f}s "
                      f"memory {t['memory_s']:.4f}s "
                      f"collective {t['collective_s']:.4f}s "
                      f"dominant={t['dominant']}", flush=True)
            elif r["error"].startswith("NotImplementedError"):
                print(f"[REFUSED] {tag}: {r['error']}", flush=True)
            else:
                failures += 1
                print(f"[FAIL] {tag}: {r['error']}", flush=True)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all "
                                                  "applicable)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--optimized", action="store_true",
                    help="use the beyond-paper optimized config variant")
    ap.add_argument("--variant", default="",
                    help="'+'-separated: opt, mb<k>, lc<n>, int8pod")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    failures = 0
    if args.mesh != "both":
        failures = _run_mesh(args, args.mesh)
    else:
        # a process per mesh size: each starts its own fake group
        argv = list(sys.argv[1:] if argv is None else argv)
        cut = [a for i, a in enumerate(argv) if a != "--mesh" and
               (i == 0 or argv[i - 1] != "--mesh") and
               not a.startswith("--mesh=")]
        procs = [subprocess.Popen([sys.executable, "-m",
                                   "repro_torch.launch.dryrun", *cut,
                                   "--mesh", m]) for m in MESH_WORLD]
        failed = [m for m, p in zip(MESH_WORLD, procs) if p.wait() != 0]
        if failed:
            raise SystemExit(f"dry-run cells failed on {failed}")
        return
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
