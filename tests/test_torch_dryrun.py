"""The dry run's traced half: one rank's step on the meta device.

Held exactly, on smoke configurations: the FLOPs a traced Qwen2-7B and
RWKV-6 train step counts against ``FlopCounterMode`` over a real CPU step
with ``backend="torch"`` on the same shapes, once the full-softmax
attention's and the sequential recurrence's counts are swapped for the
chunked forms' the meta device runs in their place (``kernels.ops``; the
swap is 0 where the keys are a multiple of the 512-key block); the full
depth's FLOPs and bytes against ``c1 + (n - 1)(c2 - c1)`` from
``reduced_depth``; a MoE prefill counting the reference's cost-mode
expert products (E-batched over the pairs padded to a multiple of E)
where a real CPU prefill counts the dropless ones; the traced argument
bytes against the state a real step is handed. Then, in subprocesses (a
fake process group of 256 and of 512 ranks, which must not outlive its
process; Jamba's cells, most of the time, in processes of their own):
every smoke configuration's ``train_4k`` cell ``ok`` on the 16 x 16 and
the 2 x 16 x 16 mesh, with its terms and collectives, and ``long_500k``
and the ``seqkv`` variant ``ok``, their decode's collectives those of the
same decode without the rule plus the merge's all-reduces; the ``seqkv``
variant's ``train_4k`` and ``prefill_32k`` cells ``ok: false`` with the
``ValueError`` of ``model`` mapped twice (the sequence and the
vocabulary), where the reference raises ``DuplicateSpecError``.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import OptimizerConfig, ShapeConfig
from repro_torch.kernels import chunked, ref
from repro_torch.launch.dryrun import reduced_depth
from repro_torch.launch.steps import (lower_prefill_step, lower_train_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models.api import build_model, input_specs, make_concrete
from repro_torch.optim import init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the plain forwards a real device runs, and the chunked forms the meta
# device runs in their place (kernels.ops)
PLAIN = {"attention": (ref.attention, chunked.flash_attention),
         "wkv6": (ref.wkv6, chunked.wkv6_chunked),
         "mamba_scan": (ref.mamba_scan, chunked.mamba_chunked)}
TRAIN = ShapeConfig("t", 32, 4, "train")
OPT = OptimizerConfig()


def _cfg(arch, **kw):
    return configs.get_model_config(arch, smoke=True).replace(**kw)


def _traced(cfg, shape=TRAIN):
    m = build_model(cfg, device="meta")
    if shape.kind == "train":
        return lower_train_step(m, OPT, None, shape)
    return lower_prefill_step(m, None, shape)


def _flops(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def _recorded(monkeypatch):
    """Patch the plain forwards to record each call's shapes, dtypes and
    keywords; returns the list they fill."""
    calls = []
    for name, (plain, _) in PLAIN.items():
        def rec(*args, _name=name, _plain=plain, **kw):
            calls.append((_name, [(tuple(a.shape), a.dtype) if a is not None
                                  else None for a in args], kw))
            return _plain(*args, **kw)
        monkeypatch.setattr(ref, name, rec)
    return calls


def _swap(calls) -> int:
    """The FLOPs the chunked forms count beyond the plain forwards at the
    recorded calls (on CPU tensors of their shapes)."""
    total = 0
    for name, args, kw in calls:
        plain, chunk = PLAIN[name]
        ts = [None if a is None else torch.rand(a[0]).to(a[1]) for a in args]
        total += _flops(chunk, *ts, **kw) - _flops(plain, *ts, **kw)
    return total


def _real_train(cfg, monkeypatch):
    """(FLOPs of a real CPU train step, the plain forwards' calls, the
    bytes of the state the step is handed)."""
    calls = _recorded(monkeypatch)
    m = build_model(cfg, device="cpu")
    m.init(0)
    m.requires_grad_(True)
    params = dict(m.params.named_parameters())
    step = make_train_step(m, OPT, backend="torch")
    state = init_opt_state(OPT, params)
    batch = make_concrete(input_specs(cfg, TRAIN), cfg, seed=0)
    held = sum(t.numel() * t.element_size() for t in
               [*params.values(), state.step, *state.mu.values(),
                *state.nu.values(), *batch.values()])
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    return fc.get_total_flops(), calls, held


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b"])
def test_torch_traced_train_flops_equal_a_real_cpu_step(arch, monkeypatch):
    cfg = _cfg(arch)
    trace = _traced(cfg)
    real, calls, held = _real_train(cfg, monkeypatch)
    kinds = {c[0] for c in calls}
    assert kinds == ({"attention"} if arch == "qwen2-7b" else {"wkv6"})
    assert trace.flops == real + _swap(calls)
    assert trace.flops > 6 * TRAIN.global_batch * TRAIN.seq_len * \
        cfg.num_layers * cfg.d_model ** 2
    assert trace.memory["argument_size_in_bytes"] == held
    assert trace.memory["alias_size_in_bytes"] == \
        trace.memory["argument_size_in_bytes"] - sum(
            v.numel() * v.element_size()
            for v in input_specs(cfg, TRAIN).values())
    assert trace.memory["peak_size_in_bytes"] > \
        trace.memory["argument_size_in_bytes"]
    assert trace.bytes_accessed > 0 and trace.collectives["total_bytes"] == 0


def test_torch_chunked_attention_counts_the_full_softmax_at_whole_blocks():
    """Where the keys are a multiple of the 512-key block, the meta
    device's attention counts what the full softmax counts."""
    q, k, v = torch.rand(2, 512, 4, 16), torch.rand(2, 512, 2, 16), \
        torch.rand(2, 512, 2, 16)
    assert _swap([("attention", [(tuple(t.shape), t.dtype) for t in
                                 (q, k, v)], {"causal": True})]) == 0


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_torch_full_depth_is_c1_plus_periods_times_c2_less_c1(arch):
    cfg = _cfg(arch)
    c1 = _traced(reduced_depth(cfg, 1)[0])
    c2 = _traced(reduced_depth(cfg, 2)[0])
    n = reduced_depth(cfg, 1)[1]
    full = _traced(cfg)
    assert n > 1
    for key in ("flops", "bytes_accessed"):
        a, b, c = (getattr(t, key) for t in (c1, c2, full))
        assert c == a + (n - 1) * (b - a), key


@pytest.mark.parametrize("seq,batch,pads", [(16, 2, False), (13, 1, True)])
def test_torch_traced_moe_counts_the_reference_cost_mode(seq, batch, pads,
                                                         monkeypatch):
    """A MoE prefill traced on meta counts the reference's cost-mode
    expert products, ``3 x 2 x E ceil(T k / E) x D x F`` a layer, where a
    real CPU prefill counts the dropless ``3 x 2 x T k x D x F`` (and the
    chunked attention's swap)."""
    cfg = _cfg("mixtral-8x7b")
    shape = ShapeConfig("p", seq, batch, "prefill")
    trace = _traced(cfg, shape)
    calls = _recorded(monkeypatch)
    m = build_model(cfg, device="cpu")
    m.init(0)
    step = make_prefill_step(m, max_len=seq, backend="torch")
    batch = make_concrete(input_specs(cfg, shape), cfg, seed=0)
    with torch.no_grad():
        real = _flops(step, batch)
    mo = cfg.moe
    Tk = shape.global_batch * seq * mo.num_experts_per_tok
    E = mo.num_experts
    padded = E * -(-Tk // E)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert n_moe > 0
    assert trace.flops == real + _swap(calls) + n_moe * 6 * \
        (padded - Tk) * cfg.d_model * mo.d_ff_expert
    assert (padded > Tk) == pads


# ---------------------------------------------------------------------------
# the production meshes, over a fake process group (a subprocess a size)
# ---------------------------------------------------------------------------


# the cells a process traces: Jamba's (its chunked Mamba scan is most
# of the time on meta) apart from the rest
GROUPS = {"jamba": ["jamba-v0.1-52b"],
          "rest": [a for a in configs.ARCH_IDS if a != "jamba-v0.1-52b"]}


def _cells(mesh_name, group, out):
    """A group's smoke ``train_4k`` cells on one mesh (this file run as a
    script: the process's fake group of the mesh's size and the smoke
    widths, through ``run_cell``'s own lookup, stay in it); the rest also
    ``long_500k`` and ``seqkv``."""
    from repro_torch.launch import dryrun
    dryrun.get_model_config = \
        lambda arch: configs.get_model_config(arch, smoke=True)
    dryrun.fake_group(dryrun.MESH_WORLD[mesh_name])
    multi = mesh_name == "multi"
    res = {a: dryrun.run_cell(a, "train_4k", multi_pod=multi, save=False)
           for a in GROUPS[group]}
    if group == "rest":
        # each beside the same decode without the seq rule
        res["long_500k"] = dryrun.run_cell("mixtral-8x7b", "long_500k",
                                           multi_pod=multi, save=False)
        res["long_500k_plain"] = dryrun.run_cell(
            "mixtral-8x7b", "decode_32k", multi_pod=multi, save=False)
        res["seqkv"] = dryrun.run_cell("qwen2-7b", "decode_32k",
                                       multi_pod=multi, variant="seqkv",
                                       save=False)
        res["seqkv_plain"] = dryrun.run_cell("qwen2-7b", "decode_32k",
                                             multi_pod=multi, save=False)
        # the seqkv variant's train and prefill cells: their logits'
        # spec maps model twice, as the reference's does
        for shape in ("train_4k", "prefill_32k"):
            res[f"seqkv_{shape}"] = dryrun.run_cell(
                "qwen2-7b", shape, multi_pod=multi, variant="seqkv",
                save=False)
    pathlib.Path(out).write_text(json.dumps(res, default=str))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "1"}
    procs = {(m, g): subprocess.Popen(
        [sys.executable, __file__, m, g, str(tmp / f"{m}_{g}.json")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for m in ("single", "multi") for g in GROUPS}
    res = {"single": {}, "multi": {}}
    for (m, g), p in procs.items():
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
        res[m].update(json.loads((tmp / f"{m}_{g}.json").read_text()))
    return res


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_torch_every_smoke_train_cell_is_ok(cells, mesh, arch):
    r = cells[mesh][arch]
    assert r["ok"], r.get("traceback")
    assert r["chips"] == (256 if mesh == "single" else 512)
    t = r["roofline"]
    assert t["flops_per_device"] > 0 and t["bytes_per_device"] > 0
    assert t["dominant"] in ("compute", "memory", "collective")
    coll = r["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes_by_op"].values()) > 0
    assert coll["counts"]["all_reduce"] > 0
    mem = r["memory_analysis"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert r["model_flops_global"] > 0 and r["useful_flops_ratio"] > 0


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("cell", ["long_500k", "seqkv"])
def test_torch_long_500k_and_seqkv_are_ok(cells, mesh, cell):
    """The smoke Mixtral's ``long_500k`` (its 64-slot window cut into 4
    slots a rank over ``data``) and the smoke Qwen2's ``decode_32k`` under
    ``seqkv`` (32,768 slots cut over ``model``) trace: the same decode's
    collectives as without the rule, plus the merge's two all-reduces
    (a max and a sum) in each of the 2 layers; both smoke models' 4 heads
    run whole at ``model 16``, so no ``q`` is gathered."""
    r, plain = cells[mesh][cell], cells[mesh][cell + "_plain"]
    assert r["ok"], r.get("traceback")
    assert plain["ok"], plain.get("traceback")
    counts, want = r["collectives"]["counts"], plain["collectives"]["counts"]
    assert counts["all_reduce"] == want["all_reduce"] + 2 * 2
    assert counts.get("all_gather", 0) == want.get("all_gather", 0)
    by_op = r["collectives"]["bytes_by_op"]
    assert by_op["all-reduce"] > 0
    assert r["roofline"]["flops_per_device"] > 0


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_torch_seqkv_train_and_prefill_cells_fail_as_the_reference(
        cells, mesh, shape):
    """Under ``seq -> model`` the smoke Qwen2's logits ``(batch, seq,
    vocab)`` would map ``model`` twice (its 512-column padded vocabulary
    and the sequence both divide by 16): the cell records ``ok: false``
    with the ``ValueError``, as the reference's records its
    ``DuplicateSpecError``; it is not refused."""
    r = cells[mesh][f"seqkv_{shape}"]
    assert not r["ok"]
    assert r["error"].startswith("ValueError:"), r["error"]
    assert "'model'" in r["error"], r["error"]


if __name__ == "__main__":
    _cells(sys.argv[1], sys.argv[2], sys.argv[3])
