"""The dry run's analytic half, held against the JAX package on the CPU.

Held exactly, for all ten configurations x the four shapes:
``active_param_count``, ``model_memory_bytes`` (at the production meshes'
sizes, ZeRO-1 on and off), ``model_flops``, ``reduced_depth`` (k = 1, 2)
and ``apply_variant_pure`` (every variant part); the input specs' shapes
and dtypes (int32 tokens, positions and lengths, float32 embeddings, as
the reference's). Also: ``RooflineTerms``' arithmetic at the H100's
constants, the ``REPRO_NORM_BF16`` branch of ``_norm`` against the
reference's (1e-6, float32), the cache specs by leaf name, and
``axis_rules`` refusing an override the port's layers do not carry out
(``NotImplementedError`` naming its ``ROADMAP.md`` item) while taking the
ones they do.

The reference's ``repro.launch.dryrun`` sets a 512-device ``XLA_FLAGS``
when imported, so its ``reduced_depth`` runs in a subprocess.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import dryrun_variants as jvariants
from repro.launch import roofline as jroof
from repro.models import api as japi
from repro.models import transformer as jtfm

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun_variants as tvariants
from repro_torch.launch import roofline as troof
from repro_torch.launch import sharding as shd
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tfm

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = tconfigs.ARCH_IDS
SHAPES = [s.name for s in tconfigs.SHAPES]
MESHES = {"single": dict(chips=256, dp=16, tp=16),
          "multi": dict(chips=512, dp=32, tp=16)}


def _cfgs(arch):
    return jconfigs.get_model_config(arch), tconfigs.get_model_config(arch)


def _shapes(name):
    return jconfigs.SHAPES_BY_NAME[name], tconfigs.SHAPES_BY_NAME[name]


def stand_in(shape, axes):
    """Anything with an ordered ``shape`` mapping stands for a mesh."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def test_torch_roofline_has_the_h100_constants():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    from repro_torch.launch.mesh import COLLECTIVE_OPS
    assert COLLECTIVE_OPS == jroof.COLLECTIVE_OPS


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_active_param_count_matches_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    assert troof.active_param_count(tcfg) == jroof.active_param_count(jcfg)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_model_flops_and_memory_match_the_reference(arch, shape):
    jcfg, tcfg = _cfgs(arch)
    js, ts = _shapes(shape)
    assert troof.model_flops(tcfg, ts) == jroof.model_flops(jcfg, js)
    for mesh in MESHES.values():
        for zero1 in (True, False):
            assert troof.model_memory_bytes(tcfg, ts, zero1=zero1, **mesh) \
                == jroof.model_memory_bytes(jcfg, js, zero1=zero1, **mesh)
    B = ts.global_batch // MESHES["single"]["dp"] or 1
    assert troof._cache_bytes(tcfg, B, ts.seq_len) == \
        jroof._cache_bytes(jcfg, B, js.seq_len)


VARIANTS = ["", "opt", "mb4", "lc1024", "int8pod", "noz1", "seqkv", "nf32",
            "nr", "bf16tp", "opt+mb2+int8pod", "lc512+nf32+nr"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_torch_apply_variant_matches_the_reference(variant):
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jc, *jrest = jvariants.apply_variant_pure(jcfg, variant)
        tc, *trest = tvariants.apply_variant_pure(tcfg, variant)
        assert trest == jrest
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    with pytest.raises(ValueError, match="unknown variant part"):
        tvariants.apply_variant_pure(tcfg, "bogus")


def _reference_depths(out):
    """The reference's ``reduced_depth`` for every configuration (this
    file run as a script, so its dryrun module's ``XLA_FLAGS`` stay in
    that process)."""
    from repro.launch.dryrun import reduced_depth
    res = {}
    for arch in jconfigs.ARCH_IDS:
        cfg = jconfigs.get_model_config(arch)
        for k in (1, 2):
            c, n = reduced_depth(cfg, k)
            res[f"{arch}/{k}"] = [c.num_layers, c.num_encoder_layers,
                                  c.scan_layers, n]
    pathlib.Path(out).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def reference_depths(tmp_path_factory):
    out = tmp_path_factory.mktemp("depth") / "depths.json"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_reduced_depth_matches_the_reference(reference_depths, arch):
    from repro_torch.launch.dryrun import reduced_depth
    cfg = tconfigs.get_model_config(arch)
    for k in (1, 2):
        c, n = reduced_depth(cfg, k)
        assert [c.num_layers, c.num_encoder_layers, c.scan_layers, n] == \
            reference_depths[f"{arch}/{k}"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_input_specs_match_the_reference(arch, shape):
    jcfg, tcfg = _cfgs(arch)
    js, ts = _shapes(shape)
    want = japi.input_specs(jcfg, js)
    got = tapi.input_specs(tcfg, ts)
    assert list(got) == list(want)
    for k, s in want.items():
        assert got[k].is_meta and tuple(got[k].shape) == tuple(s.shape), k
        assert str(got[k].dtype).split(".")[-1] == jnp.dtype(s.dtype).name


def test_torch_make_concrete_draws_seeded_inputs():
    cfg = tconfigs.get_model_config("qwen2-vl-2b", smoke=True)
    shape = tconfigs.ShapeConfig("t", 16, 2, "train")
    specs = tapi.input_specs(cfg, shape)
    a = tapi.make_concrete(specs, cfg, seed=3)
    b = tapi.make_concrete(specs, cfg, seed=3)
    for k, s in specs.items():
        assert a[k].device.type == "cpu" and a[k].shape == s.shape
        assert a[k].dtype == s.dtype and torch.equal(a[k], b[k]), k
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < cfg.vocab_size
    assert torch.equal(a["mrope_positions"][2, 1], torch.arange(16,
                                                                dtype=I32))
    dec = tapi.make_concrete(tapi.input_specs(
        cfg, tconfigs.ShapeConfig("d", 16, 2, "decode")), cfg)
    assert int(dec["pos"]) == 0 and torch.equal(dec["kv_len"],
                                                torch.ones(2, dtype=I32))


I32 = torch.int32


def test_torch_roofline_terms_arithmetic():
    t = troof.RooflineTerms(flops_per_device=989e12 * 2,
                            bytes_per_device=3.35e12 * 3,
                            collective_bytes_per_device=50e9 * 0.5,
                            chips=256)
    d = t.to_dict()
    assert d["compute_s"] == pytest.approx(2.0, rel=1e-15)
    assert d["memory_s"] == pytest.approx(3.0, rel=1e-15)
    assert d["collective_s"] == pytest.approx(0.5, rel=1e-15)
    assert d["dominant"] == "memory" and d["chips"] == 256
    tr = types.SimpleNamespace(flops=1.0, bytes_accessed=2.0, collectives={
        "total_bytes": 7, "bytes_by_op": {}, "counts": {}})
    terms, coll = troof.extract_terms(tr, chips=4)
    assert (terms.flops_per_device, terms.bytes_per_device,
            terms.collective_bytes_per_device, terms.chips) == (1.0, 2.0,
                                                                7.0, 4)
    assert coll is tr.collectives
    jt = jroof.RooflineTerms(1.0, 2.0, 7.0, 4)
    assert jt.compute_s * jroof.PEAK_FLOPS == terms.compute_s * \
        troof.PEAK_FLOPS


@pytest.mark.parametrize("bias", [False, True])
def test_torch_norm_bf16_branch_matches_the_reference(monkeypatch, bias):
    """``REPRO_NORM_BF16``: the statistics in the activation dtype (here
    float32, 1e-6), RMSNorm and LayerNorm, on both kernel backends'
    plain path."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    tp = torch.nn.ParameterDict({"scale": torch.nn.Parameter(
        torch.from_numpy(scale))})
    if bias:
        jp["bias"] = jnp.asarray(b)
        tp["bias"] = torch.nn.Parameter(torch.from_numpy(b))
    monkeypatch.setenv("REPRO_NORM_BF16", "1")
    want = np.asarray(jtfm._norm(jp, jnp.asarray(x), 1e-5))
    got = tfm._norm(tp, torch.from_numpy(x), 1e-5, backend="torch")
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    monkeypatch.delenv("REPRO_NORM_BF16")
    plain = tfm._norm(tp, torch.from_numpy(x), 1e-5, backend="torch")
    assert plain.shape == got.shape


def test_torch_cache_spec_follows_the_reference_rule():
    from repro_torch.models.api import build_model
    cfg = tconfigs.get_model_config("jamba-v0.1-52b", smoke=True)
    m = build_model(cfg, device="cpu")
    cache = m.abstract_cache(32, 64)
    with shd.axis_rules(stand_in((16, 16), ("data", "model"))):
        spec = m.cache_spec(cache)
    kinds = {n: s for layer in spec for part in layer.values()
             for n, s in part.items()}
    assert kinds["k"] == ("data", None, None, None)
    assert kinds["h"] == ("data", "model", None)
    assert kinds["conv"][0] == "data"
    assert all(t.is_meta for layer in cache for part in layer.values()
               for t in part.values())


# ---------------------------------------------------------------------------
# axis_rules refuses what the layers do not carry out
# ---------------------------------------------------------------------------

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))

REFUSED = [
    ({"heads": None}, "item 14.3"),
    ({"heads": "data"}, "item 14.3"),
    ({"kv_heads": "data"}, "item 14.3"),
    ({"ff": ("data", "model")}, "item 14.3"),
    ({"vocab": None}, "item 14.3"),
    ({"embed": "model"}, "item 14.3"),
    ({"batch": ("data",)}, "item 14.3"),       # drops pod on MULTI
    ({"ddp": ("data",)}, "item 14.3"),
    ({"state": "model"}, "item 14.3"),
]


@pytest.mark.parametrize("rules,item", REFUSED, ids=lambda v: str(v))
def test_torch_axis_rules_refuse_an_override_the_layers_ignore(rules, item):
    """On the tree before this check, every one of these was merged into
    the rules and silently ignored by the layers."""
    with pytest.raises(NotImplementedError, match=item):
        with shd.axis_rules(stand_in(*MULTI), rules):
            pass
    assert shd.active_mesh() is None


HONORED = [
    (SINGLE, {"batch": ("data",)}),            # pod is absent
    (SINGLE, {"batch": ("pod", "data"), "ddp": ("pod", "data")}),
    (MULTI, {"heads": "model", "kv_heads": "model", "ff": "model",
             "vocab": "model", "model": "model"}),
    (MULTI, {"seq": None, "expert": None, "embed": None, "state": None}),
    (MULTI, {"unknown": None}),
    (MULTI, None),
    (MULTI, {}),
    # context-parallel decode (the long_500k cells, the seqkv variant)
    (MULTI, {"seq": "data"}),
    (MULTI, {"seq": "model"}),
    # the reference reads no expert rule: it changes nothing
    (MULTI, {"expert": "model"}),
    (MULTI, {"expert": ("data",)}),
]


@pytest.mark.parametrize("mesh,rules", HONORED, ids=lambda v: str(v))
def test_torch_axis_rules_take_the_overrides_the_layers_honor(mesh, rules):
    with shd.axis_rules(stand_in(*mesh), rules):
        assert shd.resolve_spec((64, 32), ("heads", "embed")) == \
            ("model", None)
    if rules and "expert" in rules:
        # the parameters' specs are those of the default rules
        cfg = tconfigs.get_model_config("mixtral-8x7b")
        assert _spec_under(cfg, stand_in(*mesh), rules) == \
            _spec_under(cfg, stand_in(*mesh), None)


def _spec_under(cfg, mesh, rules):
    """``transformer.param_spec`` on the whole leaves under ``rules``."""
    from repro_torch.models import transformer as tfm
    with torch.device("meta"):
        named = dict(tfm.init_params(cfg, torch.Generator(),
                                     device="meta").named_parameters())
    with shd.axis_rules(mesh, rules):
        return tfm.param_spec(named, cfg)


def test_torch_decode_takes_the_seq_rules_and_prefill_and_train_refuse_them():
    """The ``long_500k`` and ``seqkv`` rules bind; a decode step's one
    position is not cut. A prefill's and a train step's sequence is
    resolved as the reference's logits constraint resolves it
    (``sharding.activation_axes``): under ``seq -> data`` cut over
    ``data`` where the batch falls back, and where the batch and the
    sequence both map to ``data``, the spec's ``ValueError``; under
    ``seq -> model`` the sequence and the vocabulary both map to
    ``model``: ``ValueError`` (the reference's ``DuplicateSpecError``),
    the only refusal left; where the vocabulary falls back (``V + 8``)
    or there is none (the encoder) the sequence is cut over ``model``,
    as the reference cuts it."""
    from repro_torch.launch.dryrun import apply_variant, cell_rules
    assert cell_rules("long_500k") == {"seq": "data"}
    assert cell_rules("train_4k") is None
    *_, rules, _ = apply_variant(tconfigs.get_model_config("qwen2-7b"),
                                 "seqkv")
    assert rules == {"seq": "model"}
    V = tconfigs.get_model_config("qwen2-7b").padded_vocab()
    for r in (cell_rules("long_500k"), rules):
        with shd.axis_rules(stand_in(*SINGLE), r):
            assert shd.activation_axes(1, 1, V) is None      # decode
            assert shd.activation_axes(128, 1, V) is None
            for B, S in ((1, 524288), (32, 32768), (256, 4096)):
                if r["seq"] == "data" and B % 16 == 0:
                    with pytest.raises(ValueError, match="'data'"):
                        shd.activation_axes(B, S, V)
                elif r["seq"] == "data":
                    assert shd.activation_axes(B, S, V) == ("data",)
                    assert shd.activation_axes(B, S) == ("data",)
                else:
                    with pytest.raises(ValueError, match="'model'"):
                        shd.activation_axes(B, S, V)
                    for vocab in (V + 8, None):
                        assert shd.activation_axes(B, S, vocab) == \
                            ("model",)


if __name__ == "__main__":
    _reference_depths(sys.argv[1])
