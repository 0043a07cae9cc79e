"""The port stands alone: it imports ``torch`` and ``numpy``, never ``jax``,
nothing of the JAX package ``repro`` and not ``ml_dtypes`` (which comes
with JAX); its entry points run on the card
unless the caller asks for the CPU by name."""
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
    r"|from\s+repro(\.|\s)|import\s+ml_dtypes\b|from\s+ml_dtypes\b)",
    re.M)


def test_torch_port_has_the_expected_files():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("src/repro_torch/__init__.py",
                 "src/repro_torch/_nvcc.py",
                 "src/repro_torch/_device.py",
                 "src/repro_torch/fabric/backend/torch_kernels.py",
                 "src/repro_torch/fabric/backend/cuda_kernels.py",
                 "src/repro_torch/fabric/backend/torch_engine.py",
                 "src/repro_torch/fabric/scenario/library.py",
                 "src/repro_torch/fabric/simulator.py",
                 "src/repro_torch/fabric/_reference.py",
                 "src/repro_torch/fabric/trace.py",
                 "src/repro_torch/fabric/advisor.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/qwen2_7b.py",
                 "src/repro_torch/core/coordination.py",
                 "src/repro_torch/core/diagnostics.py",
                 "src/repro_torch/kernels/ref.py",
                 "src/repro_torch/kernels/chunked.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/kernels/rmsnorm.py",
                 "src/repro_torch/kernels/wkv6.py",
                 "src/repro_torch/kernels/mamba_scan.py",
                 "src/repro_torch/kernels/cuda_kernels.py",
                 "src/repro_torch/kernels/ops.py",
                 "src/repro_torch/models/params.py",
                 "src/repro_torch/models/rope.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/mlp.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/models/api.py",
                 "src/repro_torch/models/convert.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/sharding.py",
                 "src/repro_torch/launch/compressed.py",
                 "src/repro_torch/launch/step_trace.py",
                 "src/repro_torch/launch/roofline.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/dryrun_variants.py",
                 "src/repro_torch/ckpt/checkpoint.py",
                 "src/repro_torch/optim/compress.py",
                 "src/repro_torch/optim/__init__.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/data/__init__.py",
                 "src/repro_torch/data/pipeline.py",
                 "chip_smoke.py"):
        assert want in names
    for cu in ("fabric_kernels.cu", "model_kernels.cu"):
        assert (ROOT / "src/repro_torch/csrc" / cu).exists()


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_torch_port_sources_import_no_jax_and_no_repro(path):
    hit = FORBIDDEN.search(path.read_text())
    assert hit is None, f"{path}: {hit.group(0).strip()!r}"


def test_torch_port_cuda_source_keeps_its_build_contract():
    from repro_torch.fabric.backend import cuda_kernels as CK
    assert "-fmad=false" in CK.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in CK.NVCC_FLAGS
    assert not any("fast_math" in f for f in CK.NVCC_FLAGS)
    src = CK.SOURCE.read_text()
    assert f"#define MAX_FLOWS {CK.MAX_FLOWS}" in src
    for fn in ("fabric_waterfill", "fabric_strict_priority",
               "fabric_segment_overlap"):
        assert f"int {fn}_f32(" in src and f"int {fn}_f64(" in src
    from repro_torch import _nvcc
    assert _nvcc.build_dir().relative_to(ROOT).as_posix() == \
        "build/repro_torch"
    assert CK.LIBRARY.flags == CK.NVCC_FLAGS
    assert CK.LIBRARY.path().name.startswith("libfabric_kernels_")
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_torch_nvcc_build_keeps_its_ptxas_report_for_a_cached_library(
        tmp_path, monkeypatch):
    """A library built earlier (another process, another run) is loaded
    without a compile and still has the register report of its build; a
    failed build raises with the compiler's output."""
    from repro_torch import _nvcc
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        open({str(calls)!r}, "a").write("x")
        if "FAIL" in open(sys.argv[-1]).read():
            print("error: bad source", file=sys.stderr)
            sys.exit(2)
        assert sys.argv[sys.argv.index("-Xptxas") + 1] == "-v"
        open(sys.argv[sys.argv.index("-o") + 1], "wb").write(b"so")
        print("ptxas info    : Compiling entry function 'k' for 'sm_90a'",
              file=sys.stderr)
        print("ptxas info    : Used 40 registers", file=sys.stderr)
    """))
    fake.chmod(0o755)
    monkeypatch.setattr(_nvcc, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_nvcc, "build_dir", lambda: tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("__global__ void k() {}\n")
    first = _nvcc.NvccLibrary(src, ("-O3",), "k")
    path = first.build()
    assert path.read_bytes() == b"so" and "Used 40 registers" in \
        first.ptxas_log
    assert first.report_path().read_text() == first.ptxas_log
    again = _nvcc.NvccLibrary(src, ("-O3",), "k")    # as a later run would
    assert again.build() == path and again.ptxas_log == first.ptxas_log
    assert calls.read_text() == "x"                   # one compile in all
    first.report_path().unlink()                      # built without one
    assert again.build() == path and again.ptxas_log is None
    src.write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="error: bad source"):
        _nvcc.NvccLibrary(src, ("-O3",), "k").build()


def test_torch_port_runs_in_a_process_without_jax_or_repro():
    code = textwrap.dedent("""
        import sys
        import torch
        import repro_torch
        from repro_torch.fabric import JobSpec
        from repro_torch.fabric.scenario import (Scenario, ScenarioGrid,
                                                 TopologySpec)
        from repro_torch.fabric.backend import available_backends
        base = Scenario(name="g",
                        topology=TopologySpec(n_nodes=32, nodes_per_leaf=8),
                        jobs=[JobSpec("a", 8, placement="scattered"),
                              JobSpec("b", 8, placement="scattered")],
                        iters=10, warmup=2)
        grid = ScenarioGrid(base, {"congestion": [None],
                                   "base_seed": [0, 1, 2]})
        out = grid.run(backend="torch", device="cpu")
        assert len(out) == 3 and all(len(r.series("a")) == 8 for _, r in out)
        ref = base.run(backend="reference")
        assert ref.fingerprint()["jobs"][0]["name"] == "a"
        available_backends("maxmin_shares")       # loads every backend module
        from repro_torch.fabric import advisor, simulator, trace
        from repro_torch.fabric import _reference
        from repro_torch.fabric.scenario import library
        from repro_torch.launch import (compressed, dryrun, dryrun_variants,
                                        roofline, step_trace)
        fit = trace.fit_trace(trace.load_trace("tests/traces/"
                                               "steady_trainers.json"))
        recs = advisor.advise(library.build("synchronization_amplification"),
                              backend="reference", verify=False)
        assert fit.scenario.policies.backend == "cuda" and recs
        sim = simulator.SimConfig.fast(8)
        assert simulator.simulate(sim).step_times == \
            _reference.simulate_reference(sim).step_times
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "jaxlib" or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        print("CLEAN", len(out))
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(ROOT), timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("CLEAN 3")


# -- devices -----------------------------------------------------------------


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a CUDA device")


def _scenario():
    from repro_torch.fabric import JobSpec
    from repro_torch.fabric.scenario import Scenario, TopologySpec
    return Scenario(name="d",
                    topology=TopologySpec(n_nodes=32, nodes_per_leaf=8),
                    jobs=[JobSpec("a", 8), JobSpec("b", 8)],
                    iters=8, warmup=2)


def test_torch_bare_run_goes_to_the_card_and_raises_without_one(
        no_card, monkeypatch):
    """With nothing asked for, ``Scenario.run()`` and
    ``ScenarioGrid.run()`` resolve to ``backend="cuda"`` on the card:
    without one they raise, and neither the Python engine nor the batched
    loop runs on the host instead."""
    from repro_torch.fabric.backend import torch_engine as TE
    from repro_torch.fabric.scenario import Policies, Scenario, ScenarioGrid

    def ran(*a, **kw):
        raise AssertionError("ran on the host")

    monkeypatch.setattr(Scenario, "_run_reference", ran)
    monkeypatch.setattr(TE, "run_loaded", ran)
    scn = _scenario()
    assert scn.policies == Policies() and scn.policies.backend == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        scn.run()
    grid = ScenarioGrid(scn, {"base_seed": [0, 1]})
    with pytest.raises(RuntimeError, match="pass device='cpu' explicitly"):
        grid.run()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        grid.to_csv()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_torch_default_device_is_the_card_and_raises_without_one(
        no_card, backend):
    from repro_torch.fabric.scenario import ScenarioGrid
    scn = _scenario()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        scn.run(backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        scn.run(backend=backend, device="cuda")
    grid = ScenarioGrid(scn, {"base_seed": [0, 1]})
    with pytest.raises(RuntimeError, match="pass device='cpu' explicitly"):
        grid.run(backend=backend)


def test_torch_kernels_place_arrays_on_the_card_by_default(no_card):
    from repro_torch.fabric.backend import torch_kernels as TK
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        TK.maxmin_shares([0.2, 0.9])
    assert TK.maxmin_shares([0.2, 0.9], device="cpu").tolist() == \
        pytest.approx([0.2, 0.8])


def test_torch_cuda_backend_refuses_the_cpu():
    from repro_torch.fabric.backend import BackendError
    with pytest.raises(BackendError, match="backend='cuda' runs on a CUDA "
                                           "device, got device='cpu'"):
        _scenario().run(backend="cuda", device="cpu")


@pytest.mark.parametrize("name", ["maxmin_shares", "wfq_shares",
                                  "strict_priority_shares",
                                  "segment_overlap"])
def test_torch_cuda_wrappers_raise_on_cpu_tensors(name):
    """No quiet fallback: a CPU tensor is an error, and nothing was
    launched or built."""
    from repro_torch.fabric.backend import cuda_kernels as CK, get_kernel
    fn = get_kernel(name, "cuda")
    d = torch.rand(6, 4, dtype=torch.float64)
    args = {"maxmin_shares": (d,), "wfq_shares": (d, torch.ones(4).double()),
            "strict_priority_shares": (d, [2, 1, 0, 0]),
            "segment_overlap": (d[:, 0], d[:, 1] + 1.0, d, d + 0.5)}[name]
    before = CK.launch_counts()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fn(*args)
    with pytest.raises(ValueError):
        fn(*[a.tolist() if isinstance(a, torch.Tensor) else a for a in args])
    assert CK.launch_counts() == before
    assert set(before) == {"maxmin_shares", "wfq_shares",
                           "strict_priority_shares", "segment_overlap"}


def test_torch_cuda_wrapper_layout_of_grouped_operands():
    """The host-side layout logic behind the kernels' ``row // rows_per``
    indexing: (aligned shape, rows per vector, needs expanding)."""
    from repro_torch.fabric.backend.cuda_kernels import _group_layout

    def grouped(shape, batch=(5, 9), tail=(4,)):
        return _group_layout(shape, batch, tail)

    assert grouped((5, 1, 4)) == ((5, 1, 4), 9, False)     # per variant
    assert grouped((4,)) == ((1, 1, 4), 45, False)         # one vector
    assert grouped((5, 9, 4)) == ((5, 9, 4), 1, False)     # per row
    assert grouped((1, 9, 4)) == ((1, 9, 4), 1, True)      # must expand
    assert grouped((5, 1), tail=()) == ((5, 1), 9, False)  # overlap window
    assert grouped((5, 9), tail=()) == ((5, 9), 1, False)
    for bad in ((5, 9, 3), (2, 9, 4), (5, 9, 4, 4)):
        with pytest.raises(ValueError, match="does not broadcast"):
            grouped(bad)
