"""The kernel names that ``chip_smoke.py`` reads, and K4's dtype rule,
checked without a card.

``chip_smoke.py`` reads the profiler's device time by kernel symbol
(``KERNEL_SYMBOLS`` for the served models, the last-but-one argument of
each ``entry`` call in its kernel tables): a symbol that no kernel has
quietly reads ``None`` or 0. So every such symbol must be a ``__global__``
function of the port's CUDA sources. K4's wrapper picks its kernel by a
rule on dtypes, pointers and strides alone, so the rule runs here on CPU
tensors.
"""
import ast
import importlib.util
import pathlib
import re

import pytest
import torch

from repro_torch.kernels import flash_attention as FA

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _load_chip_smoke()


def _global_functions():
    names = set()
    for src in ("model_kernels.cu", "fabric_kernels.cu"):
        text = (CSRC / src).read_text()
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
            text))
    return names


def _profiled_symbols():
    """Every string the symbol argument (the eighth, or ``symbol=``) of an
    ``entry(...)`` call in the kernel tables of ``chip_smoke.py`` can
    take."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    out = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name in (
                "kernel_table", "model_kernel_table"):
            for call in ast.walk(fn):
                if isinstance(call, ast.Call) and \
                        getattr(call.func, "id", None) == "entry":
                    kw = {k.arg: k.value for k in call.keywords}
                    sym = call.args[7] if len(call.args) > 7 else \
                        kw["symbol"]
                    out |= _values(sym)
    return out


def _values(node):
    """The strings a constant or a conditional of constants can take."""
    if isinstance(node, ast.IfExp):
        return _values(node.body) | _values(node.orelse)
    assert isinstance(node, ast.Constant), ast.dump(node)
    return {node.value}


def test_torch_kernel_symbols_sources_have_the_kernels():
    names = _global_functions()
    assert {"flash_fwd_kernel", "flash_fwd_wgmma_kernel",
            "rmsnorm_warp_kernel", "wkv6_fwd_kernel",
            "mamba_scan_fwd_kernel"} <= names
    # the PR 12 RMSNorm kernel is gone: nothing may still profile it
    assert "rmsnorm_kernel" not in names


@pytest.mark.parametrize("key", sorted(SMOKE.KERNEL_SYMBOLS))
def test_torch_kernel_symbols_served_kernels_exist(key):
    syms = SMOKE.KERNEL_SYMBOLS[key]
    assert syms and all(s in _global_functions() for s in syms), syms


def test_torch_kernel_symbols_profiled_kernels_exist():
    syms = _profiled_symbols()
    # K1, K2, K3; K4 and K5 at the served (bfloat16) shapes, K6, K7
    assert syms == {"waterfill_kernel", "strict_priority_kernel",
                    "segment_overlap_kernel", "flash_fwd_wgmma_kernel",
                    "rmsnorm_warp_kernel", "wkv6_fwd_kernel",
                    "mamba_scan_fwd_kernel"}
    assert syms <= _global_functions()
    assert set(SMOKE.HOPPER_KERNELS) <= _global_functions()


def test_torch_kernel_symbols_diagnostic_path_profiles_k1_to_k3():
    """The diagnostic phase counts K1-K3 by the profiler under these
    names, and by the wrappers' counts under these keys."""
    syms = {sym for _, sym in SMOKE.DIAG_KERNELS.values()}
    assert syms == {"waterfill_kernel", "strict_priority_kernel",
                    "segment_overlap_kernel"}
    assert syms <= _global_functions()
    from repro_torch.fabric.backend import cuda_kernels as CK
    keys = {k for names, _ in SMOKE.DIAG_KERNELS.values() for k in names}
    assert keys == set(CK.launch_counts())


def test_torch_kernel_symbols_redesigned_kernels_are_reported():
    """The kernels redesigned for Hopper (K4 and K5, then K3 and K6, then
    K1 and K2, then K7) get their registers, spills, stack frame, ptxas
    notes and SASS opcode counts in the build lines; K3's and K7's checks
    read their cp.async copies (LDGSTS), MUFU counts K7's exponentials,
    and local-memory loads and stores (LDL, STL) show a row or a state
    that left the registers."""
    assert {"flash_fwd_wgmma_kernel", "rmsnorm_warp_kernel",
            "segment_overlap_kernel", "wkv6_fwd_kernel", "waterfill_kernel",
            "strict_priority_kernel",
            "mamba_scan_fwd_kernel"} == set(SMOKE.HOPPER_KERNELS)
    assert {"HGMMA", "UTMALDG", "SYNCS", "LDGSTS", "SHFL", "MUFU", "LDL",
            "STL"} <= set(SMOKE.SASS_OPCODES)
    model = (CSRC / "model_kernels.cu").read_text()
    assert "cp.async" in model and "mamba_scan_fwd_kernel" in model
    fabric = (CSRC / "fabric_kernels.cu").read_text()
    assert "cp.async" in fabric and "segment_overlap_kernel" in fabric
    # the launch floor chip_smoke.py profiles beside K1 and K2
    assert "launch_floor_kernel" in _global_functions()


# the mangled names of the allocator instantiations: N flows, float or
# double, and for K1 the unit-weight flag
def _waterfill(t, n, unit):
    return f"_Z16waterfill_kernelI{t}Li{n}ELb{int(unit)}EEvPKT_S2_S2_S0_" \
        f"PS0_xixb"


def _strict(t, n):
    return f"_Z22strict_priority_kernelI{t}Li{n}EEvPKT_10ClassMasksS2_S0_" \
        f"PS0_xib"


@pytest.mark.parametrize("t", ["f", "d"])
def test_torch_kernel_symbols_main_path_allocators_are_picked(t):
    """The build line's stack-frame check covers the instantiations the
    main path launches (4 flows, both dtypes, maxmin, wfq and strict
    priority) and no other."""
    pick = SMOKE.MAIN_PATH_ALLOCATORS.search
    assert pick(_waterfill(t, 4, True)) and pick(_waterfill(t, 4, False))
    assert pick(_strict(t, 4))
    for n in (0, 1, 3, 5, 8):
        assert not pick(_waterfill(t, n, True)) and not pick(_strict(t, n))
    assert not pick("_Z22segment_overlap_kernelIfLb1EEvPKT_")


def test_torch_kernel_symbols_main_path_scans_are_picked():
    """The build line's stack-frame check of K7 covers its N = 16
    instantiations (Jamba's d_state), both dtypes, and not N = 8."""
    pick = SMOKE.MAIN_PATH_SCANS.search
    tail = "EvPKT_S2_PKfS2_S2_S4_S4_PS0_Pfiixxxxxxxxii"
    for t in ("f", "13__nv_bfloat16"):
        assert pick(f"_Z21mamba_scan_fwd_kernelI{t}Li16E{tail}")
        assert not pick(f"_Z21mamba_scan_fwd_kernelI{t}Li8E{tail}")
    assert not pick("_Z15wkv6_fwd_kernelIfLi16EEvPKT_")


def test_torch_kernel_symbols_k7_cases_sit_at_its_chunk_edges():
    """``chip_smoke.MAMBA_CASES`` (which the card's tests also run) hold
    K7 at S = chunk - 1, chunk and chunk + 1 for the chunk the kernel is
    built with, and at S 1."""
    model = (CSRC / "model_kernels.cu").read_text()
    chunk = int(re.search(r"constexpr int MAMBA_T = (\d+);",
                          model).group(1))
    lengths = {shape[1] for _, shape, _, _ in SMOKE.MAMBA_CASES}
    assert {1, chunk - 1, chunk, chunk + 1} <= lengths


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16waterfill_kernelIfLi4ELb1EEv' for 'sm_90a'
ptxas info    : Function properties for _Z16waterfill_kernelIfLi4ELb1EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 410 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16waterfill_kernelIfLi0ELb1EEv' for 'sm_90a'
ptxas info    : Function properties for __internal_callee
    24 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Function properties for _Z16waterfill_kernelIfLi0ELb1EEv
    392 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 410 bytes cmem[0]
"""


def test_torch_kernel_symbols_ptxas_report_reads_the_stack_frame():
    """Each entry's stack frame and spills come from its own "Function
    properties" block, never a callee's."""
    a, b = SMOKE.ptxas_report(PTXAS_LOG)
    assert a == {"function": "_Z16waterfill_kernelIfLi4ELb1EEv",
                 "stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
                 "registers": 30}
    assert b == {"function": "_Z16waterfill_kernelIfLi0ELb1EEv",
                 "stack_frame": 392, "spill_stores": 0, "spill_loads": 0,
                 "registers": 40}


def _qkv(dtype, B=2, S=64, H=8, KV=2, D=64):
    gen = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen).to(dtype)
    return mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D)


def test_torch_kernel_symbols_k4_rule_picks_by_dtype():
    assert FA.select_kernel(*_qkv(torch.bfloat16)) == \
        "flash_fwd_wgmma_kernel"
    assert FA.select_kernel(*_qkv(torch.float32)) == "flash_fwd_kernel"
    # float32 has no alignment rule: strides TMA could not read are fine
    q, k, v = _qkv(torch.float32, D=68)
    assert FA.select_kernel(q[..., :64], k[..., :64], v[..., :64]) == \
        "flash_fwd_kernel"
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        FA.select_kernel(*_qkv(torch.float16))


def test_torch_kernel_symbols_k4_rule_takes_fused_kv_slices():
    B, S, H, KV, D = 2, 64, 8, 2, 64
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    kv = torch.zeros(B, S, 2 * KV, D, dtype=torch.bfloat16)
    k, v = kv[:, :, :KV], kv[:, :, KV:]
    assert not k.is_contiguous() and v.data_ptr() % 16 == 0
    assert FA.select_kernel(q, k, v) == "flash_fwd_wgmma_kernel"


def test_torch_kernel_symbols_k4_rule_refuses_what_tma_cannot_read():
    q, k, v = _qkv(torch.bfloat16)
    # a base address two bytes off
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="base address"):
        FA.select_kernel(flat[1:].view(q.shape), k, v)
    # a sequence stride of 136 values (272 bytes) is fine, a head stride
    # of 68 values (136 bytes) is not
    wide = torch.zeros(2, 64, 2, 72, dtype=torch.bfloat16)
    wide = wide.as_strided((2, 64, 2, 64), (64 * 2 * 68, 2 * 68 + 8, 68, 1))
    with pytest.raises(ValueError, match="stride 68 along dimension 2"):
        FA.select_kernel(q, wide, v)
    # the stride of a dimension of size 1 is never read: any value goes
    base = torch.zeros(2 * 64 * 64, dtype=torch.bfloat16)
    one = base.as_strided((1, 64, 1, 64), (4096, 64, 3, 1))
    assert FA.select_kernel(one, one, one) == "flash_fwd_wgmma_kernel"
    two = base.as_strided((1, 64, 2, 64), (4096, 64, 3, 1))
    with pytest.raises(ValueError, match="stride 3 along dimension 2"):
        FA.select_kernel(two, two, two)


def test_torch_kernel_symbols_k4_head_dim_pairs_are_the_built_ones():
    """K4's wrapper takes exactly the (Dqk, Dv) pairs the CUDA source
    instantiates and sizes (``K4_PAIR`` in ``model_flash_attention_fwd``,
    ``FwSmem`` in ``model_flash_wgmma_smem_bytes``), and
    ``chip_smoke.py``'s cases hold every pair on the card."""
    from repro_torch.kernels import cuda_kernels as MK
    model = (CSRC / "model_kernels.cu").read_text()
    dispatched = {(int(a), int(b)) for a, b in
                  re.findall(r"^\s*K4_PAIR\((\d+), (\d+)\)", model, re.M)}
    sized = {(int(a), int(b)) for a, b in
             re.findall(r"return FwSmem<(\d+), (\d+)>::BYTES", model)}
    assert dispatched == sized == set(MK.HEAD_DIMS)
    assert {(96, 64), (192, 128)} <= set(MK.HEAD_DIMS)
    cased = {shape[5:] for _, shape, *_ in SMOKE.ATTN_CASES}
    assert cased == set(MK.HEAD_DIMS)

