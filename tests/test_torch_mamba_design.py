"""K7's design (the Mamba-1 selective scan kernel) transcribed on the CPU.

``mamba_scan_fwd_kernel`` (``src/repro_torch/csrc/model_kernels.cu``)
cannot run here, so its order of work is transcribed in torch float32:
the threads of a block as one tensor axis, a channel and its N states
each, the two-stage ring of x, dt (as read) and B, C (widened) with its
ragged last chunk, the FMA chain for y, and each warp's y tile. The
ring's stages start as NaN, so a step that read a token the chunk does
not hold would show. The chunk and block constants are read from the
CUDA source.

Exponentials are ``torch.exp`` on CPU float32, the plain version's
function here, so the state is held to the plain version
(``repro_torch.kernels.ref.mamba_scan``) bit for bit, as the kernel's is
to the plain version on the card. y is a sum in another order: within
1e-6 of the largest |y| in float32, and within the scan's 2e-2 in
bfloat16. Against the JAX package's Pallas kernel in interpret mode, the
scan's tolerance (2e-4 float32, 2e-2 bfloat16; ``tests/test_kernels.py``).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan as jmamba_pallas

from repro_torch.kernels import cuda_kernels
from repro_torch.kernels.ref import mamba_scan as plain

from test_torch_model import both, f32

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" /
          "repro_torch" / "csrc" / "model_kernels.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, CHUNK = (_const(k) for k in ("MAMBA_THREADS", "MAMBA_T"))
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fma(a, b, c):
    """fmaf: a * b is exact in float64; one rounding of the sum to
    float32 (through float64, which can differ from a single rounding in
    the last bit: this only feeds y, held to a tolerance)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_transcription(x, dt, A, Bm, C, D, h0):
    """y (in x's dtype) and h_out (float32) computed in the kernel's order
    of work, a thread a channel."""
    Bsz, S, Din = x.shape
    N = A.shape[-1]
    CH = THREADS
    blocks = -(-Din // CH)
    c = torch.arange(THREADS)                               # (threads,)
    d = torch.arange(blocks)[:, None] * CH + c              # (blocks, threads)
    active = d < Din
    dc = d.clamp(max=Din - 1)
    a = torch.where(active[..., None], A[dc], 0.0)          # (blk, thr, N)
    if h0 is None:
        h = torch.zeros(Bsz, blocks, THREADS, N)
    else:
        h = torch.where(active[..., None], h0[:, dc], 0.0)
    dv = torch.where(active, D[dc], 0.0)

    # the ring: x and dt as read, (B, blocks, stage, token, channel of the
    # block); B and C widened, (B, stage, token, n)
    sx = torch.full((Bsz, blocks, 2, CHUNK, CH), float("nan"), dtype=x.dtype)
    sdt = sx.clone()
    sB = torch.full((Bsz, 2, CHUNK, N), float("nan"))
    sC = sB.clone()
    y = torch.full((Bsz, S, Din), float("nan"), dtype=x.dtype)
    xpad = torch.nn.functional.pad(x, (0, blocks * CH - Din))
    dtpad = torch.nn.functional.pad(dt, (0, blocks * CH - Din))

    def stage(s, t0, n):                  # mamba_stage, mamba_fetch / put
        rows = slice(t0, t0 + n)
        sx[:, :, s, :n] = xpad[:, rows].reshape(Bsz, n, blocks,
                                                 CH).transpose(1, 2)
        sdt[:, :, s, :n] = dtpad[:, rows].reshape(Bsz, n, blocks,
                                                   CH).transpose(1, 2)
        sB[:, s, :n] = Bm[:, rows].float()
        sC[:, s, :n] = C[:, rows].float()

    chunks = -(-S // CHUNK)
    if chunks > 0:
        stage(0, 0, min(CHUNK, S))
    for k in range(chunks):
        t0 = k * CHUNK
        n = min(CHUNK, S - t0)
        n1 = min(CHUNK, S - t0 - CHUNK)
        s, s1 = k & 1, (k & 1) ^ 1
        xs, dts = sx[:, :, s, :, c].clone(), sdt[:, :, s, :, c].clone()
        Bs, Cs = sB[:, s].clone(), sC[:, s].clone()
        if n1 > 0:        # the next chunk lands in the other stage
            stage(s1, t0 + CHUNK, n1)
        # the warps' tiles side by side: warp w's lane l at w * 32 + l
        tile = torch.full((Bsz, blocks, CHUNK, CH), float("nan"))
        for t in range(n):                                 # step(t)
            xt, dtt = xs[:, :, t].float(), dts[:, :, t].float()
            bt = Bs[:, t][:, None, None]                    # (B,1,1,N)
            ct = Cs[:, t][:, None, None]
            dtx = dtt * xt
            acc = torch.zeros(Bsz, blocks, THREADS)
            for j in range(N):
                dA = torch.exp(dtt * a[..., j])
                h[..., j] = dA * h[..., j] + dtx * bt[..., j]
                acc = _fma(h[..., j], ct[..., j], acc)
            tile[:, :, t, c] = acc + xt * dv
        # each warp's tile to its rows of y, inside Din
        rows = tile[:, :, :n].transpose(1, 2).reshape(Bsz, n, blocks * CH)
        y[:, t0:t0 + n] = rows[..., :Din].to(x.dtype)
    return y, h.reshape(Bsz, blocks * CH, N)[:, :Din]


def inputs(B, S, Din, N, dtype, h0, seed):
    """x, dt, A, B, C, D, h0 as (JAX array, CPU tensor) pairs, drawn as
    ``tests/test_kernels.py`` draws them; ``h0`` None, "zeros" or
    "given"."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Din))
    dt = np.logaddexp(rng.standard_normal((B, S, Din)), 0.0)
    A = -np.exp(0.5 * rng.standard_normal((Din, N)))
    Bm = rng.standard_normal((B, S, N))
    C = rng.standard_normal((B, S, N))
    D = rng.standard_normal(Din)
    h = {None: None, "zeros": np.zeros((B, Din, N)),
         "given": 0.1 * rng.standard_normal((B, Din, N))}[h0]
    pairs = ([both(v, dtype) for v in (x, dt)] + [both(A, "float32")]
             + [both(v, dtype) for v in (Bm, C)] + [both(D, "float32")])
    return pairs + [(None, None) if h is None else both(h, "float32")]


def check_against_plain(args, dtype):
    y, h = kernel_transcription(*args)
    y_want, h_want = plain(*args)
    assert y.dtype == TD[dtype] and h.dtype == torch.float32
    assert y.shape == y_want.shape and h.shape == h_want.shape
    assert torch.equal(h, h_want)
    if dtype == "float32":
        scale = float(y_want.abs().max()) if y_want.numel() else 0.0
        torch.testing.assert_close(y, y_want, rtol=0.0, atol=1e-6 * scale)
    else:
        torch.testing.assert_close(y.float(), y_want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_torch_mamba_design_constants():
    assert THREADS % 32 == 0 and CHUNK >= 2
    assert cuda_kernels.MAMBA_STATE_DIMS == (8, 16)


# S at the chunk's edges (Din 200: not a multiple of a block's channels),
# then a long ragged sequence at a small Din
S_CASES = [(1, 200), (CHUNK - 1, 200), (CHUNK, 200), (CHUNK + 1, 200),
           (1000, 40)]


@pytest.mark.parametrize("S,Din", S_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_mamba_design_holds_the_plain_state_bits(dtype, N, S, Din):
    pairs = inputs(2, S, Din, N, dtype, "given", seed=S + N)
    check_against_plain([t for _, t in pairs], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [None, "zeros", "given"])
@pytest.mark.parametrize("N", [8, 16])
def test_torch_mamba_design_initial_states_and_dtypes(N, h0, dtype):
    pairs = inputs(2, 2 * CHUNK + 3, 72, N, dtype, h0, seed=3)
    check_against_plain([t for _, t in pairs], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [8, 16])
def test_torch_mamba_design_matches_the_pallas_kernel(N, dtype):
    """The JAX Pallas kernel in interpret mode (ragged S against its
    chunk, Din not a multiple of its block) at the scan's tolerance."""
    pairs = inputs(2, CHUNK + 5, 48, N, dtype, "given", seed=11)
    y, h = kernel_transcription(*[t for _, t in pairs])
    y_want, h_want = jmamba_pallas(*[j for j, _ in pairs], chunk=16,
                                   block_d=32, interpret=True)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f32(y), f32(y_want), **tol)
    np.testing.assert_allclose(f32(h), f32(h_want), **tol)
