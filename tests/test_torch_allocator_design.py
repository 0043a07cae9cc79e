"""The arithmetic of the redesigned allocator kernels (K1 waterfill, K2
strict priority in ``repro_torch/csrc/fabric_kernels.cu``), checked on the
CPU.

A CUDA kernel cannot run here, so its row routines are transcribed below
operation for operation in Python floats (float64) and in numpy float32
scalars:

  * ``stable_rank``: flow j's rank counts the flows k < j with
    ``key[k] <= key[j]`` and the flows k > j with ``key[k] < key[j]``,
    among the flows of a member mask;
  * ``fill_fixed``: the fill over rank positions, position p's flow found
    by a select over ``rank[j] == p`` and its allocation written back the
    same way; unit weights divide by the count of flows left, ``N - p``;
  * ``class_fill``: K2's fill of one priority class over its members
    only, dividing by ``m - p``, then the outer capacity loses the class's
    allocations in flow-index order and is clamped at zero.

The transcriptions must equal the Python loops of
:mod:`repro_torch.fabric.congestion` bit for bit (float hex), the plain
PyTorch versions in float64 and float32, and the JAX package's Pallas
kernels in interpret mode under ``jax.enable_x64(True)``, bit for bit in
float64. Zeros are compared by value against the plain versions and the
Pallas kernels: those add each class's allocations to zeros, so a
``-0.0`` allocation (from a ``-0.0`` demand or capacity, which the
boundary check lets through) reaches them as ``+0.0``; the Python loop and
the kernel write it as it is.

Inputs: hypothesis with a fixed seed (``derandomize``) over 1 to 32 flows,
zero, tied, tiny (denormal) and saturating demands, capacity 0, and 1 to
n priority classes; and for every n from 1 to 32 a numpy-seeded batch
held against the Pallas kernels. Those batches hold no denormal value:
XLA's CPU runtime flushes denormals to zero, so there the Pallas kernels
read a demand of 5e-324 as 0 (the Python loops, the plain versions and
the transcriptions keep it, and are held to each other with it). Also the
wrapper's pure helper that packs priorities into one member mask per
class.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.fabric.backend import pallas_kernels as PK
from repro_torch.fabric import congestion as ref
from repro_torch.fabric.backend import torch_kernels as TK
from repro_torch.fabric.backend.cuda_kernels import (MAX_FIXED_FLOWS,
                                                     MAX_FLOWS, class_masks)

TINY = 5e-324


# ---------------------------------------------------------------------------
# the transcriptions: ``f`` makes a float of the type (float or np.float32)
# ---------------------------------------------------------------------------


def stable_rank(key, members):
    n = len(key)
    rank = []
    for j in range(n):
        r = 0
        for k in range(n):
            if k == j:
                continue
            before = key[k] <= key[j] if k < j else key[k] < key[j]
            r += 1 if ((members >> k) & 1) and before else 0
        rank.append(r)
    return rank


def fill_fixed(d, w, remaining, unit, f=float):
    n = len(d)
    key = list(d) if unit else [d[j] / w[j] for j in range(n)]
    rank = stable_rank(key, (1 << n) - 1)
    w_left = f(0.0)
    if not unit:
        for j in range(n):
            w_left = w_left + w[j]
    alloc = [f(0.0)] * n
    for p in range(n):
        dj, wj = f(0.0), f(0.0)
        for j in range(n):
            if rank[j] == p:
                dj = d[j]
                if not unit:
                    wj = w[j]
        if unit:
            fair = remaining / f(n - p)
        else:
            fair = remaining
            if w_left > f(0.0):
                fair = remaining * wj / w_left
        give = dj if dj < fair else fair
        for j in range(n):
            if rank[j] == p:
                alloc[j] = give
        remaining = remaining - give
        if not unit:
            w_left = w_left - wj
    return alloc


def class_fill(d, members, remaining, alloc, f=float):
    """One class of K2: ``alloc`` is written in place; returns the outer
    capacity left for the next class."""
    n = len(d)
    rank = stable_rank(d, members)
    m = bin(members).count("1")
    rem = remaining
    for p in range(m):
        dj = f(0.0)
        for j in range(n):
            if (members >> j) & 1 and rank[j] == p:
                dj = d[j]
        fair = rem / f(m - p)
        give = dj if dj < fair else fair
        for j in range(n):
            if (members >> j) & 1 and rank[j] == p:
                alloc[j] = give
        rem = rem - give
    for j in range(n):
        if (members >> j) & 1:
            remaining = remaining - alloc[j]
    return f(0.0) if remaining < f(0.0) else remaining


def strict_priority_fixed(d, priorities, remaining, f=float):
    alloc = [f(0.0)] * len(d)
    for members in class_masks(priorities, len(d)):
        remaining = class_fill(d, members, remaining, alloc, f)
    return alloc


def _hex(xs):
    return [float(x).hex() for x in xs]


def _by_value(a):
    """Float64 bits with zeros made ``+0.0`` (see the module docstring)."""
    return (np.asarray(a, dtype=np.float64) + 0.0).view(np.int64)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

_special = st.sampled_from([0.0, 0.0, 1.0, 0.5, TINY, 2.0, 0.25])
_demand = st.one_of(_special, st.floats(0.0, 2.0, allow_nan=False,
                                        allow_infinity=False))
_capacity = st.one_of(st.sampled_from([0.0, TINY, 1.0, 0.75]),
                      st.floats(0.0, 3.0, allow_nan=False,
                                allow_infinity=False))
_weight = st.one_of(st.sampled_from([1.0, 0.5, 3.0]),
                    st.floats(0.25, 4.0, allow_nan=False,
                              allow_infinity=False))


@st.composite
def rows(draw, with_weights=False):
    n = draw(st.integers(1, MAX_FLOWS))
    pool = draw(st.lists(_demand, min_size=1, max_size=4))
    # ties: a good share of the demands come from a small pool
    d = draw(st.lists(st.one_of(st.sampled_from(pool), _demand),
                      min_size=n, max_size=n))
    w = draw(st.lists(_weight, min_size=n, max_size=n)) if with_weights \
        else None
    return d, w, draw(_capacity)


@st.composite
def priority_rows(draw):
    d, _, cap = draw(rows())
    n = len(d)
    k = draw(st.integers(1, n))               # at most k classes
    pr = draw(st.lists(st.integers(0, k - 1), min_size=n, max_size=n))
    return d, pr, cap


SETTINGS = settings(max_examples=400, deadline=None, derandomize=True)


# ---------------------------------------------------------------------------
# the transcriptions against the Python loops (float64, bit for bit)
# ---------------------------------------------------------------------------


@SETTINGS
@given(rows())
def test_torch_allocator_design_maxmin_fill_is_the_python_loop(row):
    d, _, cap = row
    want = ref.maxmin_shares(d, cap)
    assert _hex(fill_fixed(d, None, cap, unit=True)) == _hex(want)
    # the unit-weight fill with explicit weights of 1.0, the arithmetic of
    # the runtime-n form and of the Pallas kernel: the same bits
    assert _hex(fill_fixed(d, [1.0] * len(d), cap, unit=False)) == \
        _hex(want)


@SETTINGS
@given(rows(with_weights=True))
def test_torch_allocator_design_wfq_fill_is_the_python_loop(row):
    d, w, cap = row
    assert _hex(fill_fixed(d, w, cap, unit=False)) == \
        _hex(ref.wfq_shares(d, w, cap))


@SETTINGS
@given(priority_rows())
def test_torch_allocator_design_class_fill_is_the_python_loop(row):
    d, pr, cap = row
    assert _hex(strict_priority_fixed(d, pr, cap)) == \
        _hex(ref.strict_priority_shares(d, pr, cap))


@pytest.mark.parametrize("kind", ["one class", "a class per flow",
                                  "main path"])
@settings(max_examples=150, deadline=None, derandomize=True)
@given(row=rows())
def test_torch_allocator_design_class_fill_partitions(kind, row):
    d, _, cap = row
    n = len(d)
    if kind == "one class":
        pr = [3] * n
    elif kind == "a class per flow":
        pr = list(range(n))
    else:                                     # [2, 1, 0, 0], cut or padded
        pr = ([2, 1] + [0] * max(0, n - 2))[:n]
    got = strict_priority_fixed(d, pr, cap)
    assert _hex(got) == _hex(ref.strict_priority_shares(d, pr, cap))
    if kind == "one class":                   # a single max-min fill
        assert _hex(got) == _hex(ref.maxmin_shares(d, cap))


def test_torch_allocator_design_negative_zero_is_written_as_it_is():
    """A ``-0.0`` capacity: the Python loop and the class fill give flow 0
    ``-0.0``; the plain version adds it to zeros and gives ``+0.0``, equal
    by value (``torch.equal``)."""
    d, pr = [0.0, 0.3, 0.2, 0.5], [1, 0, 1, 0]
    want = ref.strict_priority_shares(d, pr, -0.0)
    assert _hex(strict_priority_fixed(d, pr, -0.0)) == _hex(want)
    assert want[0].hex() == "-0x0.0p+0"
    plain = TK.strict_priority_shares(torch.tensor([d], dtype=torch.float64),
                                      pr, -0.0)
    assert torch.equal(plain, torch.tensor([want], dtype=torch.float64))


# ---------------------------------------------------------------------------
# float32: the transcription in float32 scalars against the plain version
# ---------------------------------------------------------------------------


@settings(max_examples=150, deadline=None, derandomize=True)
@given(row=rows(with_weights=True), k=st.integers(1, 4))
def test_torch_allocator_design_float32_is_the_plain_version(row, k):
    d, w, cap = row
    n = len(d)
    f = np.float32
    d32, w32, c32 = [f(x) for x in d], [f(x) for x in w], f(cap)
    pr = [j % k for j in range(n)]
    td = torch.tensor([d32], dtype=torch.float32)
    tw = torch.tensor([w32], dtype=torch.float32)
    tc = torch.tensor([c32], dtype=torch.float32)
    pairs = [
        (fill_fixed(d32, None, c32, unit=True, f=f), TK.maxmin_shares(td, tc)),
        (fill_fixed(d32, w32, c32, unit=False, f=f),
         TK.wfq_shares(td, tw, tc)),
        (strict_priority_fixed(d32, pr, c32, f=f),
         TK.strict_priority_shares(td, pr, tc)),
    ]
    for got, want in pairs:
        assert all(type(x) is np.float32 for x in got)
        assert np.array_equal(np.array(got, dtype=np.float32).view(np.int32),
                              (want[0].numpy() + 0.0).view(np.int32))


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode, float64, every n 1..32
# ---------------------------------------------------------------------------


def _batch(n, seed, rows=24):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1.0, size=(rows, n))
    d[rng.uniform(size=d.shape) < 0.25] = 0.0
    d[rng.uniform(size=d.shape) < 0.15] = 1.0
    if n > 1:
        d[::3, 1] = d[::3, 0]                 # ties
        d[1::5] = d[1::5, :1]                 # a row of one repeated value
    w = rng.uniform(0.25, 4.0, size=(rows, n))
    w[::4] = 1.0
    cap = rng.uniform(0.0, 2.0, size=rows)
    cap[::7] = 0.0
    return d, w, cap


def _partition(n, seed):
    """One class, a class per flow, the main path's [2, 1, 0, 0], or a
    random one, by n."""
    kind = n % 4
    if kind == 0 and n == 4:
        return np.array([2, 1, 0, 0])
    if kind == 1:
        return np.zeros(n, dtype=int)
    if kind == 2:
        return np.arange(n)[::-1].copy()
    return np.random.default_rng(seed).integers(0, max(1, n // 2) + 1,
                                                size=n)


def _check_against_pallas(d, w, cap, pr):
    """The transcriptions against the Python loops (bit for bit), the
    plain versions and the Pallas kernels in interpret mode (float64 bits,
    zeros by value)."""
    mine = {
        "maxmin": [fill_fixed(r.tolist(), None, float(c), unit=True)
                   for r, c in zip(d, cap)],
        "wfq": [fill_fixed(r.tolist(), x.tolist(), float(c), unit=False)
                for r, x, c in zip(d, w, cap)],
        "strict_priority": [strict_priority_fixed(r.tolist(), pr.tolist(),
                                                  float(c))
                            for r, c in zip(d, cap)],
    }
    loops = {
        "maxmin": [ref.maxmin_shares(r.tolist(), float(c))
                   for r, c in zip(d, cap)],
        "wfq": [ref.wfq_shares(r.tolist(), x.tolist(), float(c))
                for r, x, c in zip(d, w, cap)],
        "strict_priority": [ref.strict_priority_shares(
            r.tolist(), pr.tolist(), float(c)) for r, c in zip(d, cap)],
    }
    for k in mine:
        assert [_hex(r) for r in mine[k]] == [_hex(r) for r in loops[k]], k
    td, tw, tc = (torch.as_tensor(x, dtype=torch.float64)
                  for x in (d, w, cap))
    plain = {"maxmin": TK.maxmin_shares(td, tc),
             "wfq": TK.wfq_shares(td, tw, tc),
             "strict_priority": TK.strict_priority_shares(td, pr, tc)}
    with jax.enable_x64(True):
        pallas = {
            "maxmin": np.asarray(PK.maxmin_shares(d, cap, interpret=True)),
            "wfq": np.asarray(PK.wfq_shares(d, w, cap, interpret=True)),
            "strict_priority": np.asarray(PK.strict_priority_shares(
                d, pr, cap, interpret=True)),
        }
    for k in mine:
        assert pallas[k].dtype == np.float64, k
        assert np.array_equal(_by_value(mine[k]), _by_value(pallas[k])), k
        assert np.array_equal(_by_value(mine[k]),
                              _by_value(plain[k].numpy())), k


@pytest.mark.parametrize("n", range(1, MAX_FLOWS + 1))
def test_torch_allocator_design_matches_pallas_interpret(n):
    d, w, cap = _batch(n, seed=n)
    _check_against_pallas(d, w, cap, _partition(n, seed=100 + n))


@settings(max_examples=12, deadline=None, derandomize=True)
@given(n=st.integers(1, MAX_FIXED_FLOWS), seed=st.integers(0, 2 ** 16),
       k=st.integers(1, MAX_FIXED_FLOWS))
def test_torch_allocator_design_matches_pallas_interpret_drawn(n, seed, k):
    """The same comparison on drawn batches of the flow counts that have
    a kernel of their own, with up to k priority classes."""
    d, w, cap = _batch(n, seed=seed, rows=16)
    pr = np.random.default_rng(seed).integers(0, min(k, n), size=n)
    _check_against_pallas(d, w, cap, pr)


# ---------------------------------------------------------------------------
# the wrapper's class masks
# ---------------------------------------------------------------------------


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(st.integers(-3, 6), min_size=1, max_size=MAX_FLOWS))
def test_torch_allocator_design_class_masks_are_the_class_rows(pr):
    n = len(pr)
    masks = class_masks(np.array(pr), n)
    rows_ = TK.priority_classes(pr, n)
    assert len(masks) == rows_.shape[0] == len(set(pr))
    for m, row in zip(masks, rows_):
        assert 0 < m < 2 ** n
        assert [bool((m >> k) & 1) for k in range(n)] == row.tolist()
    # a partition of the flows, classes in descending priority
    assert sum(masks) == 2 ** n - 1
    assert all(a & b == 0 for i, a in enumerate(masks) for b in masks[:i])
    firsts = [pr[(m & -m).bit_length() - 1] for m in masks]
    assert firsts == sorted(set(pr), reverse=True)


def test_torch_allocator_design_class_masks_refuse_a_mismatch():
    with pytest.raises(ValueError, match="4 demands but 3 priorities"):
        class_masks([1, 2, 3], 4)
    with pytest.raises(ValueError, match="concrete 1-D"):
        class_masks(np.zeros((2, 2)), 2)
    assert class_masks(np.array([2, 1, 0, 0]), 4) == (0b0001, 0b0010,
                                                      0b1100)
    assert class_masks([], 0) == ()
