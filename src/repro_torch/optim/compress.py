"""Gradient compression with error feedback, and the int8 cross-pod ring.

The counterpart of ``repro.optim.compress``. Int8 quantization targets the
slow tier: on a multi-pod mesh, gradients are averaged in full precision
over the fast intra-pod axes, then exchanged across pods as int8 with a
float32 scale per block of :data:`BLOCK` elements, by a ring of
``torch.distributed`` send/receive steps that keeps the wire format int8.
:func:`compressed_pseudo_grad` is the error-feedback form (the
quantization error re-enters the next step's gradient).

The arithmetic keeps the reference's bits: float32, zero padding to a
whole block, ``max|x| / 127`` divided by a tensor (PyTorch turns a
division by a Python number into a product with its reciprocal),
``torch.round`` (half to even, as ``jnp.round``), clip to [-127, 127],
the int8 cast.

**Wire bytes.** Each rank sends the whole padded tensor ``n - 1`` times,
1 byte an element and a 4-byte scale a block: ``(n - 1) x 1.0156`` bytes
an element. A bf16 ring all-reduce sends ``2 (n - 1) / n x 2`` bytes an
element. At ``pod = 2`` the int8 ring sends 1.97x fewer bytes than bf16
(1.0156 against 2), not the 3.9x ``repro.launch.compressed`` claims (3.94x
is the ratio to a float32 all-reduce); at ``pod = 4`` it sends more than
bf16 (3.05 against 3 bytes an element). :func:`wire_bytes` counts what
this process sent; the mesh's ``collective_bytes`` counts the same
bytes as ``collective-permute``, the reference's ``ppermute``.

**The ranks' results differ.** As in the reference, each rank adds its
own gradient at full precision and the others' after quantization, so
the "all-reduced" gradient depends on the rank; the port reproduces each
rank's result and does not make them agree.

Collectives take a process group: NCCL on the card, ``gloo`` on the CPU.
The int8 ring refuses a CUDA tensor on a ``gloo`` group (``ValueError``);
it is not copied through the host. The full-precision mean
(:func:`mean_over`) takes one, and gloo stages it through host memory
itself, as it does the tensor-parallel all-reduces of ranks that share
one card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib

Tree = Dict[str, torch.Tensor]

BLOCK = 256                           # quantization block (per-block scales)

_WIRE = {"bytes": 0}


def wire_bytes() -> int:
    """Bytes this process has sent through :func:`_int8_ring_all_reduce`
    since :func:`reset_wire_bytes`."""
    return _WIRE["bytes"]


def reset_wire_bytes() -> None:
    _WIRE["bytes"] = 0


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8. x: (n,) f32 -> (q (n,) i8, scale (n/B,) f32)."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(-1, BLOCK)
    c127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.amax(torch.abs(xp), dim=1, keepdim=True) / c127
    q = torch.clamp(torch.round(xp / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int
                ) -> torch.Tensor:
    x = q.to(torch.float32) * scale[:, None]
    return x.reshape(-1)[:n]


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize + dequantize (for error-feedback residuals)."""
    flat = x.to(torch.float32).reshape(-1)
    q, s = _quantize(flat)
    return _dequantize(q, s, flat.shape[0]).reshape(x.shape)


def _check_group(x: torch.Tensor, group) -> None:
    if x.is_cuda and dist.get_backend(group) == "gloo":
        raise ValueError("a CUDA tensor was handed to a gloo group: build "
                         "the mesh on the card (NCCL) or keep the tensors "
                         "on the CPU; nothing is copied through the host")


def _int8_ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over ``group`` with an int8 wire format: ``n - 1`` steps, each
    sending the last received partial (int8 and its float32 block scales)
    to the group's next rank and receiving from the previous one, in the
    group's rank order (the mesh axis's coordinate order, as the
    reference's ``perm``), accumulated in float32."""
    _check_group(x, group)
    n_ranks = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n_ranks)
    prv = dist.get_global_rank(group, (me - 1) % n_ranks)
    flat = x.to(torch.float32).reshape(-1)
    n = flat.shape[0]
    acc, send = flat, flat
    for _ in range(n_ranks - 1):
        q, s = _quantize(send)
        rq, rs = torch.empty_like(q), torch.empty_like(s)
        ops = [dist.P2POp(dist.isend, q, nxt, group, tag=0),
               dist.P2POp(dist.isend, s, nxt, group, tag=1),
               dist.P2POp(dist.irecv, rq, prv, group, tag=0),
               dist.P2POp(dist.irecv, rs, prv, group, tag=1)]
        if q.is_meta:
            # a traced step (the dry run): no backend batches meta tensors
            reqs = [o.op(o.tensor, o.peer, o.group, o.tag) for o in ops]
        else:
            reqs = dist.batch_isend_irecv(ops)
        for r in reqs:
            r.wait()
        sent = mesh_lib.nbytes(q) + mesh_lib.nbytes(s)
        _WIRE["bytes"] += sent
        mesh_lib.count("p2p", 4, op="collective-permute", nbytes=sent)
        recv = _dequantize(rq, rs, n)
        acc = acc + recv
        send = recv
    size = torch.full((), float(n_ranks), dtype=torch.float32,
                      device=x.device)
    return (acc / size).reshape(x.shape).to(x.dtype)


def mean_over(x: torch.Tensor, group, size: int, *,
              in_place: bool = False) -> torch.Tensor:
    """All-reduce sum over ``group``, then a division by its size as a
    tensor (the reference's ``pmean``), both on one copy of ``x`` (on
    ``x`` itself with ``in_place``)."""
    x = mesh_lib.all_reduce(x if in_place else x.clone(), group)
    return x.div_(torch.full((), float(size), dtype=torch.float32,
                             device=x.device))


def hierarchical_grad_reduce(
    grads: Tree,
    *,
    mesh,
    fast_axes: Sequence[str] = ("data",),
    slow_axis: Optional[str] = "pod",
    compress: str = "int8",
    in_place: bool = False,
) -> Tree:
    """Reduce gradients: the mean over ``fast_axes`` in full precision,
    then over ``slow_axis`` the int8 ring (``compress="int8"``) or a plain
    mean. A fast axis absent from the mesh is skipped; the slow axis is
    skipped when absent or of size 1, as in the reference. With
    ``in_place`` the plain means are taken on the leaves themselves, which
    the caller gives up (no copy of a leaf is made)."""
    shape = mesh_lib.mesh_shape(mesh)
    fast = tuple(a for a in fast_axes if a in shape)
    fast_group = mesh_lib.axes_group(mesh, fast) if fast else None
    fast_size = 1
    for a in fast:
        fast_size *= shape[a]
    slow = slow_axis if slow_axis and shape.get(slow_axis, 1) > 1 else None
    slow_group = mesh_lib.axes_group(mesh, (slow,)) if slow else None

    def one(g):
        own = in_place
        if fast:
            g, own = mean_over(g, fast_group, fast_size, in_place=own), True
        if slow:
            if compress == "int8":
                g = _int8_ring_all_reduce(g, slow_group)
            else:
                g = mean_over(g, slow_group, shape[slow], in_place=own)
        return g

    return {n: one(g) for n, g in grads.items()}


def compressed_pseudo_grad(grads: Tree, residual: Optional[Tree]
                           ) -> Tuple[Tree, Tree]:
    """Error feedback: g_eff = Q(g + r); r' = (g + r) - g_eff.

    The optimizer sees the quantized gradient, and the information lost
    re-enters the next step."""
    if residual is None:
        residual = {n: torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device) for n, g in grads.items()}
    out, new_residual = {}, {}
    for n, g in grads.items():
        acc = g.to(torch.float32) + residual[n]
        q = quantize_roundtrip(acc)
        new_residual[n] = acc - q
        out[n] = q.to(g.dtype)
    return out, new_residual
