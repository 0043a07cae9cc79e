"""Attention mixers: GQA (RoPE / M-RoPE / sliding window / QKV bias) and
MLA (multi-head latent attention) with a decode cache, and the
encoder-decoder's cross attention.

The counterpart of ``repro.models.attention``: the GQA half ``gqa_init``,
``gqa_init_cache``, ``cache_capacity``, ``_ring_write`` and ``gqa_apply``;
the MLA half ``mla_init``, ``mla_init_cache``, ``_mla_q``, ``_mla_ckv``
and ``mla_apply``; and ``cross_init`` / ``cross_apply``, which attend
over the encoder's output and keep no cache (K and V are computed from
the memory on every call, in decode too, as the reference does). The
self-attention mixers take mode in {"train", "prefill", "decode"}:

  * train   -- full causal self-attention, no cache.
  * prefill -- causal self-attention AND fills the cache.
  * decode  -- single-token query against the cache (S_q == 1).

Caches are plain dicts of tensors. GQA's SWA layers use a ring buffer of
size ``window`` (rope is applied at write time, so ring order is
irrelevant); MLA's cache holds the compressed latent ``c`` and the rope
key ``kr``, ``max_len`` long, and its decode attends against it in the
absorbed form. Where the reference returns a new cache (``.at[].set`` and
``dynamic_update_slice``, with the cache donated to the step), the port
writes into the preallocated cache in place and returns the same dict.

Under a bound mesh whose ``model`` axis is larger than 1
(``launch.sharding.model_axis``) GQA runs tensor parallel
(:func:`local_heads`): each rank holds its ``H / tp`` query heads'
columns of ``wq`` / ``bq`` and rows of ``wo``, and its ``KV / tp`` KV
heads' columns of ``wk`` / ``wv`` / ``bk`` / ``bv`` where ``tp`` divides
``KV``; RoPE, the ring cache and K4 run at the local heads, the cache
holds only the local KV heads, and ``wo`` is a row-parallel product
(``tp_row_matmul``). Where ``KV`` divides ``tp`` a rank's query heads
fall in one KV group: every rank keeps the whole KV projection and
computes, and caches, its group's head. Where neither divides the other
(:func:`straddles`; Qwen2-VL-2B's 2 KV heads at ``model 3``) a rank's
query heads read parts of two or more groups, not always evenly: every
rank keeps the whole KV projection, as the reference's ``kv_heads``
fallback replicates it, computes and caches every KV head, and hands K4
the KV heads its query heads read (:func:`kv_read`): the run of them,
where each serves as many of the rank's query heads (K4's uniform group
maps them), or one KV head a query head (a group of 1), gathered by index,
where they do not; the decode step reads the cache the same way. Where
``tp`` does not divide the query heads
(:func:`heads_sharded`; Qwen2-7B's 28 at ``model`` 16) every rank holds
the whole attention and runs it whole, with no collective
(``launch.sharding.runs_whole``): the reference's divisibility fallback,
"replicated attention compute when heads % 16 != 0". Cross attention
runs the same way, its queries from the decoder's states and its keys
and values from the encoder's memory, both entered with
``copy_to_model``. MLA shards ``wq_b`` (or ``wq``) and ``wkv_b`` on
heads and runs ``wo`` row-parallel; ``wq_a``, ``wkv_a``, ``q_norm``,
``kv_norm`` and the latent cache (``c``, ``kr``) stay whole on every rank,
as the reference's specs leave them, every rank writing the same cache.
The latent reaches a rank's heads through ``copy_to_model`` (the normed
q latent, ``c`` and ``kr``), not ``x``, so that the gradients of the
whole leaves before it are summed over ``model``; train, prefill and
the absorbed decode run at the local heads.

Under a ``seq`` rule that cuts the cache's sequence
(``launch.sharding.seq_cut``: context-parallel decode) a rank's cache,
a :class:`SeqCache`, holds one contiguous block of the slots, and a
decode step writes the new token on the rank whose block holds its
slot, takes each rank's partial softmax over its block, the global slot
masked by ``kv_len`` (``kernels.chunked.decode_partial``), and merges the
partials over the cut's axes (``chunked.decode_merge``: an all-reduce of
the maxima, one of the weighted sums). Where the sequence is cut on a
``model`` axis that also cuts the query heads, the query (GQA's ``q``,
MLA's absorbed ``q_lat`` and ``qr``) is gathered over ``model``, every
head attends over the rank's block, and the rank keeps its own heads
after the merge; a GQA cache then holds every KV head.
:func:`cut_seq_cache` / :func:`gather_seq_cache` cut a whole cache to the
rank's blocks and gather them back.

Where the rule cuts a train or prefill pass's sequence
(``launch.sharding.seq_block``: context-parallel prefill and training)
each rank computes q, k and v (MLA: q and the latent ``c`` / ``kr``) of
its block, with RoPE at the block's global positions (the layers take
the whole sequence's positions and read their block's); k and v (MLA's
latent) are gathered over the axis in one all-gather, and K4 runs the
block's queries at ``q_offset`` = the block's first position over the
whole keys, causal and windowed as configured (not causal in the
encoder). Over ``model``, a mixer whose heads the axis divides instead
runs its heads on the gathered sequence (``launch.sharding.tp_layer``:
sequence parallelism), K4 at ``q_offset`` 0. A prefill writes each
rank's block of the cache from the whole sequence's keys (:func:`_fill`:
the ring's wrap included; under ``model`` every KV head, gathered over
``model`` where the rank computed only its group's), what
:func:`cut_seq_cache` gives from one process's prefill. Cross attention
reads the whole memory, gathered once a forward.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import chunked, ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models.params import dense_init, ones, param, zeros
from repro_torch.models.rope import apply_mrope, apply_rope

Cache = Optional[Dict[str, Any]]


def gqa_init(gen: torch.Generator, cfg: ModelConfig, *, device=None
             ) -> nn.ParameterDict:
    D = cfg.d_model
    H = cfg.padded_heads()
    KV = cfg.padded_kv_heads()
    Dh = cfg.resolved_head_dim()
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    p = {
        "wq": dense_init(gen, D, H * Dh, **kw),
        "wk": dense_init(gen, D, KV * Dh, **kw),
        "wv": dense_init(gen, D, KV * Dh, **kw),
        "wo": dense_init(gen, H * Dh, D,
                         std=1.0 / math.sqrt(2 * cfg.num_layers * H * Dh),
                         **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H * Dh,), **kw)
        p["bk"] = zeros((KV * Dh,), **kw)
        p["bv"] = zeros((KV * Dh,), **kw)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _rope_qk(q, k, cfg: ModelConfig, positions, mrope_positions=None):
    """M-RoPE only when the configuration has it and ``mrope_positions``
    (3, B, S) are given; plain RoPE on ``positions`` otherwise (an M-RoPE
    model's decode steps, as in the reference)."""
    if cfg.rope == "none":
        return q, k
    if cfg.rope == "mrope" and mrope_positions is not None:
        return (apply_mrope(q, mrope_positions, cfg.rope_theta),
                apply_mrope(k, mrope_positions, cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def heads_sharded(cfg: ModelConfig, tp: int) -> bool:
    """Whether GQA shards its heads over a ``model`` axis of ``tp``: when
    ``tp`` divides the query heads (else it runs whole on every rank)."""
    return cfg.padded_heads() % tp == 0


def kv_sharded(cfg: ModelConfig, tp: int) -> bool:
    """Whether the KV projection is sharded over a ``model`` axis of
    ``tp``: when ``tp`` divides the KV heads. Otherwise every rank keeps
    the whole ``wk`` / ``wv`` / ``bk`` / ``bv``, although ``param_spec``
    may split their flat ``KV * Dh`` columns (the smoke Qwen2's 64 at
    ``tp`` 4, half a head a rank): the port shards at head granularity, as
    the reference's activations do (their ``kv_heads`` constraint falls
    back to replication there)."""
    return cfg.padded_kv_heads() % tp == 0


def straddles(cfg: ModelConfig, tp: int) -> bool:
    """Whether a rank's query heads may read parts of two or more KV
    groups on a ``model`` axis of ``tp``: where ``tp`` divides the query
    heads (:func:`heads_sharded`) and neither it nor the KV heads divide
    the other."""
    KV = cfg.padded_kv_heads()
    return heads_sharded(cfg, tp) and KV % tp != 0 and tp % KV != 0


def local_heads(cfg: ModelConfig, tp: Optional[shd.ModelAxis]
                ) -> Tuple[int, int, Optional[int]]:
    """(query heads, KV heads computed and cached, first of them) of this
    rank. Without a model axis: (H, KV, None). Where the KV projection is
    sharded (:func:`kv_sharded`): (H / tp, KV / tp, None). Where ``tp`` is
    a multiple of KV this rank's query heads all fall in one group: (H /
    tp, 1, that group's KV head). Where they straddle groups
    (:func:`straddles`): (H / tp, KV, None), every KV head, of which
    :func:`kv_read` says which the query heads read."""
    H, KV = cfg.padded_heads(), cfg.padded_kv_heads()
    if tp is None:
        return H, KV, None
    Hl = H // tp.size
    if kv_sharded(cfg, tp.size):
        return Hl, KV // tp.size, None
    if straddles(cfg, tp.size):
        return Hl, KV, None
    return Hl, 1, tp.index * Hl // (H // KV)


KVRead = Tuple[int, int, Optional[Tuple[int, ...]]]


def kv_read(cfg: ModelConfig, tp: Optional[shd.ModelAxis]
            ) -> Optional[KVRead]:
    """Where this rank's query heads straddle KV groups (:func:`straddles`):
    (the first KV head they read, one past the last, and the KV head each
    of them reads counted from the first, or ``None`` where each of those
    KV heads serves as many of them: K4's uniform group then maps them).
    At 12 query heads, 3 KV heads and ``model 4`` rank 1's heads 3-5 read
    ``(0, 1, 1)`` of KV heads 0-1; at 12 and 2 and ``model 3`` rank 1's
    heads 4-7 read KV heads 0 and 1, two heads each. ``None`` elsewhere."""
    if tp is None or not straddles(cfg, tp.size):
        return None
    H, KV = cfg.padded_heads(), cfg.padded_kv_heads()
    Hl = H // tp.size
    groups = [(tp.index * Hl + j) // (H // KV) for j in range(Hl)]
    lo, hi = groups[0], groups[-1] + 1
    if len({groups.count(g) for g in range(lo, hi)}) == 1:
        return lo, hi, None
    return lo, hi, tuple(g - lo for g in groups)


def _read(t: torch.Tensor, sel: Optional[KVRead]) -> torch.Tensor:
    """The KV heads (dim 2 of ``t``, every KV head) this rank's query heads
    read (:func:`kv_read`): their run (a view), or one a query head, by
    index (a copy); ``t`` itself without ``sel``."""
    if sel is None:
        return t
    lo, hi, idx = sel
    if idx is None:
        return t.narrow(2, lo, hi - lo)
    return t[:, :, [lo + i for i in idx]]


def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window and cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


# the reference's cache specs (``transformer._CACHE_SPEC``): GQA's k / v
# (B, C, KV, Dh), MLA's c / kr (B, C, lora) and (B, C, dr)
KV_CACHE_SPEC = ("batch", "seq", "kv_heads", None)
LATENT_CACHE_SPEC = ("batch", "seq", None)


class SeqCache(dict):
    """A layer's attention cache (GQA's ``k`` / ``v``, MLA's ``c`` /
    ``kr``: dim 1 the sequence) and ``capacity``, the length of the
    whole sequence. Under a ``seq`` rule that cuts it
    (:func:`launch.sharding.seq_cut`) a rank holds one contiguous block of
    the slots, ``[index * capacity / n, (index + 1) * capacity / n)``, as
    a NamedSharding lays it out; otherwise the whole sequence."""

    def __init__(self, tensors: Dict[str, torch.Tensor], capacity: int):
        super().__init__(tensors)
        self.capacity = capacity


def kv_seq_cut(cfg: ModelConfig, batch: int, capacity: int,
               record: bool = True) -> Optional[shd.SeqAxis]:
    """How the bound ``seq`` rule cuts a GQA cache of ``capacity`` slots
    (the reference's spec on the whole leaf), ``None`` where it stays
    whole (``launch.sharding.seq_cut``)."""
    return shd.seq_cut((batch, capacity, cfg.padded_kv_heads(),
                        cfg.resolved_head_dim()), KV_CACHE_SPEC,
                       record=record)


def _cache_kv_heads(cfg: ModelConfig, cut: Optional[shd.SeqAxis]
                    ) -> Tuple[int, Optional[int]]:
    """(KV heads, first KV head) the cache of this rank holds: its own
    (:func:`local_heads`), or every KV head where the sequence is cut on
    ``model`` (each rank attends all query heads over its block; the
    reference leaves ``kv_heads`` whole there, as ``model`` cannot be
    mapped twice, and every rank holds the whole KV projection)."""
    if cut is not None and "model" in cut.axes:
        return cfg.padded_kv_heads(), None
    _, KV, kv0 = local_heads(cfg, shd.model_axis())
    return KV, kv0


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   device=None) -> SeqCache:
    """Zeros for this rank's KV heads (:func:`local_heads`) and its block
    of the sequence under a ``seq`` rule (:class:`SeqCache`)."""
    C = cache_capacity(cfg, max_len)
    with shd.runs_whole(cfg.padded_heads()):
        cut = kv_seq_cut(cfg, batch, C)
        KV, _ = _cache_kv_heads(cfg, cut)
    Dh = cfg.resolved_head_dim()
    L = C if cut is None else C // cut.size
    dt = dtype or getattr(torch, cfg.dtype)
    return SeqCache({
        "k": torch.zeros((batch, L, KV, Dh), dtype=dt, device=device),
        "v": torch.zeros((batch, L, KV, Dh), dtype=dt, device=device),
    }, C)


def _part_cut(cfg: ModelConfig, part: SeqCache):
    """(the cut of ``part``'s sequence, the KV heads a cut block holds and
    its first, those the default rules lay out and their first; KV heads
    ``None`` for MLA's latent cache)."""
    if "c" in part:
        return (latent_seq_cut(cfg, part["c"].shape[0], part.capacity),
                None, None, None)
    with shd.runs_whole(cfg.padded_heads()):
        cut = kv_seq_cut(cfg, part["k"].shape[0], part.capacity)
        KV, kv0 = _cache_kv_heads(cfg, cut)
        _, KVd, kv0d = local_heads(cfg, shd.model_axis())
        tp = shd.model_axis()
    return cut, (KV, kv0), (KVd, kv0d), tp


def cut_seq_cache(cfg: ModelConfig, part: SeqCache) -> SeqCache:
    """This rank's block of a whole attention cache ``part`` (as a prefill
    under the default rules leaves it) under the bound ``seq`` rule, a
    copy; ``part`` itself where the rule does not cut it. Where the
    sequence is cut on ``model`` and the rank held only its group's KV
    head, every KV head is gathered over ``model`` first (each rank then
    attends every query head over its block). The counterpart of the
    reference's ``jit(in_shardings=)`` resharding a prefill's cache for
    the decode step."""
    cut, held, default, tp = _part_cut(cfg, part)
    if cut is None and held == default:
        return part
    C = part.capacity
    out = {}
    for n, t in part.items():
        if t.shape[1] != C:
            raise ValueError(f"cut_seq_cache takes a whole cache: {n!r} "
                             f"holds {t.shape[1]} of {C} slots")
        if held is not None and held != default:
            t = _every_kv_head(cfg, t, tp)
        if cut is not None:
            L = C // cut.size
            t = t.narrow(1, cut.index * L, L)
        out[n] = t.clone()
    return SeqCache(out, C)


def gather_seq_cache(cfg: ModelConfig, part: SeqCache) -> SeqCache:
    """The whole attention cache, laid out as the default rules lay it out
    (:func:`gqa_init_cache` without a ``seq`` rule), from every rank's
    block under the bound ``seq`` rule: the inverse of
    :func:`cut_seq_cache` (an all-gather over the cut's axes); ``part``
    itself where the rule does not cut it."""
    cut, held, default, _ = _part_cut(cfg, part)
    if cut is None and held == default:
        return part
    out = {}
    for n, t in part.items():
        if cut is not None:
            t = mesh_lib.all_gather(t, cut.group, 1)
        if held is not None and held != default:
            t = t.narrow(2, default[1], default[0]).contiguous()
        out[n] = t
    return SeqCache(out, part.capacity)


def _every_kv_head(cfg: ModelConfig, t: torch.Tensor,
                   tp: shd.ModelAxis) -> torch.Tensor:
    """Every KV head of a cache leaf (B, C, 1, Dh) of which each rank of
    ``model`` holds its query heads' group's head: gathered over
    ``model``, each head taken from the first rank that holds it."""
    H, KV = cfg.padded_heads(), cfg.padded_kv_heads()
    Hl = H // tp.size
    heads = [r * Hl // (H // KV) for r in range(tp.size)]
    every = mesh_lib.all_gather(t, tp.group, 2)
    return every[:, :, [heads.index(g) for g in range(KV)]]


def _block(cache: Dict[str, torch.Tensor], name: str,
           cut: Optional[shd.SeqAxis]) -> int:
    """This rank's first slot of the cache's sequence; raises where the
    cache does not hold the block the rule gives it (a whole cache under
    the rule, or a block without it)."""
    C = getattr(cache, "capacity", cache[name].shape[1])
    L = C if cut is None else C // cut.size
    if cache[name].shape[1] != L:
        raise ValueError(
            f"the cache's {name!r} holds {cache[name].shape[1]} slots of "
            f"{C}; the bound 'seq' rule gives this rank {L}: cut the cache "
            f"under the rule (Model.cut_cache)")
    return 0 if cut is None else cut.index * L


def _block_write(cache_t: torch.Tensor, new: torch.Tensor,
                 pos: Union[int, torch.Tensor], capacity: int, start: int
                 ) -> None:
    """Write the one token ``new`` (B, 1, ...) at global slot ``pos %
    capacity`` into this rank's block of the sequence, which starts at
    ``start``, in place, on the rank whose block holds that slot only. A
    ``pos`` on the meta device (the dry run's trace) has no value: the
    write goes by index on the traced rank, as :func:`_write_at`'s."""
    if isinstance(pos, torch.Tensor) and pos.is_meta:
        idx = (pos % capacity - start).reshape(1)
        cache_t[:, idx] = new.to(cache_t.dtype)
        return
    slot = int(pos) % capacity - start
    if 0 <= slot < cache_t.shape[1]:
        cache_t[:, slot] = new[:, 0].to(cache_t.dtype)


def _fill(cache_t: torch.Tensor, new: torch.Tensor, pos0: int,
          capacity: int, start: int) -> None:
    """Write the whole sequence ``new`` (B, S, ...), positions ``[pos0,
    pos0 + S)``, into the cache leaf ``cache_t``, in place: into the whole
    ring (:func:`_ring_write`), or where it holds the block of slots
    ``[start, start + L)`` of ``capacity``, each slot from the last
    position that lands on it (``p % capacity``), a slot no position
    reaches left as it is. The slots are reckoned on the host, so that a
    cache on the meta device (the dry run's trace) takes the same
    write."""
    L = cache_t.shape[1]
    if L == capacity:
        _ring_write(cache_t, new, pos0)
        return
    last = int(pos0) + new.shape[1] - 1
    slots = torch.arange(start, start + L)
    p = last - (last - slots) % capacity
    ok = p >= int(pos0)
    idx = (slots[ok] - start).to(cache_t.device)
    src = (p[ok] - int(pos0)).to(new.device)
    cache_t[:, idx] = new[:, src].to(cache_t.dtype)


def _merge(o, m, l, cut: shd.SeqAxis) -> torch.Tensor:
    """The ranks' partials merged over ``cut``'s group
    (``chunked.decode_merge``) through the counted collectives."""
    return chunked.decode_merge(
        o, m, l, lambda t, op: mesh_lib.all_reduce(t, cut.group, op))


def _ring_write(cache_kv: torch.Tensor, new: torch.Tensor,
                pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """Write (B, S, KV, Dh) ``new`` at positions [pos, pos+S) modulo
    capacity, in place; returns ``cache_kv``.

    Works for both plain caches (pos+S <= C by construction) and SWA rings.
    """
    S = new.shape[1]
    C = cache_kv.shape[1]
    dev = cache_kv.device
    if S >= C:
        # keep the last C entries, aligned to ring slots of their positions
        last = new[:, -C:]
        start = (pos + S - C) % C
        idx = (start + torch.arange(C, device=dev)) % C
        cache_kv[:, idx] = last.to(cache_kv.dtype)
        return cache_kv
    idx = (pos + torch.arange(S, device=dev)) % C
    cache_kv[:, idx] = new.to(cache_kv.dtype)
    return cache_kv


def gqa_apply(p: nn.ParameterDict, x: torch.Tensor, *, cfg: ModelConfig,
              **kw) -> Tuple[torch.Tensor, Cache]:
    """GQA attention (:func:`_gqa_apply`, whose keywords it takes) as
    ``launch.sharding.tp_layer`` runs a layer of the query heads: whole on
    every rank where the ``model`` axis does not divide them
    (:func:`heads_sharded`), on the gathered sequence where it divides
    them and cuts the sequence."""
    return shd.tp_layer(cfg.padded_heads(), _gqa_apply, p, x, cfg=cfg, **kw)


def _gqa_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,               # (B, S, D)
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,       # (B, S) absolute positions
    mode: str = "train",
    cache: Cache = None,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid length (decode)
    pos0: Union[int, torch.Tensor] = 0,     # position of x[:, 0] (cache write)
    mrope_positions: Optional[torch.Tensor] = None,   # (3, B, S) M-RoPE
    causal: bool = True,
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Cache]:
    """``pos0`` is the position of the first token, the scalar the
    reference reads back from ``positions[0, 0]``; the caller passes it so
    that a Python int stays on the host and the cache write needs no
    device-to-host copy. The cache holds k after its rotation, so the
    decode steps after an M-RoPE prefill read the M-RoPE keys. Tensor
    parallel under a bound mesh (the module's docstring): the KV
    projection that every rank keeps whole enters with
    ``copy_to_model``, so that its gradient, of which each rank computes
    its own query heads' part, is summed over ``model``. Where they
    straddle KV groups (:func:`kv_read`) every KV head is computed and
    cached, and K4 and the decode read the rank's. ``positions`` (and
    ``mrope_positions``) are the whole sequence's; on a block, the
    block's are read."""
    positions = shd.block_rows(positions)
    mrope_positions = shd.block_rows(mrope_positions, 2)
    B, S, D = x.shape
    tp = shd.model_axis()
    H, KV, kv0 = local_heads(cfg, tp)
    sel = kv_read(cfg, tp)
    Dh = cfg.resolved_head_dim()
    cut = None
    if mode == "decode" and cache is not None:
        C = getattr(cache, "capacity", cache["k"].shape[1])
        cut = kv_seq_cut(cfg, B, C, record=False)
        KV, kv0 = _cache_kv_heads(cfg, cut)
    kv = _kv_leaves(p, cfg, KV, kv0, sel)

    x = shd.copy_to_model(x)
    q = x @ p["wq"]
    k = x @ kv["wk"]
    v = x @ kv["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KV, Dh)
    v = v.reshape(B, S, KV, Dh)
    q, k = _rope_qk(q, k, cfg, positions, mrope_positions)

    window = cfg.sliding_window or 0
    if mode in ("train", "prefill"):
        block = shd.seq_block()
        q_offset = 0
        if block is not None:
            kv_all = shd.gather_seq(torch.cat([k, v], -1), block)
            k, v = kv_all[..., :Dh], kv_all[..., Dh:]
            q_offset = block.start
        out = ops.attention(q, _read(k, sel), _read(v, sel), causal=causal,
                            window=window, q_offset=q_offset,
                            backend=backend)
        new_cache = None
        if mode == "prefill":
            _gqa_fill(cfg, cache, k, v, pos0, tp)
            new_cache = cache
    elif mode == "decode":
        if S != 1 or cache is None:
            raise ValueError(f"decode takes one token and a cache, got "
                             f"S={S} and cache={cache is not None}")
        start = _block(cache, "k", cut)
        if kv_len is None:
            kv_len = torch.full((B,), int(pos0) + 1, dtype=torch.int32,
                                device=x.device)
        eff_len = torch.clamp(kv_len, max=C)
        if cut is None:
            ck = _ring_write(cache["k"], k, pos0)
            cv = _ring_write(cache["v"], v, pos0)
            out = ops.decode_attention(q, _read(ck, sel), _read(cv, sel),
                                       kv_len=eff_len, backend=backend)
        else:
            out = _cp_decode(q, k, v, cache, pos0, eff_len, C, start, cut,
                             tp, backend, sel)
        new_cache = cache
    else:
        raise ValueError(mode)

    out = out.reshape(B, S, H * Dh)
    return shd.tp_row_matmul(out, p["wo"], "heads"), new_cache


def _kv_leaves(p: nn.ParameterDict, cfg: ModelConfig, KV: int,
               kv0: Optional[int], sel: Optional[KVRead]
               ) -> Dict[str, torch.Tensor]:
    """The KV projection's leaves (``wk``, ``wv`` and their biases) as a
    rank reads them: its own where they are sharded, else the whole
    leaves, entered with ``copy_to_model`` where the rank reads only part
    of them (``KV`` heads from ``kv0``, or the KV heads ``sel`` picks), so
    that their gradients, each rank's at its own query heads, are summed
    over ``model``."""
    kv = {n: p[n] for n in (("wk", "wv", "bk", "bv") if cfg.qkv_bias
                            else ("wk", "wv"))}
    if kv0 is not None:
        Dh = cfg.resolved_head_dim()
        cols = slice(kv0 * Dh, (kv0 + KV) * Dh)
        return {n: shd.copy_to_model(w)[..., cols] for n, w in kv.items()}
    if sel is not None:
        return {n: shd.copy_to_model(w) for n, w in kv.items()}
    return kv


def _gqa_fill(cfg: ModelConfig, cache: SeqCache, k: torch.Tensor,
              v: torch.Tensor, pos0: int, tp: Optional[shd.ModelAxis]
              ) -> None:
    """A prefill's write of the whole sequence's ``k`` and ``v`` into this
    rank's cache: its block under a ``seq`` rule that cuts the capacity
    (every KV head, gathered over ``model``, where the cut is on a
    ``model`` axis and the rank computed only its group's: as
    :func:`cut_seq_cache`), else the whole ring."""
    B = k.shape[0]
    C = getattr(cache, "capacity", cache["k"].shape[1])
    cut = kv_seq_cut(cfg, B, C, record=False)
    start = _block(cache, "k", cut)
    held = _cache_kv_heads(cfg, cut)
    if held != local_heads(cfg, tp)[1:]:
        k, v = _every_kv_head(cfg, k, tp), _every_kv_head(cfg, v, tp)
    _fill(cache["k"], k, pos0, C, start)
    _fill(cache["v"], v, pos0, C, start)


def _cp_decode(q, k, v, cache, pos0, kv_len, capacity: int, start: int,
               cut: shd.SeqAxis, tp: Optional[shd.ModelAxis],
               backend: str, sel: Optional[KVRead] = None) -> torch.Tensor:
    """Context-parallel GQA decode: the new token's k and v written on the
    rank whose block holds its slot; each rank's partial softmax over its
    block (the global slot masked by ``kv_len``), merged over the cut's
    axes. Where the sequence is cut on a ``model`` axis that also cuts the
    query heads, ``q`` is gathered over ``model`` first, the partials
    taken for every head and this rank's heads kept after the merge;
    otherwise the rank's query heads read the KV heads ``sel`` picks
    (:func:`kv_read`)."""
    _block_write(cache["k"], k, pos0, capacity, start)
    _block_write(cache["v"], v, pos0, capacity, start)
    ops.check_backend(backend, q)
    Hl = q.shape[2]
    gather = tp is not None and "model" in cut.axes
    ck, cv = cache["k"], cache["v"]
    if gather:
        q = shd.gather_from_model(q, dim=2)
    else:
        ck, cv = _read(ck, sel), _read(cv, sel)
    o, m, l = chunked.decode_partial(q, ck, cv, kv_len=kv_len, offset=start)
    out = _merge(o, m, l, cut)
    if gather:
        out = out.narrow(2, tp.index * Hl, Hl)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_init(gen: torch.Generator, cfg: ModelConfig, *, device=None
               ) -> nn.ParameterDict:
    return gqa_init(gen, cfg, device=device)


def cross_apply(p: nn.ParameterDict, x: torch.Tensor, memory: torch.Tensor,
                *, cfg: ModelConfig, backend: str = "cuda") -> torch.Tensor:
    """Cross attention (:func:`_cross_apply`) as
    ``launch.sharding.tp_layer`` runs a layer of the query heads (the
    memory, whole on every rank, entered as a leaf is)."""
    return shd.tp_layer(cfg.padded_heads(), _cross_apply, p, x, memory,
                        cfg=cfg, backend=backend)


def _cross_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,               # (B, S_dec, D) decoder states
    memory: torch.Tensor,          # (B, S_enc, D) encoder output
    *,
    cfg: ModelConfig,
    backend: str = "cuda",
) -> torch.Tensor:
    """Full (non-causal) attention of the decoder's queries over the
    encoder's memory, no rope (K4 on ``backend="cuda"``, at S_dec = 1 in a
    decode step too). K and V are computed from ``memory`` on every call:
    there is no cross-attention cache, as in the reference. Tensor
    parallel as GQA (:func:`_gqa_apply`): this rank's heads, ``x`` and
    ``memory`` entered with ``copy_to_model``, ``wo`` row-parallel."""
    B, S, D = x.shape
    Sm = memory.shape[1]
    tp = shd.model_axis()
    H, KV, kv0 = local_heads(cfg, tp)
    sel = kv_read(cfg, tp)
    Dh = cfg.resolved_head_dim()
    kv = _kv_leaves(p, cfg, KV, kv0, sel)
    x = shd.copy_to_model(x)
    memory = shd.copy_to_model(memory)
    q = x @ p["wq"]
    k = memory @ kv["wk"]
    v = memory @ kv["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    out = ops.attention(q.reshape(B, S, H, Dh),
                        _read(k.reshape(B, Sm, KV, Dh), sel),
                        _read(v.reshape(B, Sm, KV, Dh), sel), causal=False,
                        backend=backend)
    return shd.tp_row_matmul(out.reshape(B, S, H * Dh), p["wo"], "heads")


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig, *, device=None
             ) -> nn.ParameterDict:
    m = cfg.mla
    D = cfg.d_model
    H = cfg.padded_heads()
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    p = {}
    if m.q_lora_rank > 0:
        p["wq_a"] = dense_init(gen, D, m.q_lora_rank, **kw)
        p["q_norm"] = ones((m.q_lora_rank,), dt, device)
        p["wq_b"] = dense_init(gen, m.q_lora_rank, H * (dn + dr), **kw)
    else:
        p["wq"] = dense_init(gen, D, H * (dn + dr), **kw)
    p["wkv_a"] = dense_init(gen, D, m.kv_lora_rank + dr, **kw)
    p["kv_norm"] = ones((m.kv_lora_rank,), dt, device)
    p["wkv_b"] = dense_init(gen, m.kv_lora_rank, H * (dn + dv), **kw)
    p["wo"] = dense_init(gen, H * dv, D,
                         std=1.0 / math.sqrt(2 * cfg.num_layers * H * dv),
                         **kw)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def latent_seq_cut(cfg: ModelConfig, batch: int, capacity: int,
                   record: bool = True) -> Optional[shd.SeqAxis]:
    """How the bound ``seq`` rule cuts MLA's latent cache of ``capacity``
    slots, ``None`` where it stays whole."""
    return shd.seq_cut((batch, capacity, cfg.mla.kv_lora_rank),
                       LATENT_CACHE_SPEC, record=record)


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   device=None) -> SeqCache:
    """Zeros for the latent cache, whole on every rank of ``model``, and
    this rank's block of the sequence under a ``seq`` rule
    (:class:`SeqCache`)."""
    m = cfg.mla
    dt = dtype or getattr(torch, cfg.dtype)
    cut = latent_seq_cut(cfg, batch, max_len)
    L = max_len if cut is None else max_len // cut.size
    return SeqCache({
        "c": torch.zeros((batch, L, m.kv_lora_rank), dtype=dt,
                         device=device),
        "kr": torch.zeros((batch, L, m.qk_rope_head_dim), dtype=dt,
                          device=device),
    }, max_len)


def _mla_q(p, x, cfg: ModelConfig, positions, B, S, *, backend: str):
    """(q_nope, q_rope) at this rank's heads; the normed latent (or ``x``
    without ``q_lora_rank``) entered with ``copy_to_model``."""
    m = cfg.mla
    H = shd.local_size(cfg.padded_heads())
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    if m.q_lora_rank > 0:
        q = shd.copy_to_model(ops.rmsnorm(
            x @ p["wq_a"], p["q_norm"], cfg.norm_eps,
            backend=backend)) @ p["wq_b"]
    else:
        q = shd.copy_to_model(x) @ p["wq"]
    q = q.reshape(B, S, H, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    if cfg.rope != "none":
        qr = apply_rope(qr, positions, cfg.rope_theta)
    return qn, qr


def _mla_ckv(p, x, cfg: ModelConfig, positions, B, S, *, backend: str):
    m = cfg.mla
    dr = m.qk_rope_head_dim
    ckv = x @ p["wkv_a"]                                     # (B,S,lora+dr)
    c, kr = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    # K5's wrapper takes contiguous rows only: the slice is copied
    c = ops.rmsnorm(c.contiguous(), p["kv_norm"], cfg.norm_eps,
                    backend=backend)
    if cfg.rope != "none":
        kr = apply_rope(kr.reshape(B, S, 1, dr), positions,
                        cfg.rope_theta).reshape(B, S, dr)
    return c, kr


def _write_at(cache_t: torch.Tensor, new: torch.Tensor,
              start: Union[int, torch.Tensor]) -> None:
    """``dynamic_update_slice(cache, new.astype(cache.dtype), (0, start,
    0))`` in place: positions [start, start + S) of every row (the cache
    is ``max_len`` long, so the slice fits). A ``start`` on the meta
    device (the dry run's trace) has no value to read: the write goes by
    index, the same elements."""
    if isinstance(start, torch.Tensor) and start.is_meta:
        idx = start + torch.arange(new.shape[1], device=start.device)
        cache_t[:, idx] = new.to(cache_t.dtype)
        return
    start = int(start)
    cache_t[:, start:start + new.shape[1]] = new.to(cache_t.dtype)


def mla_apply(p: nn.ParameterDict, x: torch.Tensor, *, cfg: ModelConfig,
              **kw) -> Tuple[torch.Tensor, Cache]:
    """MLA (:func:`_mla_apply`, whose keywords it takes) as
    ``launch.sharding.tp_layer`` runs a layer of the heads."""
    return shd.tp_layer(cfg.padded_heads(), _mla_apply, p, x, cfg=cfg, **kw)


def _mla_apply(
    p: nn.ParameterDict,
    x: torch.Tensor,               # (B, S, D)
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,       # (B, S) absolute positions
    mode: str = "train",
    cache: Cache = None,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid length (decode)
    pos0: Union[int, torch.Tensor] = 0,     # position of x[:, 0] (cache write)
    causal: bool = True,
    backend: str = "cuda",
) -> Tuple[torch.Tensor, Cache]:
    """Train and prefill expand the latent to per-head keys and values and
    attend (K4 on ``backend="cuda"``, q/k head dim dn + dr, v head dim dv,
    v a slice of the expanded product); prefill also writes ``c`` and
    ``kr`` into the cache at ``pos0``, rounded to the cache's dtype there
    and only there. Decode is the absorbed form, in float32 as the
    reference computes it: q_nope through W_uk into the latent space,
    scores against the cached latent plus the rope part, the ``kv_len``
    mask, softmax, the latent output through W_uv, then the cast back.
    Every step runs at this rank's heads (``shd.local_size``), ``wo``
    row-parallel; the latent cache is whole on every rank. ``positions``
    are the whole sequence's; on a block, the block's are read."""
    positions = shd.block_rows(positions)
    m = cfg.mla
    B, S, D = x.shape
    H = shd.local_size(cfg.padded_heads())
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    scale = (dn + dr) ** -0.5

    qn, qr = _mla_q(p, x, cfg, positions, B, S, backend=backend)

    if mode in ("train", "prefill"):
        c, kr = _mla_ckv(p, x, cfg, positions, B, S, backend=backend)
        block = shd.seq_block()
        q_offset, Sk = 0, S
        if block is not None:
            ckr = shd.gather_seq(torch.cat([c, kr], -1), block)
            c, kr = ckr[..., :m.kv_lora_rank], ckr[..., m.kv_lora_rank:]
            q_offset, Sk = block.start, block.total
        kv = (shd.copy_to_model(c) @ p["wkv_b"]).reshape(B, Sk, H, dn + dv)
        kn, v = kv[..., :dn], kv[..., dn:]
        krh = shd.copy_to_model(kr)[:, :, None, :].expand(B, Sk, H, dr)
        k = torch.cat([kn, krh], -1)
        q = torch.cat([qn, qr], -1)
        out = ops.attention(q, k, v, causal=causal, scale=scale,
                            q_offset=q_offset, backend=backend)
        new_cache = None
        if mode == "prefill":
            C = getattr(cache, "capacity", cache["c"].shape[1])
            start = _block(cache, "c", latent_seq_cut(cfg, B, C,
                                                      record=False))
            if cache["c"].shape[1] == C:
                _write_at(cache["c"], c, pos0)
                _write_at(cache["kr"], kr, pos0)
            else:
                _fill(cache["c"], c, pos0, C, start)
                _fill(cache["kr"], kr, pos0, C, start)
            new_cache = cache
    elif mode == "decode":
        if S != 1 or cache is None:
            raise ValueError(f"decode takes one token and a cache, got "
                             f"S={S} and cache={cache is not None}")
        c_new, kr_new = _mla_ckv(p, x, cfg, positions, B, S, backend=backend)
        C = getattr(cache, "capacity", cache["c"].shape[1])
        cut = latent_seq_cut(cfg, B, C, record=False)
        start = _block(cache, "c", cut)
        if cut is None:
            _write_at(cache["c"], c_new, pos0)
            _write_at(cache["kr"], kr_new, pos0)
        else:
            _block_write(cache["c"], c_new, pos0, C, start)
            _block_write(cache["kr"], kr_new, pos0, C, start)
        cc, ckr = cache["c"], cache["kr"]
        if kv_len is None:
            kv_len = torch.full((B,), int(pos0) + 1, dtype=torch.int32,
                                device=x.device)
        # absorbed decode: q_nope into the latent space once, then attend
        # against the compressed cache (never expanding all S positions)
        wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H, dn + dv)
        w_uk = wkv_b[..., :dn]                               # (lora, H, dn)
        w_uv = wkv_b[..., dn:]                               # (lora, H, dv)
        ccf = cc.float()
        q_lat = torch.einsum("bqhd,lhd->bqhl", qn.float(), w_uk.float())
        qrf = qr.float()
        tp = shd.model_axis()
        gather = cut is not None and tp is not None and "model" in cut.axes
        if gather:
            # every head's query over this rank's block of the slots
            both = shd.gather_from_model(torch.cat([q_lat, qrf], -1), 2)
            q_lat, qrf = both[..., :m.kv_lora_rank], both[..., m.kv_lora_rank:]
        s = (torch.einsum("bqhl,bsl->bhqs", q_lat, ccf) +
             torch.einsum("bqhd,bsd->bhqs", qrf, ckr.float())
             ) * scale                                       # (B,H,1,C)
        kpos = start + torch.arange(cc.shape[1], device=x.device)
        mask = kpos[None, :] < kv_len.to(x.device)[:, None]  # (B, C)
        if cut is None:
            s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
            w = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhqs,bsl->bqhl", w, ccf)
        else:
            w, mx, l = chunked.partial_softmax(s, mask[:, None, None, :])
            o_lat = _merge(torch.einsum("bhqs,bsl->bqhl", w, ccf), mx, l,
                           cut)
            if gather:
                o_lat = o_lat.narrow(2, tp.index * H, H)
        out = torch.einsum("bqhl,lhd->bqhd", o_lat,
                           w_uv.float()).to(x.dtype)
        new_cache = cache
    else:
        raise ValueError(mode)

    out = out.reshape(B, S, H * dv)
    return shd.tp_row_matmul(out, p["wo"], "heads"), new_cache
