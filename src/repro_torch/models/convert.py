"""Load the JAX package's parameter tree into the port's ``Model``.

``params_from_jax(tree, cfg, device=...)`` takes the tree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the JAX side; this module imports
no JAX) and returns a ``Model`` holding the same values. bfloat16 leaves
arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so
every leaf goes through float32 (exact for bfloat16) and is cast to the
configuration's ``param_dtype`` on the device. The body slots' leading
``(n_periods, ...)`` axis is unstacked into per-layer blocks, and so is
the encoder's one slot ``enc_body/0`` (leading axis
``num_encoder_layers``) into ``enc_blocks.{i}``; the ``prefix`` layers
(DeepSeek-V3's dense ones) and the ``mtp`` subtree map by name
(``mtp/block/mixer/wq_a`` to ``mtp.block.mixer.wq_a``), and so do
``pos_embed``, ``enc_norm``, a decoder layer's ``cross_norm`` and
``cross`` leaves and an MLA mixer's (``wq_a``, ``q_norm``, ``wq_b`` or
``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``). Every leaf lands
exactly once:
a leaf with no place in the model, a model parameter no leaf filled, or a
shape that differs raises ``ValueError``. :func:`jax_path` is the map the
other way, from a parameter's name to its leaf's path in the reference's
tree (the optimizer's decay mask reads leaf names and ranks from it).

On a mesh whose ``model`` axis is larger than 1, ``params_from_jax(...,
mesh=)`` loads the whole tree as above and then keeps this rank's shard
of each leaf (:func:`shard_params`, by ``Model.spec``); the way back is
``Model.gather`` leaf by leaf, whose whole leaves :func:`reference_tree`
takes.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Stacked
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.api import Model


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _targets(tree: Dict[str, Any], cfg: ModelConfig
             ) -> Iterator[Tuple[str, str, Any]]:
    """(model parameter name, tree path, array) for every leaf, with the
    stacked body and encoder leaves split into one array per layer."""
    prefix, kinds, n_periods = tfm.layer_layout(cfg)
    P = len(kinds)
    for path, leaf in _leaves(tree):
        parts = path.strip("/").split("/")
        if parts[0] == "prefix":
            i, rest = int(parts[1]), ".".join(parts[2:])
            yield f"blocks.{i}.{rest}", path, np.asarray(leaf)
        elif parts[0] in ("body", "enc_body"):
            j, rest = int(parts[1]), ".".join(parts[2:])
            arr = np.asarray(leaf)
            if parts[0] == "body":
                n, name = n_periods, lambda t: f"blocks.{prefix + t * P + j}"
            else:       # one slot of num_encoder_layers uniform layers
                n, name = cfg.num_encoder_layers, lambda t: f"enc_blocks.{t}"
            if arr.shape[0] != n:
                raise ValueError(f"{path}: leading axis {arr.shape[0]}, "
                                 f"expected {n} periods")
            for t in range(n):
                yield f"{name(t)}.{rest}", f"{path}[{t}]", arr[t]
        else:
            yield ".".join(parts), path, np.asarray(leaf)


def jax_path(name: str, cfg: ModelConfig) -> Tuple[str, bool]:
    """The path (``/body/0/mixer/wq``) of the reference's leaf that holds
    the port's parameter ``name`` (``blocks.0.mixer.wq``), and whether the
    reference stacks it (a leading period axis: the body slots and the
    encoder's one slot), so that its rank there is one more than here."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, rest = int(parts[1]), "/".join(parts[2:])
        prefix, kinds, _ = tfm.layer_layout(cfg)
        if i < prefix:
            return f"/prefix/{i}/{rest}", False
        return f"/body/{(i - prefix) % len(kinds)}/{rest}", True
    if parts[0] == "enc_blocks":
        return f"/enc_body/0/{'/'.join(parts[2:])}", True
    return "/" + "/".join(parts), False


def reference_tree(named: Dict[str, Any], cfg: ModelConfig) -> Dict:
    """The reference's tree (nested dicts, and lists where the reference
    has lists) holding the values of ``named`` (by the port's parameter
    names): an unstacked leaf is its value, a stacked one a ``Stacked`` of
    its layers' values in period order. Raises ``ValueError`` if a
    stacked leaf misses a period."""
    root: Dict[str, Any] = {}
    layers: Dict[str, Dict[int, Any]] = {}
    prefix, kinds, _ = tfm.layer_layout(cfg)
    for n, v in named.items():
        path, stacked = jax_path(n, cfg)
        if stacked:
            i = int(n.split(".")[1])
            t = i if n.startswith("enc_blocks.") else (i - prefix) // len(kinds)
            layers.setdefault(path, {})[t] = v
        else:
            _insert(root, path, v)
    for path, by_t in layers.items():
        if sorted(by_t) != list(range(len(by_t))):
            raise ValueError(f"{path}: periods {sorted(by_t)}")
        _insert(root, path, Stacked(by_t[t] for t in range(len(by_t))))
    return _listify(root)


def train_state_tree(named: Dict[str, Any], opt_state, cfg: ModelConfig):
    """``(params, (step, mu, nu))`` in the reference's layout: what
    ``launch.train`` saves and restores (the reference's tree of
    ``(params, OptState)``)."""
    return (reference_tree(named, cfg),
            (opt_state.step, reference_tree(opt_state.mu, cfg),
             reference_tree(opt_state.nu, cfg)))


def _insert(root: Dict, path: str, value) -> None:
    *parents, leaf = path.strip("/").split("/")
    node = root
    for k in parents:
        node = node.setdefault(k, {})
    node[leaf] = value


def _listify(node):
    """Dicts keyed 0..n-1 become lists, as the reference's are."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and \
            sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def shard_params(model: Model, mesh) -> Model:
    """A model on ``mesh`` holding this rank's shard of each of
    ``model``'s whole parameters (moved out of ``model``, leaf by leaf: a
    cut leaf is copied and its whole freed)."""
    sharded = Model(model.cfg, device=model.device, mesh=mesh)
    sharded.params = tfm._kept(sharded.shard, "", model._p())
    model.params = None
    return sharded


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device=None, mesh=None) -> Model:
    """The reference's tree loaded whole, then on ``mesh`` cut to this
    rank's shards (:func:`shard_params`)."""
    model = Model(cfg, device=device)
    # allocate by drawing (any seed): the values are all overwritten below
    params = model.init(0)
    own = dict(params.named_parameters())
    filled = set()
    for name, path, arr in _targets(tree, cfg):
        if name not in own:
            raise ValueError(f"leaf {path} has no parameter {name!r} in the "
                             f"port's model")
        if name in filled:
            raise ValueError(f"parameter {name!r} filled twice ({path})")
        dst = own[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, the port's "
                             f"{name} is {tuple(dst.shape)}")
        src = torch.from_numpy(np.array(arr, dtype=np.float32))
        with torch.no_grad():
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        filled.add(name)
    left = sorted(set(own) - filled)
    if left:
        raise ValueError(f"no leaf of the tree filled {left}")
    return model if mesh is None else shard_params(model, mesh)
