"""The int8 gradient compression and the cross-pod ring, held against the
JAX package on the CPU.

Held: ``_quantize``, ``_dequantize``, ``quantize_roundtrip`` and
``compressed_pseudo_grad`` against the reference's bit for bit (lengths
1, 255, 256, 257 and 1,000; an all-zero block; exact .5 ties after
scaling; values near float32's largest and smallest normal); the
reference's error-bound and error-feedback tests; and, in ``gloo``
process groups of 2 and 4 CPU ranks (separate processes: this file run
as a script, one process a rank), ``_int8_ring_all_reduce`` on each rank
against the reference's ring on the same device under ``shard_map``
(a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
set before it imports jax, never in the pytest process), the ranks'
results differing as the reference's do, each rank's wire bytes counted
(``(n - 1) x (N_pad + 4 N_pad / 256)``), and ``hierarchical_grad_reduce``
on a ``(pod 2, data 2)`` mesh with ``compress="int8"`` and ``"none"``;
a CUDA tensor refused by the ring on a ``gloo`` group; the ring and
``mean_over`` over one rank the identity.
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCK = 256
RING_LENGTHS = (1000, 257, 1)


def ring_inputs(world):
    """The ring's inputs, one row per rank: float32 vectors of each of
    ``RING_LENGTHS`` and a bf16 (3, 100) matrix."""
    rng = np.random.default_rng(world)
    out = {f"f32_{n}": rng.standard_normal((world, n)).astype(np.float32)
           for n in RING_LENGTHS}
    out["bf16_3x100"] = rng.standard_normal((world, 3, 100)).astype(
        np.float32)
    return out


def tree_inputs():
    """A gradient tree for the (pod 2, data 2) mesh, one row per rank in
    mesh order."""
    rng = np.random.default_rng(17)
    return {"a": rng.standard_normal((4, 1000)).astype(np.float32),
            "b": rng.standard_normal((4, 7, 40)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the two sides' workers (this file run as a script)
# ---------------------------------------------------------------------------


def _jax_oracle(out_path):
    """The reference's ring at 2 and 4 devices and its
    ``hierarchical_grad_reduce`` on a (pod 2, data 2) mesh, each device's
    result, into an ``.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.optim.compress import (_int8_ring_all_reduce,
                                      hierarchical_grad_reduce)
    assert len(jax.devices()) == 4, jax.devices()
    res = {}
    for world in (2, 4):
        mesh = jax.make_mesh((world,), ("pod",), devices=jax.devices()[:world])
        for name, x in ring_inputs(world).items():
            xs = jnp.asarray(x)
            if name.startswith("bf16"):
                xs = xs.astype(jnp.bfloat16)
            f = lambda xl: _int8_ring_all_reduce(xl[0], "pod", world)[None]
            out = jax.shard_map(f, mesh=mesh, in_specs=P("pod"),
                                out_specs=P("pod"), check_vma=False)(xs)
            res[f"ring{world}_{name}"] = np.asarray(out.astype(jnp.float32))
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    for compress in ("int8", "none"):
        def body(tree):
            tree = {k: v[0] for k, v in tree.items()}
            out = hierarchical_grad_reduce(tree, mesh=mesh,
                                           compress=compress)
            return {k: v[None] for k, v in out.items()}
        spec = {k: P(("pod", "data")) for k in ("a", "b")}
        tree = {k: jnp.asarray(v) for k, v in tree_inputs().items()}
        out = jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                            out_specs=spec, check_vma=False)(tree)
        for k, v in out.items():
            res[f"tree_{compress}_{k}"] = np.asarray(v)
    np.savez(out_path, **res)


def _rank(rank, world, rendezvous, out_dir):
    """One rank of the port's side: the ring over a ``(pod,)`` mesh of the
    whole world and, at world 4, ``hierarchical_grad_reduce`` over
    ``(pod 2, data 2)``; results and wire bytes into ``out_dir``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import compress as C
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        res, nbytes = {}, {}
        mesh = mesh_lib.make_mesh(
            mesh_lib.MeshConfig((world,), ("pod",)), device_type="cpu")
        group = mesh_lib.axes_group(mesh, ("pod",))
        for name, x in ring_inputs(world).items():
            t = torch.from_numpy(x[rank])
            if name.startswith("bf16"):
                t = t.to(torch.bfloat16)
            C.reset_wire_bytes()
            out = C._int8_ring_all_reduce(t, group)
            assert out.dtype == t.dtype and out.shape == t.shape
            nbytes[name] = C.wire_bytes()
            res[f"ring{world}_{name}"] = out.float().numpy()
        if world == 4:
            mesh = mesh_lib.make_mesh(
                mesh_lib.MeshConfig((2, 2), ("pod", "data")),
                device_type="cpu")
            idx = mesh_lib.coordinate(mesh, ("pod", "data"))
            assert idx == rank
            for compress in ("int8", "none"):
                tree = {k: torch.from_numpy(v[rank])
                        for k, v in tree_inputs().items()}
                out = C.hierarchical_grad_reduce(tree, mesh=mesh,
                                                 compress=compress)
                for k, v in out.items():
                    res[f"tree_{compress}_{k}"] = v.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(nbytes, f)
    finally:
        dist.destroy_process_group()


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def launch_ranks(world, tmp):
    """Run :func:`_rank` in ``world`` processes; return their results."""
    out = tmp / f"world{world}"
    out.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "rank", str(r), str(world),
         str(tmp / f"rdv{world}"), str(out)], env=_env(), cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return ([dict(np.load(out / f"rank{r}.npz")) for r in range(world)],
            [json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)])


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "oracle.npz"
    proc = subprocess.run(
        [sys.executable, __file__, "jax", str(path)], capture_output=True,
        text=True, cwd=str(ROOT), timeout=300, env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return {w: launch_ranks(w, tmp) for w in (2, 4)}


# ---------------------------------------------------------------------------
# quantization, bit for bit
# ---------------------------------------------------------------------------


def _cases():
    rng = np.random.default_rng(0)
    big = np.float32(3.4e38)
    tiny = np.finfo(np.float32).tiny
    ties = np.zeros(256, np.float32)
    # scale = 127 / 127 = 1: every value an exact .5 tie after scaling
    ties[:254] = np.arange(-127, 127) + 0.5
    ties[-1] = 127.0
    return {
        **{f"len {n}": (rng.standard_normal(n) * 3).astype(np.float32)
           for n in (1, 255, 256, 257, 1000)},
        "zero block": np.concatenate([np.zeros(256, np.float32),
                                      rng.standard_normal(100).astype(
                                          np.float32)]),
        "ties": ties,
        "near max": np.array([big, -big, 1.0, big / 3], np.float32),
        "near smallest normal": (np.array([1.0, -3.0, 0.5, 127.0],
                                          np.float32) * tiny * 4),
        "matrix": rng.standard_normal((7, 40)).astype(np.float32),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_torch_quantize_is_the_references_bit_for_bit(case):
    import jax.numpy as jnp
    from repro.optim import compress as J
    from repro_torch.optim import compress as C
    x = CASES[case]
    flat = x.reshape(-1)
    jq, js = J._quantize(jnp.asarray(flat))
    q, s = C._quantize(torch.from_numpy(flat))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(
        C._dequantize(q, s, flat.size).numpy().view(np.int32),
        np.asarray(J._dequantize(jq, js, flat.size)).view(np.int32))
    got = C.quantize_roundtrip(torch.from_numpy(x))
    want = np.asarray(J.quantize_roundtrip(jnp.asarray(x)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_torch_quantize_rounds_ties_to_even():
    from repro_torch.optim import compress as C
    q, s = C._quantize(torch.from_numpy(CASES["ties"]))
    assert float(s[0]) == 1.0
    want = np.round(CASES["ties"]).astype(np.int8)       # half to even
    np.testing.assert_array_equal(q.reshape(-1).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_compressed_pseudo_grad_is_the_references_bit_for_bit(dtype):
    import jax.numpy as jnp
    from repro.optim import compress as J
    from repro_torch.optim import compress as C
    rng = np.random.default_rng(5)
    grads = {"w": rng.standard_normal((9, 60)).astype(np.float32),
             "b": rng.standard_normal(300).astype(np.float32) * 1e-3}
    jg = {k: jnp.asarray(v).astype(dtype) for k, v in grads.items()}
    tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in grads.items()}
    jres, tres = None, None
    for step in range(3):
        jq, jres = J.compressed_pseudo_grad(jg, jres)
        tq, tres = C.compressed_pseudo_grad(tg, tres)
        for k in grads:
            assert tq[k].dtype == tg[k].dtype
            np.testing.assert_array_equal(
                tq[k].float().numpy(), np.asarray(jq[k].astype(jnp.float32)),
                err_msg=f"step {step} {k}")
            np.testing.assert_array_equal(
                tres[k].numpy().view(np.int32),
                np.asarray(jres[k]).view(np.int32),
                err_msg=f"step {step} residual {k}")


def test_torch_int8_quantize_roundtrip_error_bound():
    from repro_torch.optim.compress import quantize_roundtrip
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32)
        * 3.0)
    q = quantize_roundtrip(x)
    # blockwise symmetric int8: |err| <= blockmax/127/2 per element
    err = (q - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_torch_error_feedback_preserves_signal():
    """Sum of EF-compressed grads converges to sum of true grads."""
    from repro_torch.optim.compress import compressed_pseudo_grad
    rng = np.random.default_rng(1)
    true = [torch.from_numpy(rng.standard_normal(256).astype(np.float32)
                             * 0.01) for _ in range(50)]
    residual, sent = None, []
    for g in true:
        q, residual = compressed_pseudo_grad({"g": g}, residual)
        sent.append(q["g"])
    total_true = sum(float(g.sum()) for g in true)
    total_sent = sum(float(s.sum()) for s in sent)
    assert abs(total_sent - total_true) < 0.05 * abs(total_true) + 0.01


# ---------------------------------------------------------------------------
# the ring and the hierarchical reduce, rank by rank
# ---------------------------------------------------------------------------


def numpy_ring(rows):
    """The reference's ring as its source reads, in numpy float32 (each
    multiply and each add rounded): every rank's result."""
    world, n = rows.shape[0], rows[0].size

    def quantize(v):
        xp = np.pad(v, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
        scale = np.abs(xp).max(axis=1, keepdims=True) / np.float32(127.0)
        q = np.clip(np.round(xp / np.maximum(scale, np.float32(1e-12))),
                    -127, 127).astype(np.int8)
        return (q.astype(np.float32) * scale).reshape(-1)[:n]

    flat = [r.reshape(-1).astype(np.float32) for r in rows]
    acc, send = list(flat), list(flat)
    for _ in range(world - 1):
        recv = [quantize(send[(r - 1) % world]) for r in range(world)]
        acc = [a + b for a, b in zip(acc, recv)]
        send = recv
    return np.stack([a / np.float32(world) for a in acc])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ring_inputs(2)))
def test_torch_int8_ring_matches_the_references_on_every_rank(
        oracle, ranks, world, name):
    """Each rank's result against the reference's on the device of the
    same pod coordinate. Not bit for bit in float32: XLA's CPU backend
    contracts some of the ring's ``acc + q * scale`` into one FMA (a
    float64 FMA transcription gives its bits at some lengths, not all),
    where the port rounds the product and the sum apart, as the
    reference's source reads. So each rank's result is held bit for bit
    to that reading (numpy float32), and to the reference within the
    ``n - 1`` accumulator roundings that can differ. The ranks' results
    differ (each adds its own gradient unquantized), as the reference's
    do, and stay near the exact mean."""
    res, _ = ranks[world]
    want = oracle[f"ring{world}_{name}"].reshape(world, -1)
    x = ring_inputs(world)[name]
    got = np.stack([r[f"ring{world}_{name}"].reshape(-1) for r in res])
    if name.startswith("bf16"):
        # the ring runs in float32 and rounds once to bf16 at the end
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      numpy_ring(x).view(np.int32))
        eps = np.finfo(np.float32).eps
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=world * eps * np.abs(x).max())
    if x[0].size > 1:
        assert not np.array_equal(got[0], got[1])
        mean = x.reshape(world, -1).mean(0)
        assert np.abs(got - mean).max() <= 0.05 * np.abs(mean).max() + 0.05


@pytest.mark.parametrize("world", [2, 4])
def test_torch_int8_ring_counts_its_wire_bytes(ranks, world):
    _, nbytes = ranks[world]
    for name, x in ring_inputs(world).items():
        n_pad = -(-x[0].size // BLOCK) * BLOCK
        want = (world - 1) * (n_pad + 4 * n_pad // BLOCK)
        assert [b[name] for b in nbytes] == [want] * world, name
    # 1.0156 bytes an element a step, against a bf16 ring's 2 (n - 1) / n x 2
    per_elem = (world - 1) * (1 + 4 / BLOCK)
    bf16 = 2 * (world - 1) / world * 2
    assert (bf16 / per_elem > 1.9) == (world == 2)


@pytest.mark.parametrize("compress", ["int8", "none"])
def test_torch_hierarchical_grad_reduce_on_a_pod_data_mesh(oracle, ranks,
                                                           compress):
    """The data mean is bit for bit (a sum of two); the pod ring as in
    :func:`test_torch_int8_ring_matches_the_references_on_every_rank`."""
    res, _ = ranks[4]
    for k, x in tree_inputs().items():
        want = oracle[f"tree_{compress}_{k}"]
        got = np.stack([r[f"tree_{compress}_{k}"] for r in res])
        if compress == "none":
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32), err_msg=k)
        else:
            pods = np.stack([(x[0] + x[1]) / np.float32(2),
                             (x[2] + x[3]) / np.float32(2)])
            ring = numpy_ring(pods)
            np.testing.assert_array_equal(
                got.reshape(4, -1).view(np.int32),
                ring[[0, 0, 1, 1]].view(np.int32))
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=2 * np.finfo(np.float32).eps * np.abs(pods).max())
        # the two data ranks of a pod agree; with the ring the pods don't
        assert np.array_equal(got[0], got[1]) and \
            np.array_equal(got[2], got[3])
        assert np.array_equal(got[0], got[2]) == (compress == "none")


def test_torch_ring_refuses_a_cuda_tensor_on_a_gloo_group(tmp_path):
    import torch.distributed as dist
    from repro_torch.optim import compress as C
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        fake = types.SimpleNamespace(is_cuda=True)
        with pytest.raises(ValueError, match="CUDA tensor .* gloo"):
            C._int8_ring_all_reduce(fake, dist.group.WORLD)
        # world size 1: the ring and the full-precision mean (which takes a
        # CUDA tensor on a gloo group, staged by gloo) are the identity
        x = torch.randn(300)
        assert torch.equal(C._int8_ring_all_reduce(x, dist.group.WORLD), x)
        assert torch.equal(C.mean_over(x, dist.group.WORLD, 1), x)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_oracle(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
