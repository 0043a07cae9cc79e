"""The port's serving entry point on the CPU: ``generate`` against the JAX
package's greedy loop, and the rules that keep it off the CPU unless the
caller asks for it by name."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_model_config
from repro_torch.kernels import cuda_kernels, ops
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax

from test_torch_model import jax_greedy, jax_model


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a CUDA device")


def test_torch_generate_gives_the_jax_greedy_tokens_in_float32():
    cfg, jm, params, tree = jax_model("qwen2-7b", "float32", seed=3)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(3, 10)).astype(np.int32)
    want, _ = jax_greedy(jm, params, prompts, 8)
    model = params_from_jax(tree, cfg, device="cpu")
    stats = {}
    got, summary = serve.generate(arch="qwen2-7b", prompt_tokens=prompts,
                                  max_new_tokens=8, model=model,
                                  device="cpu", backend="torch", stats=stats)
    assert got.shape == (3, 18) and got.dtype == torch.long
    assert np.array_equal(got.numpy(), want)
    assert summary["iters"] == 8.0
    assert len(stats["decode_s"]) == 8 and stats["prefill_s"] > 0


def test_torch_generate_is_deterministic_for_a_seed():
    prompts = np.random.default_rng(0).integers(0, 512, size=(2, 8))
    a, _ = serve.generate(arch="stablelm-12b", prompt_tokens=prompts,
                          max_new_tokens=6, seed=1, device="cpu",
                          backend="torch")
    b, _ = serve.generate(arch="stablelm-12b", prompt_tokens=prompts,
                          max_new_tokens=6, seed=1, device="cpu",
                          backend="torch")
    assert a.shape == (2, 14) and torch.equal(a, b)
    assert int(a.max()) < 512 and int(a.min()) >= 0


def test_torch_bare_generate_goes_to_the_card_and_raises_without_one(no_card):
    prompts = np.zeros((1, 4), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        serve.generate(arch="qwen2-7b", prompt_tokens=prompts)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        serve.generate(arch="qwen2-7b", prompt_tokens=prompts,
                       backend="torch")


def test_torch_cuda_backend_refuses_cpu_tensors():
    """No quiet stand-in: ``backend="cuda"`` with CPU tensors raises, at
    the op and through the whole serving path, and launches nothing."""
    before = cuda_kernels.launch_counts()
    x = torch.randn(2, 5, 4, 32)
    with pytest.raises(ValueError, match="backend='cuda' runs the "
                                         "hand-written kernels"):
        ops.attention(x, x, x)
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.rmsnorm(x, torch.ones(32))
    with pytest.raises(ValueError, match="backend='cuda'"):
        serve.generate(arch="qwen2-7b", prompt_tokens=np.zeros((1, 4)),
                       max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        ops.rmsnorm(x, torch.ones(32), backend="triton")
    assert cuda_kernels.launch_counts() == before == {"flash_attention": 0,
                                                      "rmsnorm": 0,
                                                      "wkv6": 0,
                                                      "mamba_scan": 0}


def test_torch_generate_refuses_what_the_slice_lacks():
    """A model whose configuration is not ``arch``'s is refused."""
    prompts = np.zeros((1, 4), np.int64)
    model = serve.build_model(get_model_config("stablelm-12b", smoke=True),
                              device="cpu")
    with pytest.raises(ValueError, match="arch is 'qwen2-7b'"):
        serve.generate(arch="qwen2-7b", prompt_tokens=prompts, model=model)


def test_torch_serve_cli_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--batch", "2",
                                     "--prompt-len", "6",
                                     "--max-new-tokens", "3",
                                     "--device", "cpu", "--backend", "torch"])
    serve.main()
    assert "generated shape: (2, 9)" in capsys.readouterr().out
