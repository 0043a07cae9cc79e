"""Train one configuration on the card through both kernel backends and
print the two loss streams side by side.

    python3 scripts/torch_train_backends.py ARCH LAYERS STEPS

ARCH at full width, cut to LAYERS layers, is built from seed 0 and
trained for STEPS steps of 4 x 1,024 tokens of the synthetic stream (seed
0) with the reference's default optimizer, once on ``backend="cuda"`` (the
hand-written kernels) and once, from the same initial weights, on
``backend="torch"`` (the plain versions; the backward is the same on
both). It prints one JSON line: the card (name and power limit), each
backend's losses and gradient norms per step. It tells a loss stream's
shape that the model's dynamics give from one the kernels give. It needs
one CUDA device and exits non-zero without one.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main():
    import torch

    from repro_torch.configs import get_model_config
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model

    arch, layers, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    if not torch.cuda.is_available():
        sys.exit("needs one CUDA device")
    cfg = get_model_config(arch).replace(num_layers=layers)
    out = {"card": card(), "arch": arch, "layers": layers, "steps": steps}
    for backend in ("cuda", "torch"):
        model = build_model(cfg)
        model.init(0)
        stats = {}
        train(arch=arch, model=model, steps=steps, seq_len=1024,
              global_batch=4, seed=0, log_every=0, backend=backend,
              stats=stats)
        out[backend] = {"loss": stats["loss"],
                        "grad_norm": stats["grad_norm"]}
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
