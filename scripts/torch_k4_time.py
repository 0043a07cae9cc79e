"""Time K4 (the port's bfloat16 flash attention) at the served prefill
shapes, for the port package under a given ``src/`` directory.

    python3 scripts/torch_k4_time.py SRC [SRC ...]

Each SRC is a checkout's ``src/`` (this one's, or a parent commit unpacked
into a git-ignored directory); each is timed in its own process, in the
order given, so that two commits compare on one card in one call (give
them in turns: parent, change, change, parent). Per SRC it prints one JSON
line: the card (name and power limit), and for K4 at the Qwen2-7B prefill
shape (q (4, 1024, 28, 128), k and v (4, 1024, 4, 128), causal) and, where
that tree builds the pair, the MiniCPM3 one (q and k (4, 1024, 40, 96), v
the 64-wide slice of (4, 1024, 40, 128), causal): the kernel's device time
per call from ``torch.profiler`` (three sessions of 20 calls), its time by
CUDA events over calls queued behind a device spin (no host gap inside
the interval), and its largest error against the plain version. It needs
one CUDA device and exits non-zero without one.
"""
import json
import os
import statistics
import subprocess
import sys

SPIN_CYCLES = 50_000_000            # some 25 ms of the device, at 2 GHz


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def time_tree(src):
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda", 0)

    def profiled_ms(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        t = sum(e.self_device_time_total for e in prof.key_averages()
                if "flash_fwd_wgmma_kernel" in e.key)
        return t / 1e3 / calls if t else None

    def queued_ms(fn, calls=20, samples=10):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(samples):
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / calls)
        return statistics.median(out)

    g = torch.Generator(device=dev).manual_seed(100)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).bfloat16()
    cases = {"qwen2-7b prefill": (mk(4, 1024, 28, 128), mk(4, 1024, 4, 128),
                                  mk(4, 1024, 4, 128), None)}
    if (96, 64) in getattr(FA.cuda_kernels, "HEAD_DIMS", ()):
        cases["minicpm3-4b prefill (MLA)"] = (
            mk(4, 1024, 40, 96), mk(4, 1024, 40, 96),
            mk(4, 1024, 40, 128)[..., 64:], 96 ** -0.5)
    line = {"src": src, "card": card(), "device": torch.cuda.get_device_name(0)}
    for name, (q, k, v, scale) in cases.items():
        fn = lambda: FA.flash_attention(q, k, v, scale=scale)
        err = (fn().float() - FA.plain(q, k, v, scale=scale).float()).abs()
        line[name] = {"profiler_ms": [profiled_ms(fn) for _ in range(3)],
                      "queued_events_ms": queued_ms(fn),
                      "max_abs_err": float(err.max())}
    print(json.dumps(line), flush=True)


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    if len(sys.argv) > 2:
        # one process per tree: both trees' packages are named repro_torch
        rc = 0
        for src in sys.argv[1:]:
            rc |= subprocess.run([sys.executable, __file__, src]).returncode
        sys.exit(rc)
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_k4_time.py: needs one CUDA device")
    time_tree(sys.argv[1])


if __name__ == "__main__":
    main()
