#!/usr/bin/env python3
"""Where an LM train microbatch spends the card's time: one forward and
backward of ``LMBundle.loss`` (period and query-block remat, bf16) at
full width under ``torch.profiler``, after one warm-up microbatch; prints
the wall, the device's busy time and the top kernels by device time.

    PYTHONPATH=src python3 scripts/profile_lm.py starcoder2-3b --tokens 4096
    PYTHONPATH=src python3 scripts/profile_lm.py mamba2-2.7b --layers 8

Runs on the card only (it measures the device)."""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import get_bundle
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--top", type=int, default=12)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(a.arch)
    if a.layers:
        cfg = cfg.replace(num_layers=a.layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bundle = get_bundle(cfg)
    model = bundle.init(gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, a.tokens + 1), device=dev,
                         generator=gen, dtype=torch.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.frontend == "stub_embed":
        batch["embeds"] = torch.randn(1, a.tokens, cfg.d_model, device=dev,
                                      generator=gen, dtype=torch.bfloat16)
    else:
        batch["tokens"] = toks[:, :-1]
    params = list(model.parameters())

    def micro():
        loss = bundle.loss(model, batch)
        torch.autograd.grad(loss, params, allow_unused=True)

    micro()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        micro()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in rows) / 1e6
    print(f"[profile_lm] {cfg.name}: {cfg.num_layers} layers, 1 x "
          f"{a.tokens} tokens, forward + backward: wall {wall:.3f} s, "
          f"device kernels {busy:.3f} s ({busy / wall:.3f} of the wall) on "
          f"{torch.cuda.get_device_name(0)}")
    rows.sort(key=lambda e: -e.device_time_total)
    for e in rows[:a.top]:
        print(f"  {e.device_time_total / 1e3:9.1f} ms  {e.count:6d} x  "
              f"{e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
