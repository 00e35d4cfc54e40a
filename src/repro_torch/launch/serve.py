"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--smoke] [--device cpu]`` (counterpart of ``repro.launch.serve``).

Initialises the model's weights on the device from a seeded generator
and generates greedily from a seeded random prompt.  The engine runs with
its defaults, as the reference's launcher does: the stream is a tenant of
the NoM bank pool, and every step's cache movement is scheduled on the
engine's fabric (on the same device)."""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import make_model
from repro_torch.serving import Engine


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Greedy generation with random weights; every step's "
        "cache movement is scheduled on the NoM fabric.")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = make_model(cfg, device=device, seed=args.seed)
    eng = Engine(model, cfg, max_len=args.prompt_len + args.new_tokens + 8,
                 device=device)
    gen = torch.Generator(device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    out = eng.generate(prompt, args.new_tokens)
    print(f"[serve] arch={cfg.name} generated {tuple(out.shape)}")
    tel, fab = eng.transfer_telemetry(), eng.fabric.telemetry()
    print(f"[serve] transfers: {tel['requests']} requests in {tel['steps']} "
          f"batches ({tel['init_requests']} INIT), {tel['scheduled']} "
          f"scheduled; CCU waves fused {fab['fused_waves']}, host "
          f"{fab['host_waves']}")
    print(out[:, args.prompt_len:])
    return out


if __name__ == "__main__":
    main()
