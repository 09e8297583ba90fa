"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--steps N] [--batch B] [--seq S] [--ckpt DIR] [--ckpt-every K]
[--device cpu]``.

As ``python -m repro.launch.train`` on one device: the model of the
chosen architecture (weights from seed 0), ``SyntheticTokens`` of its
vocabulary, and the fault-tolerant loop (checkpoint, resume, preemption).
Runs on the card unless ``--device`` names another device.  The
reference's ``--simulate-pod``, ``--multi-pod`` and ``--tpu-flags`` shape
a TPU mesh: they are ROADMAP Queue 1 item 12's training half (several
cards) and raise, as does a model built for training on a mesh.
"""
import argparse

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.engine.relation import resolve_device
from repro_torch.models import model as M
from repro_torch.train.train_loop import train

_MESH_FLAGS = ("--simulate-pod", "--multi-pod", "--tpu-flags")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    for flag in _MESH_FLAGS:
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    for flag in _MESH_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")):
            raise NotImplementedError(
                f"{flag} shapes a TPU mesh: ROADMAP Queue 1 item 12 "
                f"(several cards), its training half")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    mdl = M.build(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                  training=True)
    n = cfg.param_counts()["total"]
    print(f"[launch] arch={cfg.name} params={n/1e6:.1f}M device={dev}")
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq)
    train(mdl, data, steps=args.steps, ckpt_dir=args.ckpt,
          ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
