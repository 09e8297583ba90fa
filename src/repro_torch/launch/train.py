"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--steps N] [--batch B] [--seq S] [--ckpt DIR] [--ckpt-every K]
[--device cpu] [--out FILE]``, or on N cards ``torchrun --nproc-per-node N
-m repro_torch.launch.train --arch <id>``.

As ``python -m repro.launch.train``: the model of the chosen architecture
(weights from seed 0), ``SyntheticTokens`` of its vocabulary, and the
fault-tolerant loop (checkpoint, resume, preemption).  Under ``torchrun``
every process is one tensor-parallel rank of a 1 x N mesh (the
reference's ``make_host_mesh(dp=1, tp=jax.device_count())``), on the card
of its ``LOCAL_RANK`` over NCCL, or over gloo with ``--device cpu``; every
rank draws the same batches, and rank 0 prints the reference's lines.
Without ``torchrun`` the world is one process and the model is not on a
mesh.  ``--out`` saves rank 0's logged (step, loss) pairs (numpy).  Runs
on the card unless ``--device`` names another device.  The reference's
``--simulate-pod``, ``--multi-pod`` and ``--tpu-flags`` shape a 256/512-
device TPU mesh (``make_production_mesh``): they raise, naming ROADMAP
Queue 1 item 12.
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.engine.relation import resolve_device
from repro_torch.launch import mesh as MESH
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
    ap.add_argument("--out", default=None,
                    help="save rank 0's logged (step, loss) pairs here")
    for flag in _MESH_FLAGS:
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    for flag in _MESH_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")):
            raise NotImplementedError(
                f"{flag} shapes the 256/512-device TPU mesh: ROADMAP Queue "
                f"1 item 12, its last part")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev, mesh = resolve_device(args.device), None
    if "WORLD_SIZE" in os.environ:        # started by torchrun
        MESH.init_process_group(device=dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = MESH.make_mesh_ctx(MESH.make_process_mesh())
    try:
        mdl = M.build(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                      training=True, mesh=mesh)
        n = cfg.param_counts()["total"]
        lead = mesh is None or mesh.rank == 0
        if lead:
            line = f"[launch] arch={cfg.name} params={n/1e6:.1f}M"
            if mesh is not None:
                line += (f" mesh={{'data': {mesh.dp_size}, 'model': "
                         f"{mesh.tp_size}}} devices={mesh.size}")
            print(f"{line} device={dev}")
        data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq)
        _, _, losses = train(mdl, data, steps=args.steps, ckpt_dir=args.ckpt,
                             ckpt_every=args.ckpt_every)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    if lead and args.out:
        np.save(args.out, np.asarray(losses, dtype=np.float64))


if __name__ == "__main__":
    main()
