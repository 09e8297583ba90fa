"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--smoke] [--device cpu] [--out FILE]``, or on N cards ``torchrun
--nproc-per-node N -m repro_torch.launch.serve --arch <id>``.

Prefill + batched greedy decode, as ``python -m repro.launch.serve``: the
same arguments, the same refusal of encoder-only configurations and the
same output lines.  Under ``torchrun`` every process is one
tensor-parallel rank of a 1 x N mesh (the reference's ``make_host_mesh(dp=1,
tp=jax.device_count())``), on the card of its ``LOCAL_RANK`` over NCCL, or
over gloo with ``--device cpu``; rank 0 prints.  Without ``torchrun`` the
world is one process and the model is not on a mesh.  ``--out`` saves the
generated tokens (rank 0's, numpy).  As there, the K/V caches are as long as the prompt,
so each generated token's cache row is not written and it attends to the
prompt only (``gqa_decode_attention``, ``mla_decode_attention``; zamba2's
shared attention block keeps that contract too).  The Mamba states of the
``ssm`` and ``hybrid`` families (conv tail and h per layer) carry no
length: each decode step advances them.  Runs on the card unless
``--device`` names another device.
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.engine.relation import resolve_device
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, batch: int = 4, prompt_len: int = 32, gen: int = 32,
          device=None, mesh=None):
    """Random weights (seed 0) and prompts (seed 1), prefill and ``gen - 1``
    decode steps; on a mesh (``mesh``, this rank's ``MeshCtx``) the rank's
    part of the model, every rank given the same prompts.  Returns
    (generated tokens (B, gen), prefill s, decode s)."""
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    dev = resolve_device(device)
    mdl = M.build(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                  mesh=mesh)
    g = torch.Generator(device=dev).manual_seed(1)
    B, S = batch, prompt_len
    if cfg.input_mode == "embeddings":
        inputs = {"embeddings": torch.randn((B, S, cfg.d_model), generator=g,
                                            device=dev)}
    else:
        inputs = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                          generator=g, device=dev)}
    t0 = time.perf_counter()
    tok, caches = mdl.prefill_step(inputs)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        if cfg.input_mode == "embeddings":
            step_in = torch.randn((B, 1, cfg.d_model), device=dev,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(2 + t))
        else:
            step_in = tok
        tok, caches = mdl.decode_step(caches, step_in, S + t)
        out.append(tok.cpu().numpy())
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return np.stack(out, 1), t_prefill, t_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=None,
                    help="save the generated tokens here (numpy)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev, mesh = resolve_device(args.device), None
    if "WORLD_SIZE" in os.environ:        # started by torchrun
        MESH.init_process_group(device=dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = MESH.make_mesh_ctx(MESH.make_process_mesh())
    try:
        gen, t_prefill, t_decode = serve(cfg, args.batch, args.prompt_len,
                                         args.gen, dev, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    if mesh is not None and mesh.rank != 0:
        return
    B, S = args.batch, args.prompt_len
    print(f"[serve] {cfg.name}: prefill({B}x{S})={t_prefill*1e3:.0f}ms  "
          f"decode {args.gen} toks: {t_decode/max(args.gen-1,1)*1e3:.1f}ms/tok")
    print(f"[serve] sample: {gen[0][:16]}")
    if args.out:
        np.save(args.out, gen)


if __name__ == "__main__":
    main()
