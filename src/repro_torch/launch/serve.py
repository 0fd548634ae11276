"""Batched serving CLI of the port: prefill a batch of prompts, then
greedy decoding, as the JAX package's ``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --prompt-len 32 --gen 16

``--arch`` takes every id of ``configs.ARCH_IDS`` (``--reduced``: its
smoke configuration). Runs on the first CUDA card unless ``--device
cpu``. The weights are drawn from ``--seed`` alone, without the
optimizer state the training draw allocates, and cast to bf16 leaf by
leaf (the deployment artifact, as the JAX CLI casts them); the cache
holds ``--prompt-len + --gen`` positions in bf16 (a vlm's also its
vision tokens', as ``Trainer.abstract_serve_args`` lays it out; they
stay masked). The prompts are drawn
from a ``torch.Generator`` seeded by ``--seed``. A vlm is served text
only (no vision embeddings), as the JAX CLI serves it. Each step's
greedy token (the first maximum) is read back to the host, which
synchronises, as the JAX CLI's ``np.asarray`` does; the prefill's time
ends with its token's read.

``--mesh D``, ``DxM`` or ``PxDxM``, the JAX CLI's flag (read as the
train CLI reads it, ``train.mesh_shape``; default the world x 1), runs
inside an initialised ``torch.distributed`` world of that many ranks, as
the train CLI's does: every rank draws the same weights and prompts,
keeps its blocks under the architecture's rules and makes its serving
weights once (``Trainer.serve_local``), serves its data rank's rows of
the batch (every row when the batch is below the data degree) against
its blocks of the cache under the serving rules, each model group over
its model axis (``Trainer.build_serve_step``). Rank 0 prints JAX's two
throughput lines (the global batch's tokens over its own times) and the
sample row. ``main`` returns the generated tokens of the whole batch on
every rank, (B, gen) or, for audio, (B, gen, K).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import mesh_shape
from repro_torch.launch.trainer import Trainer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default=None,
                   help="D, DxM or PxDxM ranks (default: world x 1)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)
    args.mesh_shape = mesh_shape(args.mesh)
    return args


def serve_params(model, seed: int, device: torch.device) -> Dict[str, Any]:
    """The serving weights: f32 drawn from ``seed`` on ``device``
    (``init_params(on_device=True)``), each leaf then replaced by its
    bf16 cast."""
    params = model.init_params(seed, device, on_device=True)

    def cast(tree):
        for k, v in tree.items():
            tree[k] = cast(v) if isinstance(v, dict) \
                else v.to(torch.bfloat16)
        return tree
    return cast(params)


def draw_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """int32 prompts (B, S), or (B, S, K) for audio, uniform in [0,
    vocab) from a CPU ``torch.Generator`` seeded by ``seed``."""
    shape: Tuple[int, ...] = (batch, prompt_len)
    if cfg.family == "audio" and cfg.num_codebooks > 1:
        shape += (cfg.num_codebooks,)
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         dtype=torch.int32).to(device)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The last position's first maximum: (B, 1), or (B, 1, K), int32."""
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gather_rows(gen: torch.Tensor, trainer: Trainer, batch: int
                 ) -> torch.Tensor:
    """The whole batch's tokens on every rank from each data rank's rows
    (its model index 0's copy); every rank has them already when each
    served every row."""
    if gen.shape[0] == batch:
        return gen
    every: List[Any] = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, gen)
    m = trainer.model_size
    return torch.cat([every[d * m] for d in range(trainer.num_data)], dim=0)


def run(args: argparse.Namespace) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(the generated tokens of the whole batch on the host, {'prefill_s',
    'decode_s', 'prefill_tokens_per_s', 'decode_tokens_per_s'}: this
    rank's times over the whole batch's tokens)."""
    dev = resolve_device(args.device)
    model_cfg, _ = (get_smoke if args.reduced else get_arch)(args.arch)
    max_len = args.prompt_len + args.gen
    shape = args.mesh_shape
    mesh = make_mesh(shape) if shape[-1] > 1 or len(shape) == 3 else None
    trainer = Trainer(TrainConfig(model=model_cfg, global_batch=args.batch,
                                  seq_len=max_len), device=dev, mesh=mesh)
    sc = ShapeConfig(name="serve", seq_len=max_len, global_batch=args.batch,
                     kind="decode")
    params = trainer.serve_local(trainer.shard_params(
        serve_params(trainer.model, args.seed, dev)))
    rows = trainer.serve_rows(args.batch)
    prompts = draw_prompts(model_cfg, args.batch, args.prompt_len,
                           args.seed, dev)[rows]
    prefill, rules = trainer.build_serve_step(sc, mode="prefill")
    decode, _ = trainer.build_serve_step(sc, mode="decode")
    cache = trainer.init_serve_cache(sc, rules)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts}, cache)
    nxt = greedy(logits)
    out = [nxt.cpu()]
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = decode(params, {"tokens": nxt}, cache)
        nxt = greedy(logits)
        out.append(nxt.cpu())
    t_decode = time.perf_counter() - t0
    b = args.batch
    return _gather_rows(torch.cat(out, dim=1), trainer, b), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "prefill_tokens_per_s": b * args.prompt_len / t_prefill,
        "decode_tokens_per_s": b * (args.gen - 1) / max(t_decode, 1e-9)}


def main(argv: Optional[List[str]] = None,
         stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Serve and print JAX's two throughput lines and the sample row
    (rank 0 alone); ``stats`` (a dict), when given, receives ``run``'s
    timings."""
    args = parse_args(argv)
    gen, timings = run(args)
    if stats is not None:
        stats.update(timings)
    if torch.distributed.is_initialized() and \
            torch.distributed.get_rank() != 0:
        return gen
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{timings['prefill_s']:.3f}s "
          f"({timings['prefill_tokens_per_s']:,.0f} tok/s)")
    print(f"decode : {args.gen - 1} steps in {timings['decode_s']:.3f}s "
          f"({timings['decode_tokens_per_s']:,.0f} tok/s)")
    print("sample generation (row 0):", gen[0].reshape(-1)[:16].tolist())
    return gen


if __name__ == "__main__":
    main()
