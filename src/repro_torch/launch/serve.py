"""Batched serving CLI of the port: prefill a batch of prompts, then
greedy decoding, as the JAX package's ``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --prompt-len 32 --gen 16

``--arch`` takes every id of ``configs.ARCH_IDS`` (``--reduced``: its
smoke configuration). Runs on the first CUDA card unless ``--device
cpu``, on one device (no ``--mesh``). The weights are drawn from
``--seed`` alone, without the optimizer state the training draw
allocates, and cast to bf16 leaf by leaf (the deployment artifact, as
the JAX CLI casts them); the cache holds ``--prompt-len + --gen``
positions in bf16. The prompts are drawn from a ``torch.Generator``
seeded by ``--seed``. A vlm is served text only (no vision
embeddings), as the JAX CLI serves it. Each step's greedy token (the
first maximum) is read back to the host, which synchronises, as the
JAX CLI's ``np.asarray`` does; the prefill's time ends with its token's
read. ``main`` returns the generated tokens, (B, gen) or, for audio,
(B, gen, K).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.trainer import Trainer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    return p.parse_args(argv)


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


def run(args: argparse.Namespace) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(the generated tokens on the host, {'prefill_s', 'decode_s',
    'prefill_tokens_per_s', 'decode_tokens_per_s'})."""
    dev = resolve_device(args.device)
    model_cfg, _ = (get_smoke if args.reduced else get_arch)(args.arch)
    max_len = args.prompt_len + args.gen
    trainer = Trainer(TrainConfig(model=model_cfg, global_batch=args.batch,
                                  seq_len=max_len), device=dev)
    sc = ShapeConfig(name="serve", seq_len=max_len, global_batch=args.batch,
                     kind="decode")
    params = serve_params(trainer.model, args.seed, dev)
    cache = trainer.model.init_cache(args.batch, max_len, device=dev)
    prompts = draw_prompts(model_cfg, args.batch, args.prompt_len,
                           args.seed, dev)
    prefill, _ = trainer.build_serve_step(sc, mode="prefill")
    decode, _ = trainer.build_serve_step(sc, mode="decode")

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
    return torch.cat(out, dim=1), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "prefill_tokens_per_s": b * args.prompt_len / t_prefill,
        "decode_tokens_per_s": b * (args.gen - 1) / max(t_decode, 1e-9)}


def main(argv: Optional[List[str]] = None,
         stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Serve and print JAX's two throughput lines and the sample row;
    ``stats`` (a dict), when given, receives ``run``'s timings."""
    args = parse_args(argv)
    gen, timings = run(args)
    if stats is not None:
        stats.update(timings)
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{timings['prefill_s']:.3f}s "
          f"({timings['prefill_tokens_per_s']:,.0f} tok/s)")
    print(f"decode : {args.gen - 1} steps in {timings['decode_s']:.3f}s "
          f"({timings['decode_tokens_per_s']:,.0f} tok/s)")
    print("sample generation (row 0):", gen[0].reshape(-1)[:16].tolist())
    return gen


if __name__ == "__main__":
    main()
