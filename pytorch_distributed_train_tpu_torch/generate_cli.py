"""Text generation CLI for the PyTorch package.

    python -m pytorch_distributed_train_tpu_torch.generate_cli \\
        --config llama2_7b --prompt "The capital of France is" \\
        --max-new-tokens 32 [--serve-slots 4] [--device cuda]

Prompts are encoded with the byte tokenizer. Until a weight loader is
ported, the weights are drawn from ``--seed`` on the device, so the text
is noise; the command shows the serving path end to end. ``--serve-slots
N`` runs all prompts together through the continuous batcher.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="llama2_7b",
                   help="preset supplying the model architecture")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. model.num_layers=2")
    p.add_argument("--prompt", action="append", default=[],
                   help="repeatable")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling threshold in (0,1); 0 -> off")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and of the sampling generator")
    p.add_argument("--serve-slots", type=int, default=0, metavar="SLOTS",
                   help="continuous batching through this many cache slots; "
                        "0 -> one generate() per prompt")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.prompt:
        print("generate_cli: no prompts (--prompt TEXT)", file=sys.stderr)
        return 2

    import torch

    from pytorch_distributed_train_tpu_torch.config import get_preset
    from pytorch_distributed_train_tpu_torch.data.text import ByteTokenizer
    from pytorch_distributed_train_tpu_torch.generate import (
        build_decode_model,
        generate,
    )
    from pytorch_distributed_train_tpu_torch.serving import (
        ContinuousBatcher,
        trim_at_eos,
    )

    try:
        cfg = get_preset(args.config)
        cfg.apply_overrides(args.set)
        tok = ByteTokenizer()
        encoded = [tok.encode(t) for t in args.prompt]
        if any(len(e) == 0 for e in encoded):
            raise ValueError("empty prompt after tokenization")
        if cfg.model.vocab_size < tok.vocab_size:
            raise ValueError(f"model.vocab_size {cfg.model.vocab_size} is "
                             f"below the byte tokenizer's {tok.vocab_size}")

        def emit(i, new):
            print(f"=== prompt {i}: {args.prompt[i]!r}")
            print(tok.decode(trim_at_eos(new, tok.eos_id)))

        if args.serve_slots > 0:
            b = ContinuousBatcher(cfg.model, cfg.precision, None,
                                  slots=args.serve_slots, top_k=args.top_k,
                                  top_p=args.top_p, device=args.device,
                                  seed=args.seed)
            uid_to_i = {b.submit(e, args.max_new_tokens,
                                 temperature=args.temperature,
                                 eos_id=tok.eos_id): i
                        for i, e in enumerate(encoded)}
            for c in b.run():
                emit(uid_to_i[c.uid], c.tokens)
            return 0

        model = build_decode_model(cfg.model, cfg.precision, None,
                                   device=args.device, seed=args.seed)
        for i, e in enumerate(encoded):
            g = torch.Generator(device=model.device)
            g.manual_seed(args.seed + i)
            out = generate(model, [e], args.max_new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, generator=g, eos_id=tok.eos_id)
            emit(i, out[0, len(e):].tolist())
        return 0
    except (KeyError, ValueError, NotImplementedError) as e:
        print(f"generate_cli: error: {e.args[0] if e.args else e}",
              file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
