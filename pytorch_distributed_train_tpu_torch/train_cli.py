"""Training CLI of the PyTorch package, the counterpart of ``train.py``.

    python -m pytorch_distributed_train_tpu_torch.train_cli \\
        --config llama2_7b --set model.num_layers=8 --set data.batch_size=2 \\
        --set data.synthetic_size=8 --steps 10 [--device cuda]

Weights are drawn from ``seed`` on the device (no weight loader is ported).
``--list-configs``, ``--print-config``, ``--set`` and ``--steps`` behave as
in ``train.py``; its other flags (resume, eval-only, compile-only, batch
search, safetensors import/export) are not ported and exit 2.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="llama2_7b", help="preset name")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. model.num_layers=8")
    p.add_argument("--steps", type=int, default=None,
                   help="stop after this many steps")
    p.add_argument("--list-configs", action="store_true")
    p.add_argument("--print-config", action="store_true")
    p.add_argument("--device", default="cuda")
    args, unknown = p.parse_known_args(argv)
    if unknown:
        print(f"train_cli: error: {' '.join(unknown)}: not ported to the "
              "PyTorch package", file=sys.stderr)
        return 2

    from pytorch_distributed_train_tpu_torch.config import (
        get_preset,
        list_presets,
    )

    if args.list_configs:
        print("\n".join(list_presets()))
        return 0
    try:
        cfg = get_preset(args.config)
        cfg.apply_overrides(args.set)
        if args.print_config:
            print(cfg.to_json())
            return 0
        from pytorch_distributed_train_tpu_torch.trainer import Trainer

        Trainer(cfg, device=args.device).fit(args.steps)
        return 0
    except (KeyError, ValueError, NotImplementedError) as e:
        print(f"train_cli: error: {e.args[0] if e.args else e}",
              file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
