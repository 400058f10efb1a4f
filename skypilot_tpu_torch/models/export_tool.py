"""Training checkpoint → HuggingFace directory CLI.

Restores the params of the latest step a `train.run --checkpoint-dir`
run wrote (models/inference.load_params_from_checkpoint: params only,
never the Adam moments) and writes a loadable HF directory with
models/convert.export_hf_checkpoint: config.json and safetensors shards,
written by the port itself (no `transformers` needed).

    python3 -m skypilot_tpu_torch.models.export_tool \
        --model llama3-1b --checkpoint-dir ckpts --out hf-out

Runs on the CPU (the export is a copy). A LoRA run's checkpoint is
exported merged: the run's `lora.json` sidecar is read automatically
(load_params_from_checkpoint restores with it and folds the adapters into
the base weights). The reference's --lora-rank/--lora-alpha/
--lora-targets flags are checked against the sidecar (one that disagrees
is refused, rc 1, so a wrong alpha cannot mis-scale the merge). Without
a sidecar, --lora-rank (with --lora-alpha, default 16, and
--lora-targets, default q,v) gives the shape, and --lora-alpha or
--lora-targets alone is refused.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--model', required=True)
    parser.add_argument('--checkpoint-dir', required=True,
                        help='checkpoint directory written by train.run')
    parser.add_argument('--out', required=True,
                        help='output HF checkpoint directory')
    parser.add_argument('--dtype', default='float32',
                        choices=['float32', 'bfloat16'],
                        help='dtype of the exported weights: float32 '
                             '(default) is lossless for any checkpoint; '
                             'bfloat16 halves the export and is lossless '
                             "for train.run's bf16 params")
    parser.add_argument('--lora-rank', type=int, default=None,
                        help="the training run's --lora-rank; normally "
                             "unnecessary: the run's lora.json sidecar is "
                             "read automatically, and a flag that "
                             "disagrees with it is refused")
    parser.add_argument('--lora-alpha', type=float, default=None)
    parser.add_argument('--lora-targets', default=None)
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.models import lora
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.convert import export_hf_checkpoint
    from skypilot_tpu_torch.models.inference import (
        load_params_from_checkpoint)

    flags = {'lora_rank': args.lora_rank, 'lora_alpha': args.lora_alpha,
             'lora_targets': args.lora_targets}
    passed = {k: v for k, v in flags.items() if v is not None}
    lora_meta = None
    sidecar = lora.read_sidecar(args.checkpoint_dir)
    if sidecar is not None:
        conflict = {k: v for k, v in passed.items() if sidecar[k] != v}
        if conflict:
            print(f'error: {conflict} disagrees with the training '
                  f'run\'s {lora.SIDECAR} in {args.checkpoint_dir}: '
                  f'{sidecar}', file=sys.stderr)
            return 1
        print(f'LoRA checkpoint ({sidecar}): adapters will be merged '
              f'into the base weights', file=sys.stderr)
    elif passed.get('lora_rank'):
        lora_meta = {'lora_rank': passed['lora_rank'],
                     'lora_alpha': passed.get('lora_alpha', 16.0),
                     'lora_targets': passed.get('lora_targets', 'q,v')}
    elif passed:
        print('error: --lora-alpha/--lora-targets need --lora-rank '
              '(no lora.json sidecar found)', file=sys.stderr)
        return 1
    cfg = get_config(args.model, dtype=args.dtype)
    state = load_params_from_checkpoint(cfg, args.checkpoint_dir, 'cpu',
                                        lora_meta=lora_meta)
    files = export_hf_checkpoint(state, cfg, args.out)
    print(f'exported {args.model} -> {args.out}: {", ".join(files)}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
