"""Training checkpoint → HuggingFace directory CLI.

Restores the params of the latest step a `train.run --checkpoint-dir`
run wrote (models/inference.load_params_from_checkpoint: params only,
never the Adam moments) and writes a loadable HF directory with
models/convert.export_hf_checkpoint: config.json and safetensors shards,
written by the port itself (no `transformers` needed).

    python3 -m skypilot_tpu_torch.models.export_tool \
        --model llama3-1b --checkpoint-dir ckpts --out hf-out

Runs on the CPU (the export is a copy). A LoRA checkpoint (lora.json) is
refused: LoRA training is not ported.
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
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.convert import export_hf_checkpoint
    from skypilot_tpu_torch.models.inference import (
        load_params_from_checkpoint)

    cfg = get_config(args.model, dtype=args.dtype)
    state = load_params_from_checkpoint(cfg, args.checkpoint_dir, 'cpu')
    files = export_hf_checkpoint(state, cfg, args.out)
    print(f'exported {args.model} -> {args.out}: {", ".join(files)}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
