"""Offline weight import: a torchvision ``.pth`` -> the Flax msgpack file
(port of ``cli/import_weights.py``).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.import_weights \\
        resnet50 /path/to/resnet50-weights.pth [--out w.msgpack] [--verify]

The output is the file the JAX package's import writes (its
``flax.serialization`` bytes, through ``models/flax_msgpack.py``), so both
packages' zoos then find ``$ADV_TPU_WEIGHTS_DIR/<model>.msgpack``.
``--verify`` runs a float32 forward on a white image on ``--device`` and
prints the top-5 class ids and probabilities.  ``--device`` defaults to
``cuda`` and raises where CUDA is absent unless given ``cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert torch weights to the Flax cache")
    parser.add_argument("model", type=str, help="zoo model name (e.g. resnet50)")
    parser.add_argument("checkpoint", type=str, help="path to the .pth/.pt state dict")
    parser.add_argument("--out", type=str, default=None,
                        help="output .msgpack path (default: weights dir)")
    parser.add_argument("--verify", action="store_true",
                        help="run a forward pass after conversion")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device to load and verify on (default: %(default)s; the "
                             "CPU only when asked for)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    ckpt = Path(args.checkpoint)
    if not ckpt.is_file():
        raise SystemExit(f"checkpoint not found: {ckpt}")

    import numpy as np
    import torch

    from ..core.device import resolve_device
    from ..models.convert import to_jax_variables
    from ..models.flax_msgpack import save_variables
    from ..models.zoo import load_model, model_family, weights_dir

    device = resolve_device(args.device)
    bundle = load_model(args.model, dtype=torch.float32, weights=ckpt, device=device,
                        cache_converted=False)
    if bundle.source != "converted":
        raise SystemExit(f"conversion failed (source={bundle.source})")

    out = Path(args.out) if args.out else weights_dir() / f"{args.model}.msgpack"
    save_variables(to_jax_variables(bundle.model, model_family(args.model)), out)
    print(f"converted {ckpt} -> {out}")

    if args.verify:
        from ..attacks.api import make_logits_fn

        lf = make_logits_fn(bundle.model, bundle.mean, bundle.std)
        x = torch.ones((1, bundle.input_size, bundle.input_size, 3), device=device)
        with torch.no_grad():
            probs = torch.softmax(lf(x), dim=-1)[0].cpu().numpy()
        top5 = np.argsort(-probs)[:5]
        print("verify: top-5 on a white image:",
              [(int(i), round(float(probs[i]), 4)) for i in top5])
    return 0


if __name__ == "__main__":
    sys.exit(main())
