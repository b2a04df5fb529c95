"""First-contact check of a released UniDepth-V2 checkpoint (PyTorch port
of ``scripts/check_unidepth.py``, with its flags).

    python -m more4d_tpu_torch.scripts.check_unidepth unidepth_v2_vitl14.pth

Loads the checkpoint into the port's ``UniDepthV2`` (built on the meta
device, then allocated on the CPU) through ``load_unidepth_strict``, which
diffs the decoder keys against ``unidepth_decoder_key_manifest``, maps the
backbone's official or ``transformers`` DINOv2 names, and checks every
shape; exit 0 and "OK", else the whole structured diff and exit 1. The JAX
script's ``--run_compare`` (a numeric comparison against a
``transformers`` oracle) is not ported and raises.

Reads ``.pth``/``.bin`` (``torch.load``, weights only) and
``.safetensors``.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m more4d_tpu_torch.scripts.check_unidepth",
        description=__doc__.splitlines()[0])
    p.add_argument("checkpoint")
    p.add_argument("--num_adapters", type=int, default=4)
    p.add_argument("--camera_blocks", type=int, default=2)
    p.add_argument("--depth_blocks", type=int, default=4)
    p.add_argument("--run_compare", action="store_true")
    p.add_argument("--image", default=None)
    p.add_argument("--tol", type=float, default=1e-2)
    p.add_argument("--backbone_dim", type=int, default=None)
    p.add_argument("--backbone_depth", type=int, default=None)
    p.add_argument("--backbone_heads", type=int, default=None)
    p.add_argument("--hidden_dim", type=int, default=None)
    p.add_argument("--layer_ids", default=None,
                   help="comma-separated backbone tap layers")
    p.add_argument("--strip_prefix", default=None,
                   help="strip this prefix from every key first")
    args = p.parse_args(argv)
    if args.run_compare:
        raise NotImplementedError(
            "--run_compare (the numeric comparison against transformers' "
            "Dinov2Model and the JAX package's torch decoder mirror) is not "
            "ported (ROADMAP.md Queue 1, the rest of inference)")

    from ..convert.dit_torch import read_state_dict
    from ..models.unidepth import UniDepthV2, load_unidepth_strict

    model_kw = {k: getattr(args, k) for k in
                ("backbone_dim", "backbone_depth", "backbone_heads",
                 "hidden_dim") if getattr(args, k) is not None}
    if args.layer_ids:
        model_kw["layer_ids"] = tuple(
            int(t) for t in args.layer_ids.split(","))
    with torch.device("meta"):
        model = UniDepthV2(**model_kw)
    built = (len(model.input_adapters), len(model.camera_head.blocks),
             len(model.depth_head.blocks))
    if built != (args.num_adapters, args.camera_blocks, args.depth_blocks):
        raise SystemExit(f"the model has {built} adapters, camera blocks "
                         f"and depth blocks; --num_adapters must match "
                         f"--layer_ids, and UniDepthV2 has 2 camera and 4 "
                         f"depth blocks")
    model = model.to_empty(device="cpu")

    sd = read_state_dict(args.checkpoint)
    if args.strip_prefix:
        sd = {(k[len(args.strip_prefix):]
               if k.startswith(args.strip_prefix) else k): v
              for k, v in sd.items()}
    n_enc = sum(k.startswith("pixel_encoder.") for k in sd)
    print(f"{args.checkpoint}: {len(sd)} keys ({n_enc} pixel_encoder.*, "
          f"{len(sd) - n_enc} decoder)")
    try:
        report = load_unidepth_strict(sd, model)
    except ValueError as e:
        print(str(e))
        print("\nFAILED: fix the renames/gaps above in "
              "more4d_tpu_torch/models/unidepth.py (or pass --strip_prefix "
              "/ geometry flags), then re-run.")
        return 1
    print(f"  backbone {report['backbone']}, decoder {report['decoder']}"
          + (f", ignored {report['ignored']}" if report["ignored"] else ""))
    print("OK: every key mapped; every entry matches the model graph. "
          "--depth_provider unidepth_jax (the port's UniDepth) is safe to "
          "use with this file.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
