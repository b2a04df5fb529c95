"""First-contact check of a released Wan2.1-Fun DiT checkpoint (PyTorch
port of ``scripts/check_wan.py``, with its flags).

    python -m more4d_tpu_torch.scripts.check_wan CKPT --model_size 1.3b \\
        --variant control4d

Diffs the checkpoint's key layout and shapes against the port's
``WanDiT`` at that config (built on the meta device: no weights are
allocated, so the 14B checks in seconds) through ``load_wan_dit_strict``.
Exit 0 and "OK" when every key maps (or sits in a group that is
initialised fresh) and every shape agrees; else the whole structured diff
and exit 1. A 48-channel Control checkpoint checked against ``control4d``
runs the 48->64 patch-embedding surgery. Keys under
``omnimae_extractor.`` are counted: they load through ``--omnimae_ckpt``.

Reads ``.pth``/``.bin`` (``torch.load``, weights only), ``.safetensors``,
and directories of ``.safetensors`` shards.
"""

from __future__ import annotations

import argparse

VARIANTS = {
    # 4D-STraG Control: motion guidance and depth channels (in_dim 64)
    "control4d": dict(motion_guidance=True, in_dim=64, model_type="i2v"),
    # the released Wan2.1-Fun-Control (48 channels, no 4D additions)
    "control3d": dict(motion_guidance=False, in_dim=48, model_type="i2v"),
    # Wan2.1-Fun-InP
    "inp": dict(motion_guidance=False, in_dim=36, model_type="i2v"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m more4d_tpu_torch.scripts.check_wan",
        description=__doc__.splitlines()[0])
    p.add_argument("checkpoint")
    p.add_argument("--model_size", default="14b",
                   choices=["tiny", "1.3b", "14b"])
    p.add_argument("--variant", default="control4d",
                   choices=sorted(VARIANTS))
    p.add_argument("--in_dim", type=int, default=None,
                   help="override the model in_dim (e.g. 64 to check the "
                        "48->64 surgery against a 48-channel checkpoint)")
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--ref_conv", action="store_true",
                   help="expect the ref_conv group (V1.1 checkpoints)")
    p.add_argument("--strip_prefix", default=None,
                   help="strip this prefix from every key first")
    args = p.parse_args(argv)

    from ..config import dit_1_3b, dit_14b, dit_tiny
    from ..convert.dit_torch import load_wan_dit_strict, read_state_dict

    mk = {"tiny": dit_tiny, "1.3b": dit_1_3b, "14b": dit_14b}
    kw = dict(VARIANTS[args.variant])
    if args.model_size == "tiny" and kw.get("model_type") == "i2v":
        # the reference's image projection reads 1280 channels at any size
        kw["clip_dim"] = 1280
    if args.in_dim is not None:
        kw["in_dim"] = args.in_dim
    if args.num_layers is not None:
        kw["num_layers"] = args.num_layers
    if args.ref_conv:
        kw["ref_conv"] = True
    motion = kw.pop("motion_guidance")
    cfg = mk[args.model_size](motion_guidance=motion, **kw)

    sd = read_state_dict(args.checkpoint)
    if args.strip_prefix:
        sd = {(k[len(args.strip_prefix):]
               if k.startswith(args.strip_prefix) else k): v
              for k, v in sd.items()}
    n_omni = sum(k.startswith("omnimae_extractor.") for k in sd)
    print(f"{args.checkpoint}: {len(sd)} keys ({n_omni} "
          f"omnimae_extractor.*, {len(sd) - n_omni} DiT) vs "
          f"{args.model_size}/{args.variant} (layers={cfg.num_layers}, "
          f"dim={cfg.dim}, in_dim={cfg.in_dim})")
    try:
        _, report = load_wan_dit_strict(sd, cfg)
    except (ValueError, KeyError) as e:
        print(str(e))
        print("\nFAILED: fix the renames/gaps above in "
              "more4d_tpu_torch/convert/dit_torch.py (or pass "
              "--strip_prefix / --variant / geometry flags), then re-run.")
        return 1
    for name, status in report["groups"].items():
        print(f"  group {name}: {status}")
    if report["ckpt_in_dim"] != report["model_in_dim"]:
        print(f"  patch-embed surgery: checkpoint in_dim "
              f"{report['ckpt_in_dim']} -> model {report['model_in_dim']} "
              f"(zero-padded new input channels)")
    if report["omnimae_embedded_keys"]:
        print(f"  {report['omnimae_embedded_keys']} embedded "
              f"omnimae_extractor.* keys: load them with --omnimae_ckpt")
    print("OK: every key mapped (or in a group initialised fresh); every "
          "converted entry matches the WanDiT graph. The file is safe for "
          "more4d_tpu_torch.scripts.infer at this config.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
