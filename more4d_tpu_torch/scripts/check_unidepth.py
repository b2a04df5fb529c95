"""First-contact check of a released UniDepth-V2 checkpoint (PyTorch port
of ``scripts/check_unidepth.py``, with its flags).

    python -m more4d_tpu_torch.scripts.check_unidepth unidepth_v2_vitl14.pth

Loads the checkpoint into the port's ``UniDepthV2`` (built on the meta
device, then allocated on the CPU) through ``load_unidepth_strict``, which
diffs the decoder keys against ``unidepth_decoder_key_manifest``, maps the
backbone's official or ``transformers`` DINOv2 names, and checks every
shape; exit 0 and "OK", else the whole structured diff and exit 1.

``--run_compare`` then checks the numbers, as the JAX script does: the
port's ``UniDepthV2`` and an independent oracle run on the same weights,
and their depth maps and intrinsics must agree within ``--tol``
(relative). The oracle is ``transformers``' ``Dinov2Model`` for the
backbone and the decoder transcription in ``models/unidepth_mirror.py``,
on one image (``--image``, or a deterministic synthetic one at the native
518x518, so no position-embedding resize runs). When ``transformers`` is
absent or the backbone keys do not fit its names, the compare runs the
decoder alone on synthetic tap features and says so (the backbone stays
covered by the strict key and shape check). Prints ``COMPARE OK`` and
returns 0, or ``COMPARE FAILED`` and returns 1.

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
    if args.run_compare:
        return run_compare(sd, model.eval(), args)
    return 0


def _transformers_backbone(enc_sd, model):
    """``transformers``' ``Dinov2Model`` of ``model``'s backbone geometry
    with ``enc_sd`` (the checkpoint's ``pixel_encoder.`` keys, prefix
    dropped) loaded, or None with the reason: ``transformers`` absent or
    the keys not under its names."""
    try:
        from transformers import Dinov2Config, Dinov2Model

        enc = model.pixel_encoder
        pos = enc_sd["embeddings.position_embeddings"]
        grid = int(round((pos.shape[1] - 1) ** 0.5))
        cfg = Dinov2Config(
            hidden_size=enc.embed_dim, num_hidden_layers=len(enc.blocks),
            num_attention_heads=enc.blocks[0].attn.num_heads,
            intermediate_size=int(
                enc_sd["encoder.layer.0.mlp.fc1.weight"].shape[0]),
            image_size=grid * enc.patch_size, patch_size=enc.patch_size,
            layerscale_value=1.0)
        oracle = Dinov2Model(cfg).eval()
        missing, unexpected = oracle.load_state_dict(enc_sd, strict=False)
        unexpected = [k for k in unexpected if "mask_token" not in k]
        if missing or unexpected:
            raise ValueError(f"missing={missing[:4]} "
                             f"unexpected={unexpected[:4]}")
        return oracle, None
    except Exception as e:          # noqa: BLE001 - any misfit degrades
        return None, f"{type(e).__name__}: {str(e)[:200]}"


@torch.no_grad()
def run_compare(sd, model, args) -> int:
    """The port's ``UniDepthV2`` (``model``, the checkpoint loaded) against
    the oracle on the same weights: 0 within ``args.tol``, else 1."""
    import numpy as np

    from ..models.unidepth import preprocess
    from ..models.unidepth_mirror import torch_decoder_mirror

    norm_sd = {(k[len("pixel_decoder."):]
                if k.startswith("pixel_decoder.") else k): v
               for k, v in sd.items()}
    dec_sd = {k: torch.as_tensor(v).float() for k, v in norm_sd.items()
              if not k.startswith("pixel_encoder.")}
    adapter = model.input_adapters[0]
    mirror = torch_decoder_mirror(
        dim=adapter.out_features, backbone_dim=adapter.in_features,
        n_adapt=args.num_adapters, cam_blocks=args.camera_blocks,
        depth_blocks=args.depth_blocks).eval()
    mirror.load_state_dict(dec_sd, strict=True)

    enc_sd = {k[len("pixel_encoder."):]: torch.as_tensor(v).float()
              for k, v in norm_sd.items() if k.startswith("pixel_encoder.")}
    oracle = None
    if enc_sd:
        oracle, why = _transformers_backbone(enc_sd, model)
        if oracle is None:
            print(f"NOTE: encoder keys do not fit the transformers "
                  f"Dinov2Model oracle ({why}); degrading to the "
                  f"decoder-only compare (the backbone stays covered by the "
                  f"strict key/shape check above).")

    patch = model.pixel_encoder.patch_size
    if oracle is not None:
        if args.image:
            from PIL import Image

            img01 = np.asarray(Image.open(args.image).convert("RGB"),
                               np.float32) / 255.0
        else:
            img01 = np.random.RandomState(0).rand(518, 518, 3).astype(
                np.float32)
        x, _ = preprocess(torch.from_numpy(img01))
        nh, nw = x.shape[1], x.shape[2]
        gh, gw = nh // patch, nw // patch
        depth_p, k_p = model(x)
        hs = oracle(x.permute(0, 3, 1, 2),
                    output_hidden_states=True).hidden_states
        levels = [oracle.layernorm(hs[i + 1])[:, 1:, :]
                  for i in model.layer_ids]
        depth_o, k_o = mirror(levels, nh, nw, gh, gw)
        scope = f"FULL GRAPH (encoder+decoder), {nh}x{nw} input"
    else:
        gh = gw = 37
        nh, nw = gh * patch, gw * patch
        rs = np.random.RandomState(0)
        dim = adapter.in_features
        levels = [torch.from_numpy(rs.randn(1, gh * gw, dim).astype(
            np.float32) * 0.5) for _ in model.layer_ids]
        depth_p, k_p = model.decode([(t, None) for t in levels], nh, nw,
                                    (gh, gw))
        depth_o, k_o = mirror(levels, nh, nw, gh, gw)
        scope = "DECODER ONLY (synthetic tap features)"

    dp, do = depth_p.double().numpy(), depth_o.double().numpy()
    rel = np.abs(dp - do) / np.maximum(np.abs(do), 1e-6)
    kp, ko = k_p.double().numpy(), k_o.double().numpy()
    k_rel = np.abs(kp - ko) / np.maximum(np.abs(ko), 1e-6)
    print(f"compare [{scope}]:")
    print(f"  depth: port range [{dp.min():.4f}, {dp.max():.4f}]  "
          f"oracle range [{do.min():.4f}, {do.max():.4f}]")
    print(f"  depth rel err: max {rel.max():.3e}  mean {rel.mean():.3e}")
    print(f"  K (intrinsics) rel err: max {k_rel.max():.3e}")
    if rel.max() < args.tol and k_rel.max() < args.tol:
        print(f"COMPARE OK: the port matches the torch oracle on these "
              f"weights within tol={args.tol}.")
        return 0
    print(f"COMPARE FAILED: divergence exceeds tol={args.tol}. The key "
          f"mapping is structurally sound (strict load passed), so suspect "
          f"a semantic gap (activation, normalization, interpolation). "
          f"Bisect with tests/test_torch_unidepth.py's per-module cases.")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
