"""Weights and inputs made from ``--seed``, on the card, in the type they
are served in.

The DiT's parameters are listed here from the configuration alone, under
the released Wan checkpoint's names (which the port keeps), so the plain
reference can make the same tensors again without the program: each
group (the parts outside the blocks, then each block) is one
``torch.randn`` from a generator seeded by (seed, group), scaled per
tensor. ``init`` gives every tensor a non-zero draw, the output head and
the FiLM gates included (the program's own initialisation zeroes them,
which would leave the step an identity), so every path of the forward
moves the result:

- matrices and convolution kernels N(0, 1/fan_in);
- biases N(0, 0.02); norm scales 1 + N(0, 0.1);
- modulation tables N(0, dim^-1/2); FiLM gates N(0, 0.3).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, mean, std) of each tensor
Spec = List[Tuple[str, Tuple[int, ...], float, float]]


def mix(seed: int, tag: int) -> int:
    """A generator seed for (seed, tag), for any seed up to 2**62."""
    return (int(seed) * 1_000_003 + int(tag)) % (2 ** 63 - 1)


def _linear(name, n_out, n_in):
    return [(f"{name}.weight", (n_out, n_in), 0.0, n_in ** -0.5),
            (f"{name}.bias", (n_out,), 0.0, 0.02)]


def _norm(name, dim, bias=False):
    out = [(f"{name}.weight", (dim,), 1.0, 0.1)]
    if bias:
        out.append((f"{name}.bias", (dim,), 0.0, 0.02))
    return out


def top_spec(cfg) -> Spec:
    """The parameters outside the blocks."""
    d, taps = cfg["dim"], math.prod(cfg["patch_size"])
    fd, cd = cfg["motion_feature_dim"], cfg["clip_dim"]
    spec = [("patch_embedding.weight", (d, cfg["in_dim"], *cfg["patch_size"]),
             0.0, (cfg["in_dim"] * taps) ** -0.5),
            ("patch_embedding.bias", (d,), 0.0, 0.02)]
    spec += _linear("text_embedding.0", d, cfg["text_dim"])
    spec += _linear("text_embedding.2", d, d)
    spec += _linear("time_embedding.0", d, cfg["freq_dim"])
    spec += _linear("time_embedding.2", d, d)
    spec += _linear("time_projection.1", 6 * d, d)
    if cfg["model_type"] == "i2v":
        spec += _norm("img_emb.proj.0", cd, bias=True)
        spec += _linear("img_emb.proj.1", cd, cd)
        spec += _linear("img_emb.proj.3", d, cd)
        spec += _norm("img_emb.proj.4", d, bias=True)
    if cfg["motion_guidance"]:
        for i in (0, 2):
            spec += [(f"feature_adapter.{i}.weight", (fd, fd, 3, 3), 0.0,
                      (fd * 9) ** -0.5),
                     (f"feature_adapter.{i}.bias", (fd,), 0.0, 0.02)]
    spec.append(("head.modulation", (1, 2, d), 0.0, d ** -0.5))
    spec += _linear("head.head", taps * cfg["out_dim"], d)
    return spec


def block_spec(cfg) -> Spec:
    """One block's parameters, without the ``blocks.<i>.`` prefix."""
    d, f, fd = cfg["dim"], cfg["ffn_dim"], cfg["motion_feature_dim"]
    spec = [("modulation", (1, 6, d), 0.0, d ** -0.5)]
    for n in ("q", "k", "v", "o"):
        spec += _linear(f"self_attn.{n}", d, d)
    spec += _norm("self_attn.norm_q", d) + _norm("self_attn.norm_k", d)
    names = ["q", "k", "v", "o"] + (["k_img", "v_img"]
                                    if cfg["model_type"] == "i2v" else [])
    for n in names:
        spec += _linear(f"cross_attn.{n}", d, d)
    spec += _norm("cross_attn.norm_q", d) + _norm("cross_attn.norm_k", d)
    if cfg["model_type"] == "i2v":
        spec += _norm("cross_attn.norm_k_img", d)
    spec += _norm("norm3", d, bias=True)
    spec += _linear("ffn.0", f, d) + _linear("ffn.2", d, f)
    if cfg["motion_guidance"]:
        for part in ("self", "ffn"):
            spec += _linear(f"spatial_guidance_{part}.spatial_guide.1",
                            2 * d, fd)
            spec.append((f"spatial_guidance_{part}.gate", (d,), 0.0, 0.3))
    return spec


def groups(cfg) -> List[Tuple[int, str, Spec]]:
    """(tag, name prefix, spec) of each group: the top, then each block."""
    out = [(0, "", top_spec(cfg))]
    bs = block_spec(cfg)
    out += [(1 + i, f"blocks.{i}.", bs) for i in range(cfg["num_layers"])]
    return out


def num_params(cfg) -> int:
    return sum(math.prod(s) for _, _, spec in groups(cfg)
               for _, s, _, _ in spec)


@torch.no_grad()
def make_group(seed: int, tag: int, spec: Spec, dtype, device
               ) -> Dict[str, torch.Tensor]:
    """One group's tensors: one draw of the group's size from a generator
    seeded by (seed, tag), cut and scaled per tensor, in ``dtype``."""
    total = sum(math.prod(s) for _, s, _, _ in spec)
    g = torch.Generator(device).manual_seed(mix(seed, tag))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, mean, std in spec:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape).mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        off += n
    return out


def group_maker(cfg, seed: int, dtype, device, transform=None):
    """A function of a group's name prefix ("" or "blocks.<i>.") that makes
    that group's tensors again from the seed in ``dtype``, each passed
    through ``transform(name, tensor)`` when given; and the prefixes in
    order. The reference's weights, a group at a time."""
    tags = {prefix: (tag, spec) for tag, prefix, spec in groups(cfg)}

    def make(prefix):
        tag, spec = tags[prefix]
        made = make_group(seed, tag, spec, dtype, device)
        if transform is None:
            return made
        return {k: transform(prefix + k, v) for k, v in made.items()}
    return make, list(tags)


@torch.no_grad()
def fill_module(module: torch.nn.Module, cfg, seed: int) -> None:
    """Every parameter of ``module`` (a built DiT in its storage dtype, on
    its device) set from the seed, group by group; raises unless its
    parameters are exactly the listed ones."""
    params = dict(module.named_parameters())
    seen = set()
    for tag, prefix, spec in groups(cfg):
        some = params[prefix + spec[0][0]]
        made = make_group(seed, tag, spec, some.dtype, some.device)
        for name, t in made.items():
            p = params[prefix + name]
            if p.shape != t.shape:
                raise ValueError(f"{prefix + name}: the program holds "
                                 f"{tuple(p.shape)}, the spec "
                                 f"{tuple(t.shape)}")
            p.copy_(t)
            seen.add(prefix + name)
        del made
    if seen != set(params):
        raise ValueError(f"parameters outside the spec: "
                         f"{sorted(set(params) - seen)[:5]}; "
                         f"missing: {sorted(seen - set(params))[:5]}")


def video_shapes(cfg, batch: int = 1):
    """(noise latents [B, T', h, w, z], conditioning y [B, T', h, w,
    in_dim - z]) shapes of the configuration's video."""
    t = (cfg["num_frames"] - 1) // cfg["vae_temporal_ratio"] + 1
    h = cfg["height"] // cfg["vae_spatial_ratio"]
    w = cfg["width"] // cfg["vae_spatial_ratio"]
    z = cfg["out_dim"]
    return (batch, t, h, w, z), (batch, t, h, w, cfg["in_dim"] - z)


@torch.no_grad()
def conditioning(cfg, seed: int, tag: int, device) -> Dict[str, torch.Tensor]:
    """One request's inputs from (seed, tag), as the towers and the VAE
    would hand them over, in fp32 holding bf16 values (the DiT takes them
    in bf16): y, the prompt and negative prompt embeddings, the CLIP and
    OmniMAE features; and the fp32 starting latents ``x``."""
    g = torch.Generator(device).manual_seed(mix(seed, tag))
    xs, ys = video_shapes(cfg)

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.bfloat16).float()

    out = {"x": torch.randn(xs, generator=g, device=device,
                            dtype=torch.float32),
           "y": bf16(*ys),
           "context": bf16(1, cfg["text_len"], cfg["text_dim"]),
           "neg_context": bf16(1, cfg["text_len"], cfg["text_dim"]),
           "clip_fea": bf16(1, cfg["clip_tokens"], cfg["clip_dim"]),
           "mpm_features": bf16(1, cfg["mpm_tokens"],
                                cfg["motion_feature_dim"])}
    return out


def train_draw(seed: int, step: int, num_train_timesteps: int, like,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``step``'s timestep index [1] and flow noise (like ``like``)."""
    g = torch.Generator(device).manual_seed(mix(seed, 1_000_000 + step))
    idx = torch.randint(0, num_train_timesteps, (like.shape[0],),
                        generator=g, device=device)
    noise = torch.randn(like.shape, generator=g, device=device,
                        dtype=torch.float32)
    return idx, noise
