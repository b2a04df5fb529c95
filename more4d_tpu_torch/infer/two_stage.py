"""Full two-stage inference: single image -> 4D novel-view videos (PyTorch
port of ``more4d_tpu/infer/two_stage.py``).

STAGE 1 (4D-STraG): a depth map lifts the image to a first-frame point
cloud; the control pipeline samples a trajectory video conditioned on text,
the repeated first frame, a grey CLIP image and the depth image; the decoder
adaptor maps the decoded pseudo-RGB back to scene flow; the inverse flow
normalisation recovers absolute per-frame point clouds.

RENDER: the per-frame clouds are rendered along the camera trajectory sweep
with the tile splat kernel (or the z-buffer); the z-buffer's holes become
the inpainting masks.

STAGE 2 (4D-ViSM): the InP pipeline fills the disocclusions of each render.

The text, CLIP and OmniMAE towers come as ``infer.encoders.
ConditioningEncoders`` and the depth as a provider (``models.depth``),
which the caller hands to ``make_two_stage_models`` with the loaded DiTs,
VAE and adaptor (the CLI, ``scripts/infer.py``), or to
``build_two_stage_models``, which builds the 1.3B-class modules with random
weights from a seed. Without a depth map, stage 1 asks the provider for
one.

Unlike the JAX package, nothing here catches an out-of-memory error to fall
back to a serial loop: the serial paths are explicit options
(``batched=False``, ``stage2_batch=1``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import resolve_device
from ..config import PipelineConfig, VAEConfig, dit_1_3b
from ..geometry import (back_project_coords, get_intrinsic_matrix,
                        inverse_flow_norm)
from ..geometry.cameras import TRAJECTORY_TYPES, generate_trajectory
from ..geometry.render import zbuffer_render_sweep, zbuffer_render_video
from ..kernels.gs_splat import gs_render_sweep, gs_render_tiled_video
from ..models.adaptors import VAEDecoderAdaptor
from ..models.wan_dit import WanDiT
from ..models.wan_vae import WanVAE
from ..nn.resize import resize
from ..pipelines import (TeaCacheConfig, WanControlPipeline,
                         WanInpaintPipeline)
from .encoders import ConditioningEncoders


@dataclasses.dataclass
class TwoStageModels:
    """The two pipelines (each holding its DiT and the shared VAE; either
    may be None when its stage does not run), the decoder adaptor, the
    encoder callables and the depth provider (image01 [H, W, 3] -> depth
    [H, W], a tensor or an array)."""

    control_pipeline: Optional[WanControlPipeline]
    inpaint_pipeline: Optional[WanInpaintPipeline]
    decoder_adaptor: VAEDecoderAdaptor
    encode_text: Callable[[Sequence[str]], torch.Tensor]
    encode_image_clip: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    extract_mpm: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    estimate_depth: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return (self.control_pipeline or self.inpaint_pipeline).device


def make_two_stage_models(dit4: Optional[WanDiT], dit_inp: Optional[WanDiT],
                          vae: WanVAE, decoder_adaptor: VAEDecoderAdaptor,
                          encoders: ConditioningEncoders,
                          pipeline_cfg: PipelineConfig = PipelineConfig(),
                          stage2_cfg: Optional[PipelineConfig] = None,
                          device="cuda", estimate_depth=None,
                          teacache: Optional[TeaCacheConfig] = None
                          ) -> TwoStageModels:
    """The two-stage models from modules that already hold their weights
    (a checkpoint's, or random ones). ``dit4`` or ``dit_inp`` may be None
    when its stage does not run; ``stage2_cfg`` is the inpaint pipeline's
    config (``pipeline_cfg`` when None); ``teacache`` is the TeaCache both
    pipelines run, or None. The modules move to ``device``."""
    dev = resolve_device(device)
    if encoders.encode_text is None:
        raise ValueError("make_two_stage_models: encoders.encode_text is "
                         "required")
    return TwoStageModels(
        control_pipeline=(None if dit4 is None else WanControlPipeline(
            dit4, vae, pipeline_cfg, dev, teacache=teacache)),
        inpaint_pipeline=(None if dit_inp is None else WanInpaintPipeline(
            dit_inp, vae, stage2_cfg or pipeline_cfg, dev,
            teacache=teacache)),
        decoder_adaptor=decoder_adaptor.to(dev).eval(),
        encode_text=encoders.encode_text,
        encode_image_clip=encoders.encode_clip,
        extract_mpm=encoders.extract_mpm, estimate_depth=estimate_depth)


def build_two_stage_models(encoders: ConditioningEncoders,
                           pipeline_cfg: PipelineConfig = PipelineConfig(),
                           dit4_cfg=None, dit_inp_cfg=None,
                           vae_cfg: Optional[VAEConfig] = None,
                           adaptor_ch: int = 128, seed: int = 0,
                           device="cuda", estimate_depth=None,
                           teacache: Optional[TeaCacheConfig] = None
                           ) -> TwoStageModels:
    """The two-stage models with random weights from ``seed``.

    ``encoders``: the text, CLIP and OmniMAE towers (encode_text is
    required, the other two may be None); ``estimate_depth``: a depth
    provider, or None when every call passes a depth map; ``teacache``:
    the TeaCache both pipelines run, or None. Defaults are the 1.3B
    operating point: the 4D-STraG DiT (motion guidance, in_dim 64, i2v) and
    the InP DiT (in_dim 36, i2v) in bf16, and the Wan VAE in bf16."""
    dev = resolve_device(device)
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    dit4_cfg = dit4_cfg or dit_1_3b(motion_guidance=True, in_dim=64,
                                    model_type="i2v", **bf16)
    dit_inp_cfg = dit_inp_cfg or dit_1_3b(motion_guidance=False, in_dim=36,
                                          model_type="i2v", **bf16)
    vae_cfg = vae_cfg or VAEConfig(**bf16)
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.device(dev):
        dit4 = WanDiT(dit4_cfg).init_weights(gen).to(dit4_cfg.param_dtype)
        dit_inp = WanDiT(dit_inp_cfg).init_weights(gen).to(
            dit_inp_cfg.param_dtype)
        vae = WanVAE(vae_cfg).init_weights(gen).to(vae_cfg.param_dtype)
        adaptor = VAEDecoderAdaptor(ch=adaptor_ch)
    return make_two_stage_models(dit4, dit_inp, vae, adaptor, encoders,
                                 pipeline_cfg, device=dev,
                                 estimate_depth=estimate_depth,
                                 teacache=teacache)


def grey_clip_image(batch: int, size: int = 512, device=None) -> torch.Tensor:
    """The flow model is conditioned on a grey (127,127,127) CLIP image, in
    [-1, 1]: 2*(127/255) - 1."""
    grey = 2.0 * (127.0 / 255.0) - 1.0
    return torch.full((batch, size, size, 3), grey, dtype=torch.float32,
                      device=device)


def depth_to_image(depth: torch.Tensor) -> torch.Tensor:
    """Depth [H, W] -> 3ch conditioning image [1, 1, H, W, 3] in [-1, 1]:
    clamp to [0, 1e4], non-finite or near-zero values to 1, then per-image
    min-max to [-1, 1]."""
    d = depth.clamp(0.0, 10000.0)
    bad = ~torch.isfinite(d) | (d < 1e-5)
    d = torch.where(bad, torch.ones_like(d), d)
    dmin, dmax = d.min(), d.max()
    d = 2.0 * (d - dmin) / (dmax - dmin + 1e-8) - 1.0
    return d[None, None, ..., None].expand(1, 1, *d.shape, 3)


@torch.no_grad()
def stage1_generate(m: TwoStageModels, image01, prompt: str,
                    negative_prompt: str = "", depth=None,
                    generator: Optional[torch.Generator] = None,
                    normalize_track_z: bool = False, use_depth: bool = True):
    """image01: [H, W, 3] in [0, 1]. Returns (coords [T, H*W, 3] absolute
    per-frame point clouds, colors [H*W, 3] in [0, 1]), tensors on the
    pipeline's device."""
    pipe = m.control_pipeline
    dev = pipe.device
    h, w = pipe.config.height, pipe.config.width
    t_frames = pipe.config.num_frames
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    if depth is None:
        if m.estimate_depth is None:
            raise ValueError("no depth map and no depth provider")
        depth = m.estimate_depth(image01)
    depth = torch.as_tensor(depth, dtype=torch.float32).to(dev)
    first_frame_coords = back_project_coords(depth, h, w)       # [H, W, 3]

    image01 = torch.as_tensor(image01, dtype=torch.float32).to(dev)
    image = resize(image01 * 2.0 - 1.0, (h, w, 3))
    control_video = image[None, None].expand(1, t_frames, h, w, 3)
    depth_img = None
    if use_depth:
        depth_img = resize(depth_to_image(depth), (1, 1, h, w, 3))

    prompt_embeds = m.encode_text([prompt])
    neg_embeds = m.encode_text([negative_prompt])
    clip_fea = None
    if m.encode_image_clip is not None:
        # CLIP features of an actual mid-grey image, not a zeroed embedding
        clip_fea = m.encode_image_clip(grey_clip_image(1, max(h, w), dev))
    mpm = m.extract_mpm(image01[None]) if m.extract_mpm is not None else None

    flow_video = pipe(generator, prompt_embeds, neg_embeds=neg_embeds,
                      control_video=control_video,
                      start_image=image[None, None], depth_image=depth_img,
                      clip_fea=clip_fea, mpm_features=mpm,
                      output_type="no_normalize")            # [1,T,H,W,3]
    recon_flow = m.decoder_adaptor(flow_video)
    if normalize_track_z:
        coords_video = recon_flow + first_frame_coords[None, None]
    else:
        coords_video, _ = inverse_flow_norm(recon_flow,
                                            first_frame_coords[None])
    # frame 0 is the exact lifted cloud
    coords_video = torch.cat([first_frame_coords[None, None],
                              coords_video[:, 1:]], dim=1)
    coords = coords_video[0].reshape(t_frames, -1, 3)
    colors = (image * 0.5 + 0.5).reshape(-1, 3)
    return coords, colors


def one_cloud(coords, colors, sweep: bool):
    """Stage 1's clouds as the world's rank 0 made them, on every rank
    whose work joins the other ranks': under an installed seq mesh (each
    rank decodes the gathered DiT output and renders for itself) and in
    the data-parallel sweep (each rank inpaints its own trajectories of
    the render). A rank's own decode can differ from rank 0's in its last
    bits, and a render moves whole pixels with them. Elsewhere, and on a
    world of one, the clouds as they are."""
    from ..parallel.mesh import broadcast_from_first, world_size
    from ..parallel.ulysses import seq_parallel_size

    if world_size() == 1 or not (sweep or seq_parallel_size() > 1):
        return coords, colors
    coords, colors = broadcast_from_first([coords, colors])
    return coords, colors


def _trajectory_names(trajectory_types):
    """Names carry the canonical sweep index; custom entries fall back to
    their position."""
    names = []
    for i, tt in enumerate(trajectory_types):
        idx = TRAJECTORY_TYPES.index(tt) if tt in TRAJECTORY_TYPES else i
        names.append(f"{tt[0]}_{idx}")
    return names


@torch.no_grad()
def render_trajectories(coords, colors, height: int, width: int,
                        trajectory_types=None, use_gs: bool = True,
                        batched: bool = True) -> List[Dict[str, torch.Tensor]]:
    """Render the camera sweep for per-frame point clouds.

    coords: [T, N, 3]; colors: [N, 3] in [0, 1] (tensors, or arrays put on
    the CPU). Returns a list of {'name', 'frames' [T,H,W,3], 'mask' [T,H,W]
    bool} per trajectory. ``batched`` renders the whole sweep through the
    sweep renderers (frame j renders cloud j % T); ``batched=False`` loops
    over the trajectories. The mask always comes from the z-buffer."""
    coords = torch.as_tensor(coords)
    colors = torch.as_tensor(colors).to(coords.device)
    dev = coords.device
    trajectory_types = trajectory_types or TRAJECTORY_TYPES
    t = coords.shape[0]
    # the center comes from the FIRST frame's cloud only, on the host in
    # numpy as the JAX package computes it
    center = coords[0].reshape(-1, 3).cpu().numpy().mean(axis=0)
    intr = get_intrinsic_matrix(height, width, device=dev)
    names = _trajectory_names(trajectory_types)
    exts_list = [torch.as_tensor(generate_trajectory(name, center, t, **kw),
                                 device=dev)
                 for name, kw in trajectory_types]

    if batched and len(trajectory_types) > 1:
        k = len(trajectory_types)
        exts_all = torch.cat(exts_list)
        frames, hole = zbuffer_render_sweep(coords, colors, exts_all, intr,
                                            height, width)
        if use_gs:
            frames, _ = gs_render_sweep(coords, colors, exts_all, intr,
                                        height, width)
        frames = frames.reshape(k, t, height, width, -1)
        hole = hole.reshape(k, t, height, width)
        return [{"name": n, "frames": frames[i], "mask": hole[i]}
                for i, n in enumerate(names)]

    out = []
    for name_i, exts in zip(names, exts_list):
        frames, hole = zbuffer_render_video(coords, colors, exts, intr,
                                            height, width)
        if use_gs:
            frames, _ = gs_render_tiled_video(coords, colors, exts, intr,
                                              height, width)
        out.append({"name": name_i, "frames": frames, "mask": hole})
    return out


@torch.no_grad()
def stage2_inpaint_batch(m: TwoStageModels,
                         renders: Sequence[Dict[str, torch.Tensor]],
                         prompt: str, negative_prompt: str = "",
                         generator: Optional[torch.Generator] = None,
                         decode_chunk: int = 1,
                         denoise_group: Optional[int] = None,
                         shared_noise: bool = True,
                         latents: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Fill the disocclusions of K renders: one batched VAE encode, the
    denoise loop over groups of ``denoise_group`` renders (None: all K in
    one loop), and the decode in chunks of ``decode_chunk``. With
    ``shared_noise`` every render starts from the same initial noise, as
    the reference re-seeds before each trajectory, so K changes no number;
    otherwise the K noises are drawn from ``generator`` at once. ``latents``
    ([K, ...], the initial noise) replaces the draw. Returns [K,T,H,W,3]
    in [0, 1]."""
    pipe = m.inpaint_pipeline
    dev = pipe.device
    if generator is None:
        generator = torch.Generator(dev).manual_seed(1)
    k = len(renders)
    if latents is not None:
        latents = latents.to(dev)
    elif shared_noise:
        latents = pipe.prepare_latents(generator, 1).repeat(k, 1, 1, 1, 1)
    else:
        latents = pipe.prepare_latents(generator, k)

    video_k = torch.stack([torch.as_tensor(r["frames"]).to(dev)
                           for r in renders]).float() * 2.0 - 1.0
    mask_k = torch.stack([torch.as_tensor(r["mask"]).to(dev)
                          for r in renders]).float()[..., None]
    y = pipe.prepare_conditions(latents.shape, video_k, mask_k)
    del video_k, mask_k
    clip_fea = None
    if m.encode_image_clip is not None:
        clip_fea = torch.cat([
            m.encode_image_clip(torch.as_tensor(r["frames"][:1]).to(dev)
                                * 2.0 - 1.0) for r in renders])
    prompt_embeds = m.encode_text([prompt]).repeat(k, 1, 1)
    neg_embeds = m.encode_text([negative_prompt]).repeat(k, 1, 1)

    g = k if denoise_group is None else max(int(denoise_group), 1)
    latents = torch.cat([pipe.denoise(
        latents[i:i + g], prompt_embeds[i:i + g], neg_embeds[i:i + g],
        y=y[i:i + g], clip_fea=None if clip_fea is None else clip_fea[i:i + g])
        for i in range(0, k, g)])
    dc = max(decode_chunk, 1)
    return torch.cat([pipe.decode_latents(latents[i:i + dc])
                      for i in range(0, k, dc)])


def stage2_inpaint(m: TwoStageModels, render: Dict[str, torch.Tensor],
                   prompt: str, negative_prompt: str = "",
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Fill the disocclusions of one render. Returns [T,H,W,3] in [0, 1]."""
    return stage2_inpaint_batch(m, [render], prompt, negative_prompt,
                                generator=generator)[0]


@torch.no_grad()
def stage2_inpaint_dp(m: TwoStageModels,
                      renders: Sequence[Dict[str, torch.Tensor]],
                      prompt: str, negative_prompt: str = "",
                      generator: Optional[torch.Generator] = None,
                      mesh=None, shared_noise: bool = False) -> torch.Tensor:
    """The trajectory sweep data-parallel: K renders split over ``mesh``'s
    (dcn, data) ranks (a 1-D data mesh over the world when None), each
    rank encoding, denoising and decoding its rows with no communication,
    then the videos gathered on every rank. K is padded to a multiple of
    the data size by repeating the last render (its rows are dropped on
    return).

    Every rank draws the noise of the K real trajectories from
    ``generator`` (one row repeated with ``shared_noise``) and pads it by
    repetition, so the videos equal the serial sweep's on any world size.
    An installed seq mesh (``parallel.set_mesh``) is cleared for the sweep
    and restored after it. Returns [K,T,H,W,3] in [0, 1]."""
    import torch.distributed as dist

    from ..parallel import MeshConfig, create_mesh, get_mesh, set_mesh
    from ..parallel.mesh import data_group, data_rows, data_size

    pipe = m.inpaint_pipeline
    dev = pipe.device
    if mesh is None:
        mesh = create_mesh(MeshConfig(data=-1, fsdp=1, seq=1), device=dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(1)
    k = len(renders)
    dp = data_size(mesh)
    k_pad = -(-k // dp) * dp
    if shared_noise:
        latents = pipe.prepare_latents(generator, 1).repeat(k, 1, 1, 1, 1)
    else:
        latents = pipe.prepare_latents(generator, k)
    latents = torch.cat([latents, latents[-1:].repeat(
        k_pad - k, *[1] * (latents.dim() - 1))])
    rows = data_rows(mesh, k_pad)
    mine = (list(renders) + [renders[-1]] * (k_pad - k))[rows]
    prev = get_mesh()
    set_mesh(None)
    try:
        out = stage2_inpaint_batch(m, mine, prompt, negative_prompt,
                                   latents=latents[rows])
    finally:
        set_mesh(prev)
    group = data_group(mesh)
    gathered = torch.empty((k_pad,) + out.shape[1:], dtype=out.dtype,
                           device=out.device)
    dist.all_gather_into_tensor(gathered, out.contiguous(), group=group)
    return gathered[:k]


def stage2_sweep(m: TwoStageModels,
                 renders: Sequence[Dict[str, torch.Tensor]], prompt: str,
                 negative_prompt: str, seed: int, stage2_batch: int = 1,
                 stage2_denoise_group: Optional[int] = None,
                 stage2_shared_noise: bool = True, sweep_mesh=None
                 ) -> List[Dict]:
    """Stage 2 over every render, ``stage2_batch`` renders a batched call
    (``stage2_inpaint_batch``, its denoise loop in groups of
    ``stage2_denoise_group``). Each chunk draws its noise from a generator
    seeded ``seed`` (``stage2_shared_noise``: the reference re-seeds before
    each trajectory), or else the chunk at c0 from one seeded ``seed + c0``,
    as the JAX package folds c0 into its key. With ``sweep_mesh`` the whole
    sweep runs data-parallel over it (``stage2_inpaint_dp``, from ``seed``
    as the first chunk; ``stage2_batch`` and ``stage2_denoise_group`` are
    then unused). Returns [{'name', 'video'}] in the renders' order."""
    dev = m.device
    if sweep_mesh is not None:
        outs = stage2_inpaint_dp(
            m, renders, prompt, negative_prompt,
            generator=torch.Generator(dev).manual_seed(seed),
            mesh=sweep_mesh, shared_noise=stage2_shared_noise)
    else:
        outs, step = [], max(stage2_batch, 1)
        for c0 in range(0, len(renders), step):
            gen = torch.Generator(dev).manual_seed(
                seed + (0 if stage2_shared_noise else c0))
            outs += stage2_inpaint_batch(
                m, renders[c0:c0 + step], prompt, negative_prompt,
                generator=gen, denoise_group=stage2_denoise_group,
                shared_noise=stage2_shared_noise).unbind(0)
    return [{"name": r["name"], "video": v} for r, v in zip(renders, outs)]


def run_two_stage(m: TwoStageModels, image01, prompt: str,
                  negative_prompt: str = "", depth=None,
                  trajectory_types=None, use_gs: bool = True, seed: int = 0,
                  stage2_batch: int = 1,
                  stage2_denoise_group: Optional[int] = None,
                  stage2_shared_noise: bool = True,
                  timings: Optional[Dict[str, float]] = None,
                  sweep_mesh=None):
    """Single image -> one inpainted novel-view video per camera
    trajectory, plus the stage-1 point clouds.

    Stage 1 draws its noise from a generator seeded with ``seed``; stage 2
    is ``stage2_sweep`` from ``seed + 1`` (``stage2_batch``: 1, the
    default, is the serial sweep; ``stage2_denoise_group``: None is the
    whole chunk; ``sweep_mesh``: a device mesh over which the whole sweep
    runs data-parallel). ``timings``: a dict that receives each stage's
    wall seconds ('stage1_s', 'render_s', 'stage2_s'), the device
    synchronised at each stage's end. Under a seq mesh or
    ``sweep_mesh`` every rank renders rank 0's clouds (``one_cloud``).
    Returns {'coords', 'colors', 'renders', 'videos'} with tensors on the
    pipelines' device."""
    dev = m.device
    clock = _StageClock(dev, timings)
    coords, colors = one_cloud(*stage1_generate(
        m, image01, prompt, negative_prompt, depth=depth,
        generator=torch.Generator(dev).manual_seed(seed)),
        sweep=sweep_mesh is not None)
    clock.lap("stage1_s")
    pipe = m.inpaint_pipeline
    renders = render_trajectories(coords, colors, pipe.config.height,
                                  pipe.config.width, trajectory_types, use_gs)
    clock.lap("render_s")
    videos = stage2_sweep(m, renders, prompt, negative_prompt, seed + 1,
                          stage2_batch, stage2_denoise_group,
                          stage2_shared_noise, sweep_mesh)
    clock.lap("stage2_s")
    return {"coords": coords, "colors": colors, "renders": renders,
            "videos": videos}


class _StageClock:
    """Wall seconds per stage into ``timings`` (nothing when it is None)."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.t0 = time.perf_counter()

    def lap(self, name):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.t0
        self.t0 = now
