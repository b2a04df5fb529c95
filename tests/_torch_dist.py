"""Multi-rank workers for the port's CPU tests: each test spawns its ranks
as processes (``torch.multiprocessing``, spawn) joined by gloo through a
``file://`` store under the test's ``tmp_path``, so tests running side by
side under xdist share no port. This module imports no JAX, so the ranks
never load it; the tests hand their inputs in and get each rank's result
back as ``torch.save``d files.

Every spawn has its own time limit: the process group's collectives time
out after 60 s, and ``spawn`` terminates the ranks and fails the test when
they have not ended by ``timeout``.
"""

from __future__ import annotations

import os
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def _entry(worker, rank, world, init, out_dir, args):
    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world,
                                timeout=COLLECTIVE_TIMEOUT)
        result = worker(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        from more4d_tpu_torch.parallel import set_mesh

        set_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(worker, world, tmp_path, *args, timeout=150.0):
    """Run ``worker(rank, world, *args)`` on ``world`` gloo ranks; returns
    each rank's return value, in rank order. Fails on a rank's error, or
    when the ranks have not ended after ``timeout`` seconds."""
    import time

    import torch.multiprocessing as mp

    out_dir = tmp_path / f"ranks_{worker.__name__}_{world}"
    out_dir.mkdir(parents=True, exist_ok=True)
    init = f"file://{out_dir / 'store'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(worker, r, world, init,
                                              str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
    errors = [(out_dir / f"rank{r}.err") for r in range(world)]
    msg = "".join(e.read_text() for e in errors if e.exists())
    if hung:
        raise AssertionError(f"ranks {hung} of {world} still running after "
                             f"{timeout} s; terminated\n{msg}")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} of {world} failed\n{msg}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _mesh(**axes):
    from more4d_tpu_torch.parallel import MeshConfig, create_mesh

    return create_mesh(MeshConfig(**axes), device="cpu")


# ---- the mesh's layout ------------------------------------------------------

def layout_worker(rank, world):
    """dcn=2 x fsdp=2: this rank's coordinate, its rows of arange(8), the
    ranks of its FSDP replicate and shard groups, and each parameter of
    the tiny DiT sharded by ``shard_params``: (shape, placements); and on
    data=2 x seq=2 its coordinate and rows."""
    from more4d_tpu_torch.config import dit_tiny
    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.parallel import data_sharding, shard_params
    from more4d_tpu_torch.parallel.mesh import fsdp_mesh

    mesh = _mesh(dcn=2, data=1, fsdp=2, seq=1)
    dit = WanDiT(dit_tiny(dtype=torch.float32))
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in dit.named_parameters()}
    shard_params(dit, mesh)
    m2 = fsdp_mesh(mesh)
    seq = _mesh(data=2, fsdp=1, seq=2)
    return {"coord": list(mesh.get_coordinate()),
            "seq_coord": list(seq.get_coordinate()),
            "seq_rows": data_sharding(seq, torch.arange(8.0)).numpy(),
            "rows": data_sharding(mesh, torch.arange(8.0)).numpy(),
            "replicate": dist.get_process_group_ranks(m2.get_group(0)),
            "shard": dist.get_process_group_ranks(m2.get_group(1)),
            "params": {n: (shapes[n], str(p.placements))
                       for n, p in dit.named_parameters()}}


# ---- Ulysses attention ----------------------------------------------------

def ulysses_worker(rank, world, q, k, v, kv_lens, dout):
    """Ulysses attention on this rank's L/S chunk of q/k/v (fp32 numpy,
    [B, L, H, D]) over a seq mesh of the whole world, and the gradients of
    sum(out * dout) for q, k, v; returns the chunks."""
    from more4d_tpu_torch.kernels.flash_attention import flash_attention
    from more4d_tpu_torch.parallel import ulysses_attention

    mesh = _mesh(data=1, fsdp=1, seq=world)
    per = q.shape[1] // world
    rows = slice(rank * per, (rank + 1) * per)
    qc, kc, vc = (torch.from_numpy(np.ascontiguousarray(a[:, rows]))
                  .requires_grad_() for a in (q, k, v))
    lens = None if kv_lens is None else torch.from_numpy(kv_lens)

    def attn(q, k, v, lens):
        return flash_attention(q, k, v, kv_lens=lens)

    out = ulysses_attention(attn, qc, kc, vc, kv_lens=lens, mesh=mesh)
    (out * torch.from_numpy(np.ascontiguousarray(dout[:, rows]))).sum() \
        .backward()
    return {"out": out.detach().numpy(), "dq": qc.grad.numpy(),
            "dk": kc.grad.numpy(), "dv": vc.grad.numpy()}


def ulysses_heads_worker(rank, world):
    """The error for heads that do not split over the seq axis."""
    from more4d_tpu_torch.parallel import ulysses_attention

    mesh = _mesh(data=1, fsdp=1, seq=world)
    x = torch.zeros(1, 2, 3, 4)
    try:
        ulysses_attention(lambda *a: a[0], x, x, x, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


# ---- the sequence-parallel DiT ---------------------------------------------

def seq_dit_worker(rank, world, cfg_kw, state, inputs, sp, perturb=False):
    """The tiny DiT's forward under an installed seq mesh of ``sp`` (the
    rest of the world on fsdp, parameters sharded by ``shard_params``);
    returns the output. ``perturb``: the ranks off seq rank 0 add 1 to
    every array input but the timestep first."""
    from more4d_tpu_torch.config import dit_tiny
    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.parallel import set_mesh, shard_params

    mesh = _mesh(data=1, fsdp=-1, seq=sp)
    cfg = dit_tiny(dtype=torch.float32, **cfg_kw)
    dit = WanDiT(cfg)
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    shard_params(dit, mesh, min_size=256)
    set_mesh(mesh)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    if perturb and mesh.get_local_rank("seq"):
        t = {k: v if k == "t" else v + 1.0 for k, v in t.items()}
    with torch.no_grad():
        out = dit(t.pop("x"), t.pop("t"), t.pop("context"), **t)
    return out.numpy()


def streamed_teacache_case(zero_e0=False):
    """(the tiny streamed DiT, its denoise inputs, a TeaCache whose poly
    is the relative L1 change of e0 at a threshold of 2.0): the same on
    every rank. ``zero_e0``: the time projection zeroed, so this copy's
    own e0 is 0 at every step and would replay every step after the
    first."""
    from more4d_tpu_torch.config import dit_tiny
    from more4d_tpu_torch.diffusion import get_scheduler
    from more4d_tpu_torch.parallel import StreamedDiT, make_host_blocks
    from more4d_tpu_torch.pipelines import ScheduleTeaCache

    cfg = dit_tiny(dtype=torch.float32, param_dtype=torch.float32)
    resident, host = make_host_blocks(cfg, cfg.num_layers, "none", "cpu",
                                      seed=5)
    resident = resident.float().init_weights(
        torch.Generator().manual_seed(6))
    with torch.no_grad():
        resident.head.head.weight.normal_(
            0.0, 0.02, generator=torch.Generator().manual_seed(7))
        if zero_e0:
            resident.time_projection[1].weight.zero_()
            resident.time_projection[1].bias.zero_()
    rs = np.random.RandomState(8)
    inputs = dict(
        latents=torch.from_numpy(rs.randn(1, 2, 4, 6, 16).astype(np.float32)),
        prompt_embeds=torch.from_numpy(
            rs.randn(1, 6, cfg.text_dim).astype(np.float32)),
        neg_embeds=torch.from_numpy(
            rs.randn(1, 6, cfg.text_dim).astype(np.float32)),
        y=torch.from_numpy(rs.randn(1, 2, 4, 6, cfg.in_dim - 16).astype(
            np.float32)),
        clip_fea=torch.from_numpy(rs.randn(1, cfg.clip_tokens,
                                           cfg.clip_dim).astype(np.float32)))
    teacache = ScheduleTeaCache((0.0, 0.0, 0.0, 1.0, 0.0), 2.0, 1)
    return (StreamedDiT(resident, host, "cpu"), get_scheduler("flow", 8, 3.0),
            inputs, teacache)


def streamed_teacache_worker(rank, world):
    """The streamed denoise under a seq mesh of the world, TeaCache on;
    the rank off seq rank 0 has its time projection zeroed, so only seq
    rank 0's e0 gives the ranks one decision a step. Returns the latents
    and the calc/replay sequence."""
    from more4d_tpu_torch.parallel import set_mesh

    sd, scheduler, inputs, teacache = streamed_teacache_case(
        zero_e0=rank > 0)
    set_mesh(_mesh(data=1, fsdp=1, seq=world))
    out = sd.denoise(scheduler, teacache=teacache, guidance_scale=5.0,
                     **inputs)
    return out.numpy(), [c for _, _, c in teacache.log]


def one_cloud_worker(rank, world, sweep, sp):
    """``two_stage.one_cloud`` on clouds that differ by rank (rank r's are
    full of r), with a seq mesh of ``sp`` installed; returns what this
    rank gets."""
    from more4d_tpu_torch.infer.two_stage import one_cloud
    from more4d_tpu_torch.parallel import set_mesh

    if sp > 1:
        set_mesh(_mesh(data=1, fsdp=-1, seq=sp))
    coords, colors = one_cloud(torch.full((2, 5, 3), float(rank)),
                               torch.full((5, 3), float(rank)), sweep=sweep)
    return coords.numpy(), colors.numpy()


# ---- the STraG trainer on a mesh -------------------------------------------

def stand_in_encoders(text_dim, clip_tokens, clip_dim, mpm_dim, h, w, to,
                      distinct_clip=False):
    """Deterministic stand-ins with the towers' call signatures (the
    arithmetic of ``tests/test_torch_train_harness.py``'s), returning
    ``to(numpy array)``: the same numbers for JAX and the port. The CLIP
    stand-in gives every token the image's pooled features, so the image
    keys are all alike and their projection's gradient is zero but for
    rounding; ``distinct_clip`` adds a fixed offset a token."""
    rs = np.random.RandomState(7)
    vocab = rs.randn(64, text_dim).astype(np.float32)
    wc = rs.randn(3, clip_dim).astype(np.float32)
    wm = rs.randn(3, mpm_dim).astype(np.float32)
    offsets = (rs.randn(clip_tokens, clip_dim).astype(np.float32)
               if distinct_clip else np.zeros((clip_tokens, clip_dim),
                                              np.float32))

    def encode_text(prompts):
        out = np.zeros((len(prompts), 8, text_dim), np.float32)
        for i, p in enumerate(prompts):
            for j, word in enumerate(p.split()[:8]):
                out[i, j] = vocab[len(word) * 7 % 64]
        return to(out)

    def encode_clip(images):
        pooled = np.asarray(images, np.float32).mean(axis=(1, 2)) @ wc
        return to(np.ascontiguousarray(pooled[:, None] + offsets))

    def extract_mpm(images01):
        x = np.asarray(images01, np.float32)[:, ::h // 14 or 1][:, :14]
        x = x[:, :, ::w // 14 or 1][:, :, :14]
        return to(x.reshape(len(x), 196, 3) @ wm)

    return encode_text, encode_clip, extract_mpm


def scene_sample(seed, cls, t, h, w):
    """A synthetic scene-flow sample of ``cls`` (either package's
    ``SceneFlowSample``)."""
    rs = np.random.RandomState(seed)
    flow = rs.randn(t, h, w, 3).astype(np.float32) * 0.1
    rgb = rs.rand(h, w, 3).astype(np.float32)
    return cls(flow=flow,
               first_frame_coords=rs.rand(h, w, 3).astype(np.float32),
               control_video=np.repeat((rgb * 2 - 1)[None], t, 0),
               first_frame_rgb=rgb,
               depth_image=rs.rand(1, h, w, 3).astype(np.float32) * 2 - 1)


def scene_batches(sizes, batch, start, cls, prompt="a scene moves"):
    """Global batches of ``batch`` samples from step ``start`` on, the
    sample of step s, row i seeded 100 + s * batch + i."""
    t, h, w = sizes
    step = start
    while True:
        yield ([scene_sample(100 + step * batch + i, cls, t, h, w)
                for i in range(batch)], [prompt] * batch)
        step += 1


def build_straag_trainer(spec, mesh=None, out_dir=None, resume=False):
    """The port's ``StraagTrainer`` from ``spec`` (the tiny configs and
    numpy state dicts of the test), on ``mesh``, with ``harness.draw``
    replaced by ``spec['draws']`` (JAX's draws of the global batch, a pair
    a step): each rank takes its rows of them. ``spec['optimizer']`` 'came'
    gives CAME as the CLI builds it (``make_optimizer``), else the
    trainer's default AdamW."""
    from more4d_tpu_torch.config import VAEConfig, dit_tiny
    from more4d_tpu_torch.models import VAEEncoderAdaptor, WanDiT, WanVAE
    from more4d_tpu_torch.parallel import shard_params
    from more4d_tpu_torch.train import (StraagRunConfig, StraagTrainConfig,
                                        StraagTrainer, harness)

    def load(module, state):
        module.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in state.items()}, strict=True)
        return module

    cfg = dit_tiny(dtype=torch.float32, **spec["dit"])
    dit = load(WanDiT(cfg), spec["dit_state"])
    if mesh is not None:
        shard_params(dit, mesh)
    vae = load(WanVAE(VAEConfig(**spec["vae"])), spec["vae_state"])
    enc = load(VAEEncoderAdaptor(ch=spec["enc_ch"]), spec["enc_state"])
    t, h, w = spec["sizes"]
    text, clip, mpm = stand_in_encoders(
        cfg.text_dim, cfg.clip_tokens, cfg.clip_dim, cfg.motion_feature_dim,
        h, w, torch.from_numpy, distinct_clip=spec.get("distinct_clip", False))
    optimizer = scheduler = None
    if spec.get("optimizer") == "came":
        # the STraG CLI's --optimizer came, built after the sharding
        from more4d_tpu_torch.train.optim import make_optimizer

        optimizer, scheduler = make_optimizer(
            "came", list(dit.named_parameters()),
            spec["tcfg"]["learning_rate"], weight_decay=1e-2)
    trainer = StraagTrainer(
        dit, vae, enc, text, StraagTrainConfig(**spec["tcfg"]),
        StraagRunConfig(output_dir=out_dir, resume=resume, **spec["run"]),
        encode_clip=clip, extract_mpm=mpm, optimizer=optimizer,
        lr_scheduler=scheduler, mesh=mesh)

    def fixed_draw(cfg, batch, generator, rank=0, shards=1):
        idx, noise = spec["draws"][trainer.global_step]
        b = batch["latents"].shape[0]
        rows = slice(rank * b, (rank + 1) * b)
        return (torch.from_numpy(idx[rows]).long(),
                torch.from_numpy(np.ascontiguousarray(noise[rows])))

    harness.draw = fixed_draw
    return trainer


def straag_result(trainer, out_dir):
    """Rank 0's metrics lines and the whole params and EMA (every rank
    takes part in the gather)."""
    import json

    from more4d_tpu_torch.train.checkpoint import full_tree

    params = full_tree(trainer.dit.state_dict())
    ema = full_tree(trainer.ema)
    if dist.get_rank():
        return None
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return {"metrics": lines,
            "params": {k: v.numpy() for k, v in params.items()},
            "ema": {k: v.numpy() for k, v in ema.items()},
            "placements": {n: str(p.placements)
                           for n, p in trainer.dit.named_parameters()}}


def straag_worker(rank, world, spec, mesh_kw, out_dir, start, resume):
    """The port's trainer on a gloo mesh of ``mesh_kw`` from global step
    ``start`` (resuming from ``out_dir``'s latest checkpoint with
    ``resume``) to ``spec['run']['max_steps']``."""
    from more4d_tpu_torch.data import SceneFlowSample

    mesh = _mesh(**mesh_kw)
    trainer = build_straag_trainer(spec, mesh, out_dir, resume)
    trainer.train(scene_batches(spec["sizes"], spec["run"]["batch_size"],
                                start, SceneFlowSample))
    return straag_result(trainer, out_dir)


# ---- the data-parallel trajectory sweep -------------------------------------

def two_stage_models(spec):
    """The port's tiny two-stage models from ``spec`` (the numpy weights,
    encoder outputs and noise of ``tests/test_torch_two_stage_dp.py``)."""
    from more4d_tpu_torch.config import PipelineConfig, VAEConfig, dit_tiny
    from more4d_tpu_torch.infer.two_stage import TwoStageModels
    from more4d_tpu_torch.models import VAEDecoderAdaptor, WanDiT, WanVAE
    from more4d_tpu_torch.pipelines import (WanControlPipeline,
                                            WanInpaintPipeline)

    def load(module, state):
        module.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in state.items()}, strict=True)
        return module

    dit4 = load(WanDiT(dit_tiny(dtype=torch.float32, **spec["dit4"])),
                spec["dit4_state"])
    dit_inp = load(WanDiT(dit_tiny(dtype=torch.float32, **spec["dit_inp"])),
                   spec["dit_inp_state"])
    vae = load(WanVAE(VAEConfig(**spec["vae"])), spec["vae_state"])
    dec = load(VAEDecoderAdaptor(ch=spec["dec_ch"]), spec["dec_state"])
    pcfg = PipelineConfig(**spec["pcfg"])
    ctrl = WanControlPipeline(dit4, vae, pcfg, "cpu")
    inp = WanInpaintPipeline(dit_inp, vae, pcfg, "cpu")
    n1, n2 = spec["noise1"], spec["noise2"]
    ctrl.prepare_latents = lambda g, b, *a, **k: torch.from_numpy(n1[:b])
    inp.prepare_latents = lambda g, b, *a, **k: torch.from_numpy(n2[:b])
    text, clip, mpm = spec["text"], spec["clip"], spec["mpm"]
    return TwoStageModels(
        control_pipeline=ctrl, inpaint_pipeline=inp, decoder_adaptor=dec,
        encode_text=lambda ps: torch.cat([torch.from_numpy(text[p])
                                          for p in ps]),
        encode_image_clip=lambda im: torch.from_numpy(clip).repeat(
            im.shape[0], 1, 1),
        extract_mpm=lambda im: torch.from_numpy(mpm).repeat(
            im.shape[0], 1, 1))


def sweep_dp_worker(rank, world, spec):
    """``stage2_inpaint_dp`` over a data mesh of the world on the JAX
    renders (independent noise and shared noise, 3 trajectories), with a
    stale seq mesh installed that must be cleared for the sweep (Ulysses
    must not run) and restored; then ``run_two_stage(sweep_mesh=)``."""
    import more4d_tpu_torch.parallel.ulysses as ulysses
    from more4d_tpu_torch.infer.two_stage import (run_two_stage,
                                                  stage2_inpaint_dp)
    from more4d_tpu_torch.parallel import get_mesh, set_mesh

    m = two_stage_models(spec)
    renders = [{k: torch.from_numpy(np.asarray(v)) if k != "name" else v
                for k, v in r.items()} for r in spec["renders"]]
    stale = _mesh(data=1, fsdp=1, seq=world)
    set_mesh(stale)

    def must_not_route(*a, **k):
        raise AssertionError("ulysses_attention ran inside the sweep")

    ulysses.ulysses_attention = must_not_route
    prompt = spec["prompt"]
    out = {"independent": stage2_inpaint_dp(m, renders, prompt).numpy(),
           "shared": stage2_inpaint_dp(m, renders, prompt,
                                       shared_noise=True).numpy(),
           "restored": get_mesh() is stale}
    set_mesh(None)
    run = run_two_stage(m, spec["image"], prompt, depth=spec["depth"],
                        trajectory_types=spec["traj"], use_gs=True,
                        sweep_mesh=_mesh(data=world, fsdp=1))
    out["run"] = [(v["name"], v["video"].numpy()) for v in run["videos"]]
    return out


# ---- the STraG CLI on a mesh -------------------------------------------------

def straag_cli_worker(rank, world, argv, vae_kw):
    """``scripts.train_straag.main(argv)`` at dit_tiny's width (the 1.3B
    and VAE configs patched to tiny ones, as the one-process CLI test
    does); returns rank 0's metrics lines."""
    import functools
    import json

    import more4d_tpu_torch.config as tconfig
    from more4d_tpu_torch.config import VAEConfig, dit_tiny
    from more4d_tpu_torch.scripts import train_straag as cli

    tconfig.dit_1_3b = functools.partial(dit_tiny, dtype=torch.float32)
    tconfig.VAEConfig = lambda **kw: VAEConfig(**{**vae_kw, **kw})
    assert cli.main(argv, device="cpu") == 0
    if rank:
        return None
    out = argv[argv.index("--output_dir") + 1]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---- the inference CLI on a mesh --------------------------------------------

def infer_cli_worker(rank, world, argv):
    """``scripts.infer.main(argv)`` on this rank (the test's tiny
    checkpoints); rank 0 returns the files it wrote and its stage-1
    clouds, rank 1 the files it found written by then; both, for each DiT
    (stage 1's, stage 2's): whether it came out sharded and over how many
    fsdp ranks, the dtypes of its shards where it is whole in fp8 and the
    bytes of fp8 this rank holds against the whole tensors', and for a
    streamed DiT its resident block count and its host blocks'; and the
    token counts every block was given."""
    from more4d_tpu_torch.parallel.mesh import is_sharded
    from more4d_tpu_torch.scripts import infer
    from more4d_tpu_torch.utils.quantize import FP8
    from torch.distributed.tensor import DTensor

    from more4d_tpu_torch.models.wan_dit import WanBlock

    torch.set_num_threads(1)
    tokens = set()
    block_forward = WanBlock.forward
    WanBlock.forward = lambda self, x, *a, **k: tokens.add(x.shape[1]) or \
        block_forward(self, x, *a, **k)
    loaded = []
    load_models = infer.load_models
    infer.load_models = lambda *a, **k: loaded.append(
        load_models(*a, **k)) or loaded[-1]
    assert infer.main(argv, device="cpu") == 0
    out = argv[argv.index("--output_dir") + 1]
    files = sorted(os.listdir(out))
    coords = [f for f in files if f.endswith("_coords.npy")]
    pipes = (loaded[0].control_pipeline, loaded[0].inpaint_pipeline)
    dits = []
    for pipe in pipes:
        dit = pipe.dit
        if is_sharded(dit):
            # the root's parameters stay gathered after a forward
            for m in dit.modules():
                if is_sharded(m):
                    m.reshard()
        params = list(dit.parameters())
        fp8 = [p for p in params if p.dtype == FP8]
        first = params[0]
        streamed = pipe.streamed_dit
        dits.append(dict(
            sharded=is_sharded(dit),
            fsdp=(first.device_mesh.size(1)
                  if isinstance(first, DTensor) else 1),
            all_dtensors=all(isinstance(p, DTensor) for p in params),
            fp8_local_dtypes=sorted({str(p.to_local().dtype) for p in fp8
                                     if isinstance(p, DTensor)}),
            fp8_local_bytes=sum(p.to_local().numel() for p in fp8
                                if isinstance(p, DTensor)),
            fp8_bytes=sum(p.numel() for p in fp8),
            blocks=len(dit.blocks),
            host_blocks=None if streamed is None else [
                str(hb.tensors["ffn.0.weight"].dtype)
                for hb in streamed.host_blocks]))
    return {"files": files,
            "coords": np.load(os.path.join(out, coords[0]))
            if coords and rank == 0 else None,
            "sharded": all(d["sharded"] for d in dits),
            "fsdp": dits[0]["fsdp"], "dits": dits,
            "block_tokens": sorted(tokens)}
