"""The streamed walk's copy counters on a card (``parallel/offload.py
StreamedDiT.copies``, ``.copied_bytes``): one copy host -> card of each
block's whole pinned buffer a walk, 40 at the 14B's depth. These tests skip
on a host without a card. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_offload_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from more4d_tpu_torch.config import dit_tiny
from more4d_tpu_torch.parallel.offload import StreamedDiT, make_host_blocks

pytestmark = pytest.mark.cuda

LAYERS = 40


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (pinned host blocks are "
                    "copied only to a card)")
    return torch.device("cuda")


def _inputs(cfg, dev):
    g = torch.Generator(dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    return dict(x=rand(1, 2, 4, 4, cfg.out_dim),
                t=torch.full((1,), 500.0, device=dev),
                context=rand(1, cfg.text_len, cfg.text_dim),
                y=rand(1, 2, 4, 4, cfg.in_dim - cfg.out_dim),
                clip_fea=rand(1, cfg.clip_tokens, cfg.clip_dim),
                mpm_features=rand(1, 16, cfg.motion_feature_dim))


def _streamed(layers, dev, seed):
    """(resident part, host blocks) of a tiny 4D DiT, every weight
    random (``make_host_blocks`` leaves the resident part zero)."""
    cfg = dit_tiny(num_layers=layers, motion_guidance=True, model_type="i2v")
    resident, host = make_host_blocks(cfg, layers, "fp8", dev, seed=seed)
    g = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        for p in resident.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.05)
    return cfg, resident, host


def test_a_walk_copies_each_block_once_whole(dev):
    cfg, resident, host = _streamed(LAYERS, dev, 1)
    sd = StreamedDiT(resident, host, dev)
    block = host[0].flat.numel()
    assert all(hb.flat.numel() == block for hb in host)
    for walk in (lambda: sd(**_inputs(cfg, dev)), sd.copy_blocks):
        copies, nbytes = StreamedDiT.copies, StreamedDiT.copied_bytes
        walk()
        torch.cuda.synchronize(dev)
        assert StreamedDiT.copies - copies == LAYERS
        assert StreamedDiT.copied_bytes - nbytes == LAYERS * block


def test_the_streamed_forward_equals_the_resident_blocks(dev):
    """The counted walk is the right one: the streamed forward gives the
    bits of the same blocks held on the card."""
    cfg, resident, host = _streamed(4, dev, 2)
    sd = StreamedDiT(resident, host, dev)
    x = _inputs(cfg, dev)
    streamed = sd(**x)
    resident.blocks = sd.device_blocks()
    with torch.no_grad():
        whole = resident(**x)
    assert streamed.abs().max() > 0
    assert torch.equal(streamed, whole)
