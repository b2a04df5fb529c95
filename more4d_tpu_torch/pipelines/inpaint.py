"""Stage-2 inpainting pipeline, 4D-ViSM disocclusion fill (PyTorch port of
``more4d_tpu/pipelines/inpaint.py``).

The rendered novel-view video is VAE-encoded after its holes are zeroed, and
the DiT input is y = [mask latents (4ch) | masked-video latents (16ch)] plus
16 noise channels, the 36-channel InP model. The mask (1 = hole) has its
first frame repeated 4x and groups of 4 frames folded into channels, then
(1 - mask) is resized to the latent grid with the JAX package's antialiased
trilinear resize, the first frame on its own. TeaCache and cfg-skip: see
``base.py``.
"""

from __future__ import annotations

import torch

from ..nn.resize import resize
from .base import BasePipeline


def fold_mask_to_latent_channels(mask):
    """[B,T,H,W,1] (1 = hole) -> [B,T',H,W,4]: first frame repeated 4x,
    then groups of 4 frames become channels."""
    b, t, h, w, _ = mask.shape
    m = torch.cat([mask[:, :1].expand(b, 4, h, w, 1), mask[:, 1:]], dim=1)
    tl = m.shape[1] // 4
    return m.reshape(b, tl, 4, h, w).movedim(2, -1)


def resize_mask_to_latent(mask4, latent_shape):
    """Trilinear resize (``jax.image.resize`` semantics) of the folded mask
    to the latent grid, first frame separately. mask4: [B,T',H,W,4]."""
    b, tl, h, w, c = mask4.shape
    _, tl_lat, hl, wl, _ = latent_shape
    first = resize(mask4[:, :1], (b, 1, hl, wl, c))
    if tl_lat > 1:
        rest = resize(mask4[:, 1:], (b, tl_lat - 1, hl, wl, c))
        return torch.cat([first, rest], dim=1)
    return first


class WanInpaintPipeline(BasePipeline):

    @torch.no_grad()
    def prepare_conditions(self, latents_shape, video=None, mask=None,
                           all_mask: bool = False):
        """video: [B,T,H,W,3] in [-1,1]; mask: [B,T,H,W,1] in [0,1] (1 =
        hole to inpaint). Returns y [B,T',h,w,20]. ``all_mask`` encodes the
        raw video instead of zeroing the holes."""
        b, tl, h, w, _ = latents_shape
        z = self.vae.cfg.z_dim
        dev = self.device
        if video is None:
            return torch.zeros((b, tl, h, w, 4 + z), device=dev)
        video = video.to(dev, torch.float32)
        if mask is None:
            mask = torch.zeros(video.shape[:-1] + (1,), device=dev)
        mask = mask.to(dev, torch.float32)
        masked_video = video if all_mask else video * (mask < 0.5)
        masked_lat = self.encode_video(masked_video)
        mask4 = fold_mask_to_latent_channels(1.0 - mask)
        mask_lat = resize_mask_to_latent(mask4, masked_lat.shape)
        return torch.cat([mask_lat, masked_lat], dim=-1)

    def __call__(self, generator, prompt_embeds, neg_embeds=None, video=None,
                 mask=None, clip_fea=None, all_mask=False, num_frames=None,
                 height=None, width=None, output_type="numpy",
                 guidance_scale=None):
        b = prompt_embeds.shape[0]
        latents = self.prepare_latents(generator, b, num_frames, height,
                                       width)
        y = self.prepare_conditions(latents.shape, video, mask, all_mask)
        latents = self.denoise(latents, prompt_embeds, neg_embeds, y=y,
                               clip_fea=clip_fea,
                               guidance_scale=guidance_scale)
        if output_type == "latent":
            return latents
        return self.decode_latents(latents)
