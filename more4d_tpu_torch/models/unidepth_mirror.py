"""An independent transcription of the UniDepth-V2 decoder, the oracle of
``scripts.check_unidepth --run_compare`` (the port's copy of
``more4d_tpu/models/unidepth_mirror.py``; the port imports nothing of the
JAX package).

It is not an inference path: it is the decoder the checkpoint's key table
describes (the camera head and depth head of the reference's
UniDepthV2old, scripts/inference/infer.py:47,515-520), written as plainly
as torch allows, so that a released checkpoint loads into it directly and
the port's ``UniDepthV2`` can be compared with it on the same weights.
"""


def torch_decoder_mirror(dim=32, backbone_dim=48, n_adapt=4, cam_blocks=2,
                         depth_blocks=4, heads=8):
    """Build the torch decoder mirror.  forward(levels, height, width,
    gh, gw) -> (depth [B, 4*gh, 4*gw], K [B, 3, 3]); ``levels`` is the
    list of per-tap patch-token tensors [B, gh*gw, backbone_dim]."""
    import torch

    class TCrossBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.norm_ctx = torch.nn.LayerNorm(dim, eps=1e-6)
            self.q = torch.nn.Linear(dim, dim)
            self.k = torch.nn.Linear(dim, dim)
            self.v = torch.nn.Linear(dim, dim)
            self.proj = torch.nn.Linear(dim, dim)
            self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.fc1 = torch.nn.Linear(dim, 4 * dim)
            self.fc2 = torch.nn.Linear(4 * dim, dim)

        def forward(self, x, ctx):
            b, l, c = x.shape
            n, d = heads, dim // heads
            h, hc = self.norm1(x), self.norm_ctx(ctx)
            q = self.q(h).view(b, l, n, d)
            k = self.k(hc).view(b, -1, n, d)
            v = self.v(hc).view(b, -1, n, d)
            s = torch.einsum("blnd,bmnd->bnlm", q, k) * d ** -0.5
            p = torch.softmax(s, -1)
            o = torch.einsum("bnlm,bmnd->blnd", p, v).reshape(b, l, c)
            x = x + self.proj(o)
            return x + self.fc2(torch.nn.functional.gelu(
                self.fc1(self.norm2(x))))

    class TDecoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.input_adapters = torch.nn.ModuleList(
                [torch.nn.Linear(backbone_dim, dim)
                 for _ in range(n_adapt)])

            cam = torch.nn.Module()
            cam.camera_tokens = torch.nn.Parameter(
                torch.randn(1, 4, dim) * 0.02)
            cam.blocks = torch.nn.ModuleList(
                [TCrossBlock() for _ in range(cam_blocks)])
            cam.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            cam.proj = torch.nn.Linear(dim, 1)
            self.camera_head = cam

            dep = torch.nn.Module()
            dep.ray_proj = torch.nn.Linear(16, dim)
            dep.blocks = torch.nn.ModuleList(
                [TCrossBlock() for _ in range(depth_blocks)])
            dep.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            dep.up1 = torch.nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)
            dep.up2 = torch.nn.ConvTranspose2d(dim // 2, dim // 4, 2,
                                               stride=2)
            dep.out = torch.nn.Conv2d(dim // 4, 1, 3, padding=1)
            self.depth_head = dep

        def _sh3(self, dirs):
            x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
            c = [torch.full_like(x, 0.28209479177387814),
                 -0.4886025119029199 * y, 0.4886025119029199 * z,
                 -0.4886025119029199 * x,
                 1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
                 0.31539156525252005 * (3 * z * z - 1.0),
                 -1.0925484305920792 * x * z,
                 0.5462742152960396 * (x * x - y * y),
                 -0.5900435899266435 * y * (3 * x * x - y * y),
                 2.890611442640554 * x * y * z,
                 -0.4570457994644658 * y * (5 * z * z - 1.0),
                 0.3731763325901154 * z * (5 * z * z - 3.0),
                 -0.4570457994644658 * x * (5 * z * z - 1.0),
                 1.445305721320277 * z * (x * x - y * y),
                 -0.5900435899266435 * x * (x * x - 3 * y * y)]
            return torch.stack(c, -1)

        def forward(self, levels, height, width, gh, gw):
            feats = 0.0
            for ad, lvl in zip(self.input_adapters, levels):
                feats = feats + ad(lvl)
            b = feats.shape[0]
            x = self.camera_head.camera_tokens.expand(b, -1, -1)
            for blk in self.camera_head.blocks:
                x = blk(x, feats)
            raw = self.camera_head.proj(self.camera_head.norm(x))[..., 0]
            fx = torch.nn.functional.softplus(raw[:, 0] + 1.0) * 0.5 * width
            fy = torch.nn.functional.softplus(raw[:, 1] + 1.0) * 0.5 * width
            cx = torch.sigmoid(raw[:, 2]) * width
            cy = torch.sigmoid(raw[:, 3]) * height
            z0, o0 = torch.zeros_like(fx), torch.ones_like(fx)
            K = torch.stack([torch.stack([fx, z0, cx], -1),
                             torch.stack([z0, fy, cy], -1),
                             torch.stack([z0, z0, o0], -1)], 1)
            ys = (torch.arange(gh, dtype=torch.float32) + 0.5) * (height / gh)
            xs = (torch.arange(gw, dtype=torch.float32) + 0.5) * (width / gw)
            gx, gy = torch.meshgrid(xs, ys, indexing="xy")
            rx = (gx[None] - cx[:, None, None]) / fx[:, None, None]
            ry = (gy[None] - cy[:, None, None]) / fy[:, None, None]
            rays = torch.stack([rx, ry, torch.ones_like(rx)], -1)
            rays = rays / rays.norm(dim=-1, keepdim=True)
            rays = rays.reshape(b, gh * gw, 3)

            prompt = self.depth_head.ray_proj(self._sh3(rays))
            h = feats + prompt
            for blk in self.depth_head.blocks:
                h = blk(h, h)
            h = self.depth_head.norm(h)
            h = h.reshape(b, gh, gw, dim).permute(0, 3, 1, 2)
            h = torch.nn.functional.gelu(self.depth_head.up1(h))
            h = torch.nn.functional.gelu(self.depth_head.up2(h))
            log_depth = self.depth_head.out(h)[:, 0]
            return torch.exp(log_depth), K

    return TDecoder()
