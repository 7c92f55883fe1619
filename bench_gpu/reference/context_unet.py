"""Plain float32 ContextUnet v2 (the crack-damage denoiser of
Shen-Yuuu/DiffusionModel ``new_scripy.py``: ResConvBlock + SE, UnetDown +
CoordAttn, FiLM embeddings, UnetUp, LocalEnhancer).

Written from the published description in plain ``torch`` layers: no
kernels, no bfloat16 rounding rules, no fused upsample head, no sharding.
Parameter names are the published ``state_dict`` names, so the benchmark's
seeded weights (``bench_gpu/weights.py``) fill this module and the
program's alike.

``quant`` (None: float32) rounds the input and the weight of every
convolution and dense layer before the product, which computes in float32:
the control that stands for a program computing those products in a lower
precision (``bench_gpu/reference/lowp.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def groups_for(channels: int, preferred: int = 8) -> int:
    g = max(1, min(preferred, channels))
    while channels % g:
        g -= 1
    return g


class QConv(nn.Conv2d):
    quant: Quant = None

    def forward(self, x):
        q = self.quant
        if q is None:
            return super().forward(x)
        return self._conv_forward(q(x), q(self.weight), self.bias)


class QConvT(nn.ConvTranspose2d):
    quant: Quant = None

    def forward(self, x):
        q = self.quant
        if q is None:
            return super().forward(x)
        return F.conv_transpose2d(q(x), q(self.weight), self.bias,
                                  self.stride, self.padding)


class QLinear(nn.Linear):
    quant: Quant = None

    def forward(self, x):
        q = self.quant
        if q is None:
            return super().forward(x)
        return F.linear(q(x), q(self.weight), self.bias)


def conv(cin: int, cout: int, k: int, stride: int = 1,
         bias: bool = True) -> QConv:
    pad = (k - 1) // 2 if k % 2 else max(k // 2 - 1, 0)
    return QConv(cin, cout, k, stride=stride, padding=pad, bias=bias)


def gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups_for(c), c, eps=1e-5)


class SEBlock(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        r = max(1, c // reduction)
        self.fc = nn.Sequential(QLinear(c, r, bias=False), nn.GELU(),
                                QLinear(r, c, bias=False), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class ResConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, is_res: bool = False,
                 use_se: bool = True):
        super().__init__()
        self.is_res = is_res
        self.same = cin == cout
        self.conv1 = nn.Sequential(conv(cin, cout, 3), gn(cout), nn.GELU())
        self.conv2 = nn.Sequential(conv(cout, cout, 3), gn(cout), nn.GELU())
        self.se = SEBlock(cout) if is_res and use_se else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        if not self.is_res:
            return x2
        if self.se is not None:
            x2 = self.se(x2)
        return ((x + x2) if self.same else (x1 + x2)) / 1.414


class UnetDown(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        cc = cin // 4
        self.channel_compress = nn.Sequential(conv(cin, cc, 1), gn(cc),
                                              nn.GELU())
        self.ch_adjust = conv(cc, cout, 1)
        self.down = nn.Sequential(conv(cout, cout, 3), gn(cout), nn.GELU(),
                                  ResConvBlock(cout, cout, is_res=True),
                                  conv(cout, cout, 4, stride=2))

    def forward(self, x):
        return self.down(self.ch_adjust(self.channel_compress(x)))


class CoordAttn(nn.Module):
    """Directional means -> 1x1 conv + GN + GELU -> cross-direction mix ->
    sigmoid maps weighted by sigmoid(alpha), sigmoid(beta). On the square
    maps of this net the realigning adaptive pool is the identity."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        r = max(1, c // reduction)
        self.conv1_h, self.conv1_w = conv(c, r, 1), conv(c, r, 1)
        self.bn1_h, self.bn1_w = gn(r), gn(r)
        self.h2w_proj, self.w2h_proj = conv(r, r, 1), conv(r, r, 1)
        self.conv_h, self.conv_w = conv(r, c, 1), conv(r, c, 1)
        for n in ("gamma_h", "gamma_w", "alpha", "beta"):
            setattr(self, n, nn.Parameter(torch.zeros(1)))

    def forward(self, x):
        if x.shape[2] != x.shape[3]:
            raise ValueError("the reference CoordAttn takes square maps")
        x_h = F.gelu(self.bn1_h(self.conv1_h(x.mean(dim=3, keepdim=True))))
        x_w = F.gelu(self.bn1_w(self.conv1_w(x.mean(dim=2, keepdim=True))))
        h2w = self.h2w_proj(x_h).transpose(2, 3)  # [B, R, 1, H]
        w2h = self.w2h_proj(x_w).transpose(2, 3)  # [B, R, W, 1]
        x_h = x_h + torch.sigmoid(self.gamma_h) * w2h
        x_w = x_w + torch.sigmoid(self.gamma_w) * h2w
        a_h = torch.sigmoid(self.conv_h(x_h))
        a_w = torch.sigmoid(self.conv_w(x_w))
        al, be = torch.sigmoid(self.alpha), torch.sigmoid(self.beta)
        s = al + be + 1e-8
        return x * ((al / s) * a_h + (be / s) * a_w)


class EmbedFC(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.din = din
        self.model = nn.Sequential(QLinear(din, dout), nn.GELU(),
                                   QLinear(dout, dout))

    def forward(self, x):
        return self.model(x.reshape(-1, self.din))


class UnetUp(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.model = nn.Sequential(
            nn.Sequential(nn.Upsample(scale_factor=2, mode="bilinear",
                                      align_corners=True),
                          conv(cin, cout, 3)),
            ResConvBlock(cout, cout), ResConvBlock(cout, cout))

    def forward(self, x, skip):
        return self.model(torch.cat([x, skip], dim=1))


class LocalEnhancer(nn.Module):
    def __init__(self, c: int, high_thresh: float):
        super().__init__()
        self.high_thresh = high_thresh
        self.conv = nn.Sequential(conv(c, c, 3), gn(c), nn.GELU(),
                                  conv(c, c, 3))

    def forward(self, x, mask):
        if mask is None:  # sampling: no spatial mask, the identity
            return x
        gate = (mask > self.high_thresh).to(x.dtype)[:, None]
        return x + self.conv(x) * gate


class ContextUnet(nn.Module):
    """x [B,H,W,C], c [B] labels, t [B] = t/T, ctx_mask [B] (1 = keep the
    class), attn_mask [B,H,W] or None -> eps [B,H,W,C], float32."""

    def __init__(self, in_ch: int = 3, n_feat: int = 192,
                 n_classes: int = 5, img_size: int = 256,
                 high_thresh: float = 1.2):
        super().__init__()
        nf = n_feat
        self.n_classes = n_classes
        self.pool = min(8, img_size // 16)
        self.init_conv = ResConvBlock(in_ch, nf, is_res=True)
        chans = [nf, 2 * nf, 4 * nf, 8 * nf]
        for i, (ci, co) in enumerate(zip([nf, nf, 2 * nf, 4 * nf], chans)):
            setattr(self, f"down{i + 1}", UnetDown(ci, co))
            setattr(self, f"ca{i + 1}", CoordAttn(co))
        self.time_emb1, self.time_emb2 = EmbedFC(1, 8 * nf), EmbedFC(1, 4 * nf)
        self.ctx_emb1 = EmbedFC(n_classes, 8 * nf)
        self.ctx_emb2 = EmbedFC(n_classes, 4 * nf)
        self.up0 = nn.Sequential(
            QConvT(8 * nf, 8 * nf, self.pool, stride=self.pool),
            gn(8 * nf), nn.ReLU())
        self.up1 = UnetUp(16 * nf, 4 * nf)
        self.up2 = UnetUp(8 * nf, 2 * nf)
        self.up3 = UnetUp(4 * nf, nf)
        self.up4 = UnetUp(2 * nf, nf)
        self.local_enhance = LocalEnhancer(nf, high_thresh)
        self.out = nn.Sequential(conv(2 * nf, nf, 3), gn(nf), nn.ReLU(),
                                 conv(nf, in_ch, 3))

    def forward(self, x, c, t, ctx_mask, attn_mask=None):
        x = x.permute(0, 3, 1, 2).float()
        x0 = self.init_conv(x)
        h, downs = x0, []
        for i in range(1, 5):
            h = getattr(self, f"ca{i}")(getattr(self, f"down{i}")(h))
            downs.append(h)
        d1, d2, d3, d4 = downs
        hidden = F.gelu(F.avg_pool2d(d4, self.pool))
        cls = torch.arange(self.n_classes, device=x.device)
        cvec = (c.to(x.device)[:, None] == cls[None]).float() \
            * ctx_mask.to(x.device).float()[:, None]
        t = torch.as_tensor(t, device=x.device).float().reshape(-1, 1)
        cemb1 = self.ctx_emb1(cvec)[:, :, None, None]
        temb1 = self.time_emb1(t)[:, :, None, None]
        cemb2 = self.ctx_emb2(cvec)[:, :, None, None]
        temb2 = self.time_emb2(t)[:, :, None, None]
        u1 = self.up0(hidden)
        u2 = self.up1(cemb1 * u1 + temb1, d4)
        u3 = self.up2(cemb2 * u2 + temb2, d3)
        u4 = self.up3(u3, d2)
        u5 = self.local_enhance(self.up4(u4, d1), attn_mask)
        out = self.out(torch.cat([u5, x0], dim=1))
        return out.permute(0, 2, 3, 1)


def set_quant(model: nn.Module, quant: Quant) -> None:
    """Every convolution and dense layer of ``model`` rounds its input and
    weight with ``quant`` (None: plain float32)."""
    for m in model.modules():
        if isinstance(m, (QConv, QConvT, QLinear)):
            m.quant = quant


def build(cfg: dict, device) -> ContextUnet:
    """The reference net of a configuration file's ``model`` group, with
    PyTorch's default initialisation (the benchmark overwrites it)."""
    m = cfg["model"]
    with torch.device(device):
        net = ContextUnet(in_ch=m["in_ch"], n_feat=m["n_feat"],
                          n_classes=m["n_classes"], img_size=m["img_size"],
                          high_thresh=cfg["diffusion"]["high_thresh"])
    return net
