"""Plain PyTorch reference of the two UNet families the benchmark runs.

- FoundDiff (hao1635/FoundDiff, ``train.py`` defaults): the frozen CLIPIQA
  tower (CLIP RN50 visual tower, two heads; src/DACLIP.py) and the residual
  UNet of adaLN-Zero MambaBlocks, each an SS2D (src/emamba2.py, v2 scan at
  step 2) and a channel attention (src/DADiff.py:252-488, 530-836).
- The vanilla DDPM UNet the same ``train.py`` builds with
  ``--original_ddim_ddpm`` (lucidrains denoising_diffusion_pytorch ``Unet``).

Activations are NHWC.  Every product goes through :mod:`precision`
(float32 unless a control run asks for less); norms, softmaxes and the
scan's recurrence are float32.  The module tree and the parameter names
follow the published state dicts, so one state dict loads here and into
the system under test.  The scan is the three-pass chunked recurrence in
plain tensor operations.  Imports nothing but torch and this package.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import precision as P

K_DIRS = 4


# --- plain layers -------------------------------------------------------------------


def layer_norm(x, w=None, b=None, eps=1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y if w is None else y * w.float() + b.float()


def group_norm(x, groups, w, b, eps=1e-5):
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return y * w.float() + b.float()


class Conv(nn.Conv2d):
    def forward(self, x):
        return P.conv(x, self.weight, self.bias, self.stride, self.padding, self.groups)


class Dense(nn.Linear):
    def forward(self, x):
        return P.linear(x, self.weight, self.bias)


def conv(c_in, c_out, k, stride=1, padding=None, groups=1, bias=True):
    return Conv(c_in, c_out, k, stride=stride, padding=k // 2 if padding is None else padding,
                groups=groups, bias=bias)


class WSConv(nn.Conv2d):
    """Weight-standardised 3x3 convolution (src/DADiff.py:139-154)."""

    def __init__(self, c_in, c_out, k=3):
        super().__init__(c_in, c_out, k, padding=k // 2)

    def forward(self, x):
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = (w - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        return P.conv(x, (w - mean) * torch.rsqrt(var + 1e-5), self.bias, padding=self.padding)


class Block(nn.Module):
    """WSConv, GroupNorm, optional ``x * (scale + 1) + shift``, SiLU."""

    def __init__(self, c_in, c_out, groups=8):
        super().__init__()
        self.groups = groups
        self.proj = WSConv(c_in, c_out)
        self.norm = nn.GroupNorm(groups, c_out)

    def forward(self, x, scale_shift=None):
        y = group_norm(self.proj(x), self.groups, self.norm.weight, self.norm.bias)
        if scale_shift is not None:
            scale, shift = scale_shift
            y = y * (scale[:, None, None, :] + 1) + shift[:, None, None, :]
        return F.silu(y)


class ResnetBlock(nn.Module):
    """FoundDiff's one-block residual unit (src/DADiff.py:398-427)."""

    def __init__(self, c_in, c_out, groups=8):
        super().__init__()
        self.block1 = Block(c_in, c_out, groups)
        self.res_conv = conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x):
        res = x if self.res_conv is None else self.res_conv(x)
        return self.block1(x) + res


class _Nearest2x(nn.Module):
    def forward(self, x):
        return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                             mode="nearest").permute(0, 2, 3, 1)


def Upsample(c_in, c_out):
    return nn.Sequential(_Nearest2x(), conv(c_in, c_out, 3))


def Downsample(c_in, c_out):
    return conv(c_in, c_out, 4, stride=2, padding=1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                          * -(math.log(10000) / (half - 1)))
        args = t.float()[:, None] * freqs[None]
        return torch.cat([args.sin(), args.cos()], dim=-1)


def time_mlp(dim, time_dim):
    return nn.Sequential(SinusoidalPosEmb(dim), Dense(dim, time_dim), nn.GELU(),
                         Dense(time_dim, time_dim))


# --- FoundDiff: SS2D, the channel attention, the MambaBlock --------------------------


def selective_scan(u, delta, A, Bm, Cm, Dskip, delta_bias):
    """y_t = C_t . h_t + D u_t with h_t = exp(d_t A) h_{t-1} + d_t B_t u_t and
    d = softplus(delta + bias); u, delta [B, K, L, D], A [K, D, N], Bm, Cm
    [B, K, L, N].  Chunks of ~sqrt(L) steps: each chunk scans from zero, the
    entry states are carried across chunks, each chunk scans again from
    its entry state."""
    Bsz, K, L, D = u.shape
    N = A.shape[-1]
    u = u.float()
    d = F.softplus(delta.float() + delta_bias.float()[None, :, None, :])
    T = max(1, math.isqrt(L - 1) + 1 if L > 1 else 1)
    pad = (-L) % T
    chunks = lambda x: F.pad(x, (0, 0, 0, pad)).reshape(Bsz, K, -1, T, x.shape[-1])
    u_c, d_c, B_c, C_c = chunks(u), chunks(d), chunks(Bm.float()), chunks(Cm.float())
    NC = u_c.shape[2]
    Ak = A.float()[None, :, None]  # [1, K, 1, D, N]

    def step(h, t):
        dt = d_c[:, :, :, t]
        return torch.exp(dt[..., None] * Ak) * h + (dt * u_c[:, :, :, t])[..., None] \
            * B_c[:, :, :, t, None, :]

    h = u.new_zeros(Bsz, K, NC, D, N)
    for t in range(T):
        h = step(h, t)
    decay = torch.exp(d_c.sum(dim=3)[..., None] * Ak)
    carry = u.new_zeros(Bsz, K, D, N)
    entries = []
    for c in range(NC):
        entries.append(carry)
        carry = decay[:, :, c] * carry + h[:, :, c]
    h = torch.stack(entries, dim=2)
    ys = []
    for t in range(T):
        h = step(h, t)
        ys.append(torch.einsum("bkcdn,bkcn->bkcd", h, C_c[:, :, :, t]))
    y = torch.stack(ys, dim=3).reshape(Bsz, K, NC * T, D)[:, :, :L]
    return y + u * Dskip.float()[None, :, None, :]


def efficient_scan(x):
    """[B, H, W, C] -> [B, 4, HW/4, C]: (even, even) rows, (odd rows, even
    cols) by column, (even, odd) rows, (odd, odd) by column."""
    B, H, W, C = x.shape
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    d0, d2 = x[:, 0::2, 0::2], x[:, 0::2, 1::2]
    d1, d3 = x[:, 1::2, 0::2].transpose(1, 2), x[:, 1::2, 1::2].transpose(1, 2)
    return torch.stack([d.reshape(B, -1, C) for d in (d0, d1, d2, d3)], dim=1)


def efficient_merge(ys, H, W):
    B, K, L, C = ys.shape
    h, w = -(-H // 2), -(-W // 2)
    out = ys.new_zeros(B, 2 * h, 2 * w, C)
    out[:, 0::2, 0::2] = ys[:, 0].reshape(B, h, w, C)
    out[:, 1::2, 0::2] = ys[:, 1].reshape(B, w, h, C).transpose(1, 2)
    out[:, 0::2, 1::2] = ys[:, 2].reshape(B, h, w, C)
    out[:, 1::2, 1::2] = ys[:, 3].reshape(B, w, h, C).transpose(1, 2)
    return out[:, :H, :W]


class SS2D(nn.Module):
    """2-D selective scan, v2 at step 2 (src/emamba2.py:404-751): in_proj,
    the depthwise 3x3 and SiLU, the four decimated direction sequences,
    delta / B / C projections, the scan, the merge, LayerNorm times
    silu(z), the content term, out_proj."""

    def __init__(self, d_model, d_state, ssm_ratio=2.0, context_dim=256):
        super().__init__()
        D = int(ssm_ratio * d_model)
        R = -(-d_model // 16)
        self.d_inner, self.dt_rank, self.d_state = D, R, d_state
        self.in_proj = Dense(d_model, 2 * D, bias=False)
        self.conv2d = nn.Conv2d(D, D, 3, padding=1, groups=D, bias=True)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * d_state, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, D))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * D, d_state))
        self.Ds = nn.Parameter(torch.empty(K_DIRS * D))
        self.out_norm = nn.LayerNorm(D)
        self.out_proj = Dense(D, d_model, bias=False)
        self.attn = nn.Sequential(Dense(context_dim, D, bias=False), nn.SiLU())
        self.scan = selective_scan

    def core(self, seq):
        D, R, N = self.d_inner, self.dt_rank, self.d_state
        x_dbl = P.einsum("bkld,kcd->bklc", seq, self.x_proj_weight)
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        delta = P.einsum("bklr,kdr->bkld", dts, self.dt_projs_weight)
        A = -torch.exp(self.A_logs.float()).reshape(K_DIRS, D, N)
        return self.scan(seq, delta, A, Bs, Cs, self.Ds.reshape(K_DIRS, D), self.dt_projs_bias)

    def forward(self, x1, c, gate, residual):
        B, H, W, _ = x1.shape
        D = self.d_inner
        xz = self.in_proj(x1)
        xs = F.silu(P.conv(xz[..., :D], self.conv2d.weight, self.conv2d.bias, padding=1,
                           groups=D))
        seq = efficient_scan(xs)
        ys = checkpoint(self.core, seq, use_reentrant=False) if torch.is_grad_enabled() \
            else self.core(seq)
        y = layer_norm(efficient_merge(ys, H, W), self.out_norm.weight, self.out_norm.bias)
        y = y * F.silu(xz[..., D:])
        if c is not None:
            y = y + self.attn(c)[:, 0][:, None, None, :]
        return residual + gate[:, None, None, :] * self.out_proj(y)


class TransposedAttention(nn.Module):
    """Channel attention (src/DADiff.py:252-285): 1x1 qkv, depthwise 3x3,
    per head softmax(temperature * q^ k^T) over channels, with q and k
    L2-normalised over the pixels, times v, then the 1x1 out."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = nn.Conv2d(dim, 3 * dim, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(3 * dim, 3 * dim, 3, padding=1, groups=3 * dim, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        qkv = P.conv(P.conv(x, self.qkv.weight), self.qkv_dwconv.weight, padding=1,
                     groups=3 * C)
        heads = lambda u: u.reshape(B, H * W, self.heads, C // self.heads).permute(0, 2, 3, 1)
        q, k, v = (heads(u) for u in qkv.chunk(3, dim=-1))  # [B, heads, c, L]
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        attn = torch.softmax(P.matmul(q, k.transpose(-1, -2)) * self.temperature.float(),
                             dim=-1)
        out = P.matmul(attn, v).permute(0, 3, 1, 2).reshape(B, H, W, C)
        return P.conv(out, self.project_out.weight)


class MambaBlock(nn.Module):
    """adaLN-Zero block (src/DADiff.py:453-488): shift/scale/gate of both
    halves from silu(t); x + gate1 * SS2D(modulate(LN1(x))), then
    + gate2 * attention(modulate(LN(x)))."""

    def __init__(self, h, d_state, time_dim, expand=2.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(h)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(time_dim, 6 * h))
        self.mamba = SS2D(h, d_state, ssm_ratio=expand)
        self.attn_blk = TransposedAttention(h, heads=max(1, h // 32))

    def forward(self, x, c, t):
        lin = self.adaLN_modulation[1]
        mod = P.linear(F.silu(t), lin.weight, lin.bias)
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        mod1 = lambda y, sc, sh: y * (1 + sc[:, None, None, :]) + sh[:, None, None, :]
        x1 = mod1(layer_norm(x, self.norm1.weight, self.norm1.bias, 1e-5), sc1, sh1)
        x = self.mamba(x1, c, g1, x)
        x2 = mod1(layer_norm(x, eps=1e-6), sc2, sh2)
        return x + g2[:, None, None, :] * self.attn_blk(x2)


class Unet(nn.Module):
    """FoundDiff's UNet (src/DADiff.py:530-740): per level a MambaBlock, a
    ResnetBlock and a downsampling conv; a mid ResnetBlock and MambaBlock;
    the decoder on the skips; the dose embedding through the prompt into
    the time embedding, the content embedding into every SS2D."""

    def __init__(self, dim, dim_mults, channels=1, groups=8, base_d_state=4, expand=2.0,
                 context_dim=1024, dose_encoder=None):
        super().__init__()
        time_dim = dim * 4
        self.init_conv = conv(2 * channels, dim, 7)
        self.time_mlp = time_mlp(dim, time_dim)
        self.prompt = nn.Parameter(torch.empty(1, time_dim))
        self.text_mlp = nn.Sequential(Dense(context_dim, time_dim), nn.SiLU(),
                                      Dense(time_dim, time_dim))
        self.prompt_mlp = Dense(time_dim, time_dim)
        if dose_encoder is not None:
            self.dose_encoder = dose_encoder
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)
        state = lambda level: base_d_state * 2 ** level
        self.downs = nn.ModuleList()
        for i, (a, b) in enumerate(in_out):
            self.downs.append(nn.ModuleList([
                ResnetBlock(a, a, groups), MambaBlock(a, state(i), time_dim, expand),
                Downsample(a, b) if i < n - 1 else conv(a, b, 3)]))
        self.mid_block = ResnetBlock(dims[-1], dims[-1], groups)
        self.mid_attn = MambaBlock(dims[-1], state(n - 1), time_dim, expand)
        self.ups = nn.ModuleList()
        for i, (a, b) in enumerate(reversed(in_out)):
            self.ups.append(nn.ModuleList([
                ResnetBlock(a + b, b, groups), MambaBlock(b, state(n - 1 - i), time_dim, expand),
                Upsample(b, a) if i < n - 1 else conv(b, a, 3)]))
        self.final_res_block = ResnetBlock(2 * dim, dim, groups)
        self.final_conv = conv(dim, channels, 1)

    def forward(self, x, time, dose, content):
        x = self.init_conv(x)
        r = x
        t = self.time_mlp(time)
        pe = self.text_mlp(dose)
        t = t + self.prompt_mlp(torch.softmax(pe, dim=1) * self.prompt.float())
        skips = []
        for res, mamba, down in self.downs:
            x = res(mamba(x, content, t))
            skips.append(x)
            x = down(x)
        x = self.mid_attn(self.mid_block(x), content, t)
        for res, mamba, up in self.ups:
            x = up(mamba(res(torch.cat([x, skips.pop()], dim=-1)), content, t))
        return self.final_conv(self.final_res_block(torch.cat([x, r], dim=-1)))


# --- the CLIPIQA tower (src/DACLIP.py) -------------------------------------------------


class FrozenBatchNorm(nn.Module):
    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps) \
            * self.weight + self.bias


def _avg_pool(x, k):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.stride = stride
        out = planes * 4
        self.conv1, self.bn1 = conv(inplanes, planes, 1, bias=False), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3, bias=False), FrozenBatchNorm(planes)
        self.conv3, self.bn3 = conv(planes, out, 1, bias=False), FrozenBatchNorm(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict(
                [("0", conv(inplanes, out, 1, bias=False)), ("1", FrozenBatchNorm(out))]))

    def forward(self, x):
        out = F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            identity = self.downsample(_avg_pool(x, self.stride) if self.stride > 1 else x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The mean token attends to every token; no positional embedding on
    this path (src/DACLIP.py:214-259)."""

    def __init__(self, spacial_dim, embed_dim, num_heads, output_dim):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj, self.k_proj = Dense(embed_dim, embed_dim), Dense(embed_dim, embed_dim)
        self.v_proj, self.c_proj = Dense(embed_dim, embed_dim), Dense(embed_dim, output_dim)

    def forward(self, x):
        B, H, W, C = x.shape
        tok = x.reshape(B, H * W, C)
        tok = torch.cat([tok.mean(dim=1, keepdim=True), tok], dim=1)
        hd = C // self.num_heads
        heads = lambda u: u.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        q, k, v = heads(self.q_proj(tok[:, :1])), heads(self.k_proj(tok)), heads(self.v_proj(tok))
        attn = torch.softmax(P.matmul(q * hd ** -0.5, k.transpose(-1, -2)), dim=-1)
        return self.c_proj(P.matmul(attn, v).transpose(1, 2).reshape(B, C))


class ModifiedResNet(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), output_dim=1024, heads=32, resolution=224, width=64):
        super().__init__()
        w = width
        self.conv1, self.bn1 = conv(3, w // 2, 3, stride=2, padding=1, bias=False), \
            FrozenBatchNorm(w // 2)
        self.conv2, self.bn2 = conv(w // 2, w // 2, 3, bias=False), FrozenBatchNorm(w // 2)
        self.conv3, self.bn3 = conv(w // 2, w, 3, bias=False), FrozenBatchNorm(w)
        inplanes = w
        for li, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers), start=1):
            seq = [Bottleneck(inplanes, w * mult, 1 if li == 1 else 2)]
            inplanes = w * mult * 4
            seq += [Bottleneck(inplanes, w * mult) for _ in range(1, blocks)]
            setattr(self, f"layer{li}", nn.Sequential(*seq))
        self.attnpool = AttentionPool2d(resolution // 32, w * 32, heads, output_dim)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = _avg_pool(F.relu(self.bn3(self.conv3(x))), 2)
        return self.attnpool(self.layer4(self.layer3(self.layer2(self.layer1(x)))))


class _MHAWeights(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Dense(d, d)


class _TextBlock(nn.Module):
    """The text transformer's weights: the serving and training paths read
    none of them (the tower's ``embed`` uses the visual tower alone)."""

    def __init__(self, d):
        super().__init__()
        self.ln_1, self.attn, self.ln_2 = nn.LayerNorm(d), _MHAWeights(d), nn.LayerNorm(d)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", Dense(d, 4 * d)), ("gelu", nn.Identity()),
                                              ("c_proj", Dense(4 * d, d))]))


class _Text(nn.Module):
    def __init__(self, width, layers):
        super().__init__()
        self.resblocks = nn.Sequential(*[_TextBlock(width) for _ in range(layers)])


class CLIP(nn.Module):
    def __init__(self, embed_dim, resolution, layers, width, text_width, text_layers,
                 context_length=77):
        super().__init__()
        self.visual = ModifiedResNet(tuple(layers), embed_dim, width * 32 // 64, resolution,
                                     width)
        self.transformer = _Text(text_width, text_layers)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, text_width))
        self.ln_final = nn.LayerNorm(text_width)
        self.text_projection = nn.Parameter(torch.empty(text_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))


class PromptLearner(nn.Module):
    def __init__(self, n_cls=2, n_ctx=16, width=512, context_length=77):
        super().__init__()
        self.ctx = nn.Parameter(torch.empty(n_cls, n_ctx, width))
        self.register_buffer("token_prefix", torch.zeros(n_cls, 1, width))
        self.register_buffer("token_suffix", torch.zeros(n_cls, context_length - 1 - n_ctx,
                                                         width))


class CLIPIQA(nn.Module):
    """Dose-CLIP tower (src/DACLIP.py:1135-1221): the dose embedding is
    normalize(head1(f)), the content embedding normalize(head2(f)), with f
    the visual tower's output."""

    def __init__(self, resolution=224, embed_dim=1024, layers=(3, 4, 6, 3), width=64,
                 text_width=512, text_layers=12):
        super().__init__()
        self.clip_model = CLIP(embed_dim, resolution, layers, width, text_width, text_layers)
        self.prompt_learner = PromptLearner(width=text_width)
        self.head1 = nn.Sequential(Dense(embed_dim, 1024), nn.ReLU(), Dense(1024, embed_dim))
        self.head2 = nn.Sequential(Dense(embed_dim, 1024), nn.ReLU(), Dense(1024, 256))

    def forward(self, rgb):
        f = self.clip_model.visual(rgb)
        return F.normalize(self.head1(f), dim=-1), F.normalize(self.head2(f), dim=-1)


class FoundDiff(nn.Module):
    """``unet0`` holds the tower at ``unet0.dose_encoder``, as the published
    state dict does."""

    def __init__(self, dim=64, dim_mults=(1, 2, 4, 8), channels=1, groups=8,
                 base_d_state=4, expand=2.0, tower=None):
        super().__init__()
        tower = tower if tower is not None else {}
        enc = CLIPIQA(**tower)
        self.unet0 = Unet(dim, dim_mults, channels, groups, base_d_state, expand,
                          context_dim=enc.clip_model.text_projection.shape[1], dose_encoder=enc)

    def encode(self, x_norm):
        """(dose [B, E], content [B, 1, 256]) of the conditioning slice in [-1, 1]."""
        dose, content = self.unet0.dose_encoder(x_norm.float().repeat_interleave(3, dim=-1))
        return dose, content[:, None, :]

    def forward(self, x, time, dose, content):
        return self.unet0(x, time, dose, content)


# --- the vanilla DDPM UNet (lucidrains ``Unet``) ------------------------------------------


class ChanLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        return layer_norm(x) * self.g.reshape(-1).float()


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.fn, self.norm = fn, ChanLayerNorm(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


def _heads(u, heads):
    B, H, W, _ = u.shape
    return u.reshape(B, H * W, heads, -1).transpose(1, 2)  # [B, heads, L, d]


class LinearAttention(nn.Module):
    def __init__(self, dim, heads=4, dim_head=32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = conv(dim, 3 * heads * dim_head, 1, bias=False)
        self.to_out = nn.Sequential(conv(heads * dim_head, dim, 1), ChanLayerNorm(dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        q, k, v = (_heads(u, self.heads) for u in self.to_qkv(x).chunk(3, dim=-1))
        q = torch.softmax(q, dim=-1) * self.dim_head ** -0.5  # over the head's channels
        k = torch.softmax(k, dim=-2)                           # over the pixels
        context = P.matmul(k.transpose(-1, -2), v / (H * W))   # [B, heads, d, e]
        out = P.matmul(q, context)                             # [B, heads, L, e]
        return self.to_out(out.transpose(1, 2).reshape(B, H, W, -1))


class Attention(nn.Module):
    def __init__(self, dim, heads=4, dim_head=32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = conv(dim, 3 * heads * dim_head, 1, bias=False)
        self.to_out = conv(heads * dim_head, dim, 1)

    def forward(self, x):
        B, H, W, _ = x.shape
        q, k, v = (_heads(u, self.heads) for u in self.to_qkv(x).chunk(3, dim=-1))
        sim = P.matmul(q * self.dim_head ** -0.5, k.transpose(-1, -2))
        out = P.matmul(torch.softmax(sim, dim=-1), v)
        return self.to_out(out.transpose(1, 2).reshape(B, H, W, -1))


class TimeResnetBlock(nn.Module):
    def __init__(self, c_in, c_out, time_dim, groups=8):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), Dense(time_dim, 2 * c_out))
        self.block1, self.block2 = Block(c_in, c_out, groups), Block(c_out, c_out, groups)
        self.res_conv = conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, t):
        h = self.block2(self.block1(x, self.mlp(t).chunk(2, dim=-1)))
        return h + (x if self.res_conv is None else self.res_conv(x))


class VanillaUnet(nn.Module):
    def __init__(self, dim=64, dim_mults=(1, 2, 4, 8), channels=1, groups=8):
        super().__init__()
        time_dim = dim * 4
        self.init_conv = conv(channels, dim, 7)
        self.time_mlp = time_mlp(dim, time_dim)
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)
        block = lambda a, b: TimeResnetBlock(a, b, time_dim, groups)
        self.downs = nn.ModuleList()
        for i, (a, b) in enumerate(in_out):
            self.downs.append(nn.ModuleList([
                block(a, a), block(a, a), Residual(PreNorm(a, LinearAttention(a))),
                Downsample(a, b) if i < n - 1 else conv(a, b, 3)]))
        mid = dims[-1]
        self.mid_block1 = block(mid, mid)
        self.mid_attn = Residual(PreNorm(mid, Attention(mid)))
        self.mid_block2 = block(mid, mid)
        self.ups = nn.ModuleList()
        for i, (a, b) in enumerate(reversed(in_out)):
            self.ups.append(nn.ModuleList([
                block(a + b, b), block(a + b, b), Residual(PreNorm(b, LinearAttention(b))),
                Upsample(b, a) if i < n - 1 else conv(b, a, 3)]))
        self.final_res_block = block(2 * dim, dim)
        self.final_conv = conv(dim, channels, 1)

    def forward(self, x, time):
        x = self.init_conv(x)
        r = x
        t = self.time_mlp(time)
        skips = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            skips.append(x)
            x = attn(block2(x, t))
            skips.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t)), t)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, skips.pop()], dim=-1), t)
            x = block2(torch.cat([x, skips.pop()], dim=-1), t)
            x = up(attn(x))
        return self.final_conv(self.final_res_block(torch.cat([x, r], dim=-1), t))
