"""CAMPPlus (D-TDNN) speaker/style encoder (port of
``seedvc_tpu/models/campplus.py``), channels-first inside.

FCM 2-D residual front-end with frequency-only strides, a TDNN stem (k=5,
stride 2), three CAM-Dense-TDNN blocks (12/24/16 layers, growth 32, dilation
1/2/2) with context-aware masking, transit layers, statistics pooling (mean ‖
unbiased std) and a dense layer to the embedding. The model is frozen, so
BatchNorm runs in eval mode from stored statistics.

``lengths`` threads a time mask through every time-mixing op: convs see zeros
past the true length and all pooling counts valid frames only, so a padded
batch gives the per-sample result.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class EvalBatchNorm(nn.Module):
    """BatchNorm in inference mode over dim 1: (x - mean) / sqrt(var + eps)
    * weight + bias."""

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.weight = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


def _mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask is None else x * mask


class BasicResBlock(nn.Module):
    """2-D residual block; the stride applies to the frequency axis only."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=(stride, 1), padding=1, bias=False)
        self.bn1 = EvalBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = EvalBatchNorm(planes)
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.shortcut_conv = nn.Conv2d(in_planes, planes, 1, stride=(stride, 1), bias=False)
            self.shortcut_bn = EvalBatchNorm(planes)

    def forward(self, x, tmask=None):
        x = _mask(x, tmask)
        h = _mask(F.relu(self.bn1(self.conv1(x))), tmask)
        h = self.bn2(self.conv2(h))
        sc = self.shortcut_bn(self.shortcut_conv(x)) if self.has_shortcut else x
        return F.relu(h + sc)


class FCM(nn.Module):
    """(B, T, F) fbank -> (B, C * F/8, T) channel-stacked features."""

    def __init__(self, m_channels: int = 32, feat_dim: int = 80):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = EvalBatchNorm(m_channels)
        for li in range(2):
            for bi in range(2):
                self.add_module(f"layer{li + 1}_{bi}", BasicResBlock(
                    m_channels, m_channels, stride=2 if bi == 0 else 1))
        self.conv2 = nn.Conv2d(m_channels, m_channels, 3, stride=(2, 1), padding=1, bias=False)
        self.bn2 = EvalBatchNorm(m_channels)

    def forward(self, x, tmask=None):
        tmask4 = None if tmask is None else tmask[:, None, None, :]
        h = _mask(x.transpose(1, 2)[:, None], tmask4)  # (B, 1, F, T)
        h = F.relu(self.bn1(self.conv1(h)))
        for li in range(2):
            for bi in range(2):
                h = getattr(self, f"layer{li + 1}_{bi}")(h, tmask4)
        h = F.relu(self.bn2(self.conv2(_mask(h, tmask4))))
        B, C, Fq, T = h.shape
        return h.reshape(B, C * Fq, T)


class CAMLayer(nn.Module):
    """Context-aware masked conv; context = global mean + 100-frame segment
    means, over valid frames when lengths are given."""

    def __init__(self, bn_channels, out_channels, kernel_size, dilation,
                 reduction: int = 2, seg_len: int = 100):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = nn.Conv1d(bn_channels, out_channels, kernel_size,
                                      dilation=dilation, padding=dilation * (kernel_size - 1) // 2,
                                      bias=False)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x, tmask=None, lengths=None):
        x = _mask(x, tmask)
        y = self.linear_local(x)
        B, C, T = x.shape
        S = self.seg_len
        n_seg = -(-T // S)
        seg_sum = F.pad(x, (0, n_seg * S - T)).reshape(B, C, n_seg, S).sum(-1)
        seg_start = torch.arange(n_seg, device=x.device) * S
        if lengths is None:
            g = x.mean(dim=-1, keepdim=True)
            counts = torch.clamp(seg_start + S, max=T) - seg_start
            seg = seg_sum / counts[None, None, :].to(x.dtype)
        else:
            g = x.sum(dim=-1, keepdim=True) / torch.clamp(
                lengths[:, None, None].to(x.dtype), min=1.0)
            counts = torch.clamp(lengths[:, None] - seg_start[None, :], 0, S)
            seg = seg_sum / torch.clamp(counts, min=1)[:, None, :].to(x.dtype)
        seg = seg.repeat_interleave(S, dim=-1)[..., :T]
        m = F.relu(self.linear1(g + seg))
        return y * torch.sigmoid(self.linear2(m))


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, bn_channels, kernel_size, dilation):
        super().__init__()
        self.nonlinear1_bn = EvalBatchNorm(in_channels)
        self.linear1 = nn.Conv1d(in_channels, bn_channels, 1, bias=False)
        self.nonlinear2_bn = EvalBatchNorm(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel_size, dilation)

    def forward(self, x, tmask=None, lengths=None):
        h = self.linear1(F.relu(self.nonlinear1_bn(x)))
        return self.cam_layer(F.relu(self.nonlinear2_bn(h)), tmask, lengths)


BLOCKS = ((12, 3, 1), (24, 3, 2), (16, 3, 2))  # (layers, kernel, dilation)


class CAMPPlus(nn.Module):
    def __init__(self, feat_dim: int = 80, embedding_size: int = 192,
                 growth_rate: int = 32, bn_size: int = 4, init_channels: int = 128):
        super().__init__()
        self.head = FCM(feat_dim=feat_dim)
        self.tdnn_conv = nn.Conv1d(32 * (feat_dim // 8), init_channels, 5, stride=2,
                                   padding=2, bias=False)
        self.tdnn_bn = EvalBatchNorm(init_channels)
        channels = init_channels
        for bi, (num_layers, ksz, dil) in enumerate(BLOCKS):
            for li in range(num_layers):
                self.add_module(f"block{bi + 1}_tdnnd{li + 1}", CAMDenseTDNNLayer(
                    channels + li * growth_rate, growth_rate, bn_size * growth_rate, ksz, dil))
            channels += num_layers * growth_rate
            self.add_module(f"transit{bi + 1}_bn", EvalBatchNorm(channels))
            self.add_module(f"transit{bi + 1}_linear",
                            nn.Conv1d(channels, channels // 2, 1, bias=False))
            channels //= 2
        self.out_nonlinear_bn = EvalBatchNorm(channels)
        self.dense_linear = nn.Linear(2 * channels, embedding_size, bias=False)
        self.dense_bn = EvalBatchNorm(embedding_size, affine=False)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, feat_dim) mean-subtracted kaldi fbank -> (B, emb)."""
        tmask = None
        if lengths is not None:
            tmask = (torch.arange(x.shape[1], device=x.device)[None, :]
                     < lengths[:, None]).to(x.dtype)  # (B, T)
        h = self.head(x, tmask)
        h = _mask(h, None if tmask is None else tmask[:, None, :])
        h = F.relu(self.tdnn_bn(self.tdnn_conv(h)))

        lengths2 = tmask2 = None
        if lengths is not None:
            lengths2 = (lengths + 1) // 2
            tmask2 = (torch.arange(h.shape[-1], device=x.device)[None, :]
                      < lengths2[:, None]).to(h.dtype)[:, None, :]  # (B, 1, T)
        for bi, (num_layers, _, _) in enumerate(BLOCKS):
            for li in range(num_layers):
                y = getattr(self, f"block{bi + 1}_tdnnd{li + 1}")(h, tmask2, lengths2)
                h = torch.cat([h, y], dim=1)
            h = F.relu(getattr(self, f"transit{bi + 1}_bn")(h))
            h = getattr(self, f"transit{bi + 1}_linear")(h)
        h = F.relu(self.out_nonlinear_bn(h))

        if lengths2 is None:
            mean = h.mean(dim=-1)
            var = ((h - mean[..., None]) ** 2).sum(dim=-1) / max(h.shape[-1] - 1, 1)
        else:
            cnt = torch.clamp(lengths2.to(h.dtype), min=1.0)[:, None]
            mean = (h * tmask2).sum(dim=-1) / cnt
            var = (((h - mean[..., None]) ** 2) * tmask2).sum(dim=-1) / torch.clamp(cnt - 1.0, min=1.0)
        stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
        return self.dense_bn(self.dense_linear(stats))
