"""The fbank (pre-wav2vec) CAAT model family (torch port of
``wav2vec_s_tpu/models/fbank.py``).

Twins of the reference's filterbank stack (rain/layers/audio_convs.py:50-385
conv front-ends, rain/layers/unidirect_encoder.py blockwise audio encoder,
rain/models/transducer.py:106 / caat_transformer.py:104 models, and the
simpler jointers rain/layers/attention_transducer.py:458-586):

- ``Shallow2dConv`` / ``Vgg2dConv`` / ``ResNetConv`` (``resnet_small``):
  2-D conv front-ends over [B, T, 80] log-mel features with 4x time
  downsampling, on NCHW ``F.conv2d``;
- ``FbankBlockwiseEncoder``: sinusoidal positions and the blockwise
  bounded-context encoder layers (mc / rc counted in post-conv frames),
  always under the dense block bias, as in the JAX package (a config
  with ``attention_impl="flash"`` builds the same dense stack);
- ``ConcatJointNet`` / ``AttentionJointNet``: the single-layer jointer
  variants; ``mha`` is the CAAT ``MHAJointNet``;
- ``FbankCaatModel``: encoder + IsolatedDecoder LM + the chosen jointer,
  trained with the same ``caat_loss``.

Three traps of the flax original that the port reproduces on purpose:
flax ``padding="SAME"`` pads a stride-2 axis by its length's parity (0
before and 1 after on an even length, 1 and 1 on an odd one), so each conv
pads explicitly (``conv2d_same``); flax ``GroupNorm`` has epsilon 1e-6;
the front-ends flatten NHWC ``[B, T4, F4, C]`` as ``f * C + c``.
Parameter names are the JAX package's inside the front-end and jointer
variants, and the CAAT model's (``decoder.lm.*``, ``decoder.jointer.*``)
for the shared parts (``checkpoint/convert.fbank_state_dict_from_jax``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wav2vec_s_tpu_torch.models.caat.config import CaatConfig
from wav2vec_s_tpu_torch.models.caat.decoder import IsolatedDecoder
from wav2vec_s_tpu_torch.models.caat.jointer import (
    MHAJointNet, group_attn_bias)
from wav2vec_s_tpu_torch.models.caat.transducer_model import CaatModelBase
from wav2vec_s_tpu_torch.models.modules import (
    TransformerEncoderLayer, dense, ln)
from wav2vec_s_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config, encoder_layers)
from wav2vec_s_tpu_torch.ops.block_mask import (
    append_right_context, block_attn_bias, block_layout, strip_right_context)
from wav2vec_s_tpu_torch.ops.dropout import DropoutContext
from wav2vec_s_tpu_torch.utils.positional import (
    sinusoidal_positions_from_padding)

N_MELS = 80


def _same_len(n: int, stride: int) -> int:
    return -(-n // stride)


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """TF/flax ``SAME`` padding of one axis: (before, after)."""
    total = max((_same_len(n, stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over NCHW ``x`` with flax ``padding="SAME"``, in
    ``x.dtype`` (the weight is cast, a no-op on a ``compute_copy``)."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    th = _same_pads(x.shape[2], kh, sh)
    tw = _same_pads(x.shape[3], kw, sw)
    x = F.pad(x, (tw[0], tw[1], th[0], th[1]))
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, stride=conv.stride)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm over NCHW ``x`` in float32, cast back to ``x.dtype``:
    flax's statistics (``E[x^2] - E[x]^2`` clipped at 0) in plain ops.
    Their autograd is the JAX gradient; ``F.group_norm``'s float32 CPU
    backward strayed 2e-2 of the largest gradient from float64 at the
    tests' ResNet, where JAX's stays within 3e-6."""
    B, C = x.shape[:2]
    g = x.float().reshape(B, norm.num_groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = torch.clamp((g * g).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = ((g - mean) * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    w, b = (t.float()[:, None, None] for t in (norm.weight, norm.bias))
    return (y * w + b).to(x.dtype)


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=1e-6)   # flax eps


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, T4, F4] -> [B, T4, F4 * C], feature index f * C + c
    (the JAX reshape of NHWC)."""
    B, C, T, Fq = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, T, Fq * C)


class Shallow2dConv(nn.Module):
    """2x (conv2d k3 s2, relu) over [B, T, F] -> [B, T/4, D]
    (audio_convs.py shallow2d_base)."""

    def __init__(self, out_dim: int = 768, channels: int = 64,
                 n_mels: int = N_MELS):
        super().__init__()
        self.conv_0 = nn.Conv2d(1, channels, 3, stride=2)
        self.conv_1 = nn.Conv2d(channels, channels, 3, stride=2)
        self.proj = nn.Linear(_same_len(_same_len(n_mels, 2), 2) * channels,
                              out_dim)

    def forward(self, feats: torch.Tensor, dtype: torch.dtype):
        x = feats[:, None].to(dtype)
        x = F.relu(conv2d_same(self.conv_0, x))
        x = F.relu(conv2d_same(self.conv_1, x))
        return dense(self.proj, _flatten(x))


class Vgg2dConv(nn.Module):
    """VGG-style front-end: 2 blocks of (conv, relu, conv, relu, max-pool
    2x2 s2, VALID)."""

    def __init__(self, out_dim: int = 768, channels: int = 64,
                 n_mels: int = N_MELS):
        super().__init__()
        widths = (channels, channels * 2)
        cin = 1
        for b, ch in enumerate(widths):
            for i in range(2):
                setattr(self, f"conv_{b}_{i}", nn.Conv2d(cin, ch, 3))
                cin = ch
        self.proj = nn.Linear(n_mels // 4 * widths[-1], out_dim)

    def forward(self, feats: torch.Tensor, dtype: torch.dtype):
        x = feats[:, None].to(dtype)
        for b in range(2):
            for i in range(2):
                x = F.relu(conv2d_same(getattr(self, f"conv_{b}_{i}"), x))
            x = F.max_pool2d(x, 2, 2)
        return dense(self.proj, _flatten(x))


class ResNetBasicBlock(nn.Module):
    """3x3-3x3 residual block (audio_convs.py:227-258 ``BasicBlock``), with
    GroupNorm where rain has BatchNorm2d (the JAX package's choice)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, bias=False)
        self.bn1 = _group_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = _group_norm(planes)
        self.down_conv = self.down_bn = None
        if stride != 1 or inplanes != planes:
            self.down_conv = nn.Conv2d(inplanes, planes, 1, stride=stride,
                                       bias=False)
            self.down_bn = _group_norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(group_norm(self.bn1, conv2d_same(self.conv1, x)))
        out = group_norm(self.bn2, conv2d_same(self.conv2, out))
        if self.down_conv is not None:
            x = group_norm(self.down_bn, conv2d_same(self.down_conv, x))
        return F.relu(out + x)


#: (planes, stride, blocks) per stage: RESNET_CONFIG_BASE
RESNET_BASE = ((64, 2, 4), (128, 2, 4))


class ResNetConv(nn.Module):
    """ResNet conv front-end (audio_convs.py:296-371 ``ResNet`` /
    ``Resnet_Base``): 3x3 stem, GroupNorm, relu, then stages of
    BasicBlocks (stride on a stage's first block), flattened channels x mel
    projected to ``out_dim``."""

    def __init__(self, out_dim: int = 768, channels: int = 64,
                 res_config=RESNET_BASE, n_mels: int = N_MELS):
        super().__init__()
        self.conv1 = nn.Conv2d(1, channels, 3, bias=False)
        self.bn1 = _group_norm(channels)
        self.blocks = []
        cin, f = channels, n_mels
        for si, (planes, stride, nlayers) in enumerate(res_config):
            for li in range(nlayers):
                name = f"stage_{si}_block_{li}"
                setattr(self, name, ResNetBasicBlock(
                    cin, planes, stride if li == 0 else 1))
                self.blocks.append(name)
                cin = planes
            f = _same_len(f, stride)
        self.out_proj = nn.Linear(f * cin, out_dim)

    def forward(self, feats: torch.Tensor, dtype: torch.dtype):
        x = feats[:, None].to(dtype)
        x = F.relu(group_norm(self.bn1, conv2d_same(self.conv1, x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return dense(self.out_proj, _flatten(x))


def resnet_small(out_dim: int = 768, **kw) -> ResNetConv:
    return ResNetConv(out_dim, res_config=((64, 2, 2), (128, 2, 2)), **kw)


CONV_FRONTENDS = {"shallow2d": Shallow2dConv, "vgg2d": Vgg2dConv,
                  "resnet": ResNetConv, "resnet_small": resnet_small}


def downsample_mask(padding_mask: torch.Tensor, t_out: int) -> torch.Tensor:
    """[B, T] feature-frame mask -> [B, t_out]: the last ``T % t_out``
    frames dropped, then a frame is pad iff all of its group is (the JAX
    function as it is, a shallow2d ``t_out = ceil(ceil(T/2)/2)`` groups
    unevenly)."""
    B, T = padding_mask.shape
    extra = T % t_out
    if extra:
        padding_mask = padding_mask[:, :-extra]
    return padding_mask.reshape(B, t_out, -1).all(dim=-1)


class FbankBlockwiseEncoder(nn.Module):
    """Conv front-end (``subsample``), sinusoidal positions, the blockwise
    encoder layers under the dense block bias, and the one ``layer_norm``
    (before the stack post-LN, after it pre-LN)."""

    def __init__(self, cfg: Wav2Vec2Config, conv_type: str = "shallow2d"):
        super().__init__()
        if conv_type not in CONV_FRONTENDS:
            raise ValueError(f"frontend={conv_type!r} is not one of "
                             f"{sorted(CONV_FRONTENDS)}")
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.subsample = CONV_FRONTENDS[conv_type](D)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(D, cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads)
            for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(D)

    def forward(self, feats: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                main_context: Optional[int] = None,
                right_context: Optional[int] = None,
                ctx: Optional[DropoutContext] = None):
        """feats [B, T, 80] float32, padding_mask [B, T] (True = pad) ->
        ([B, T4, D] in the compute dtype, [B, T4] frame padding mask)."""
        c = self.cfg
        x = self.subsample(feats, c.compute_dtype)
        if padding_mask is None:
            pm = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
        else:
            pm = downsample_mask(padding_mask, x.shape[1])
        return dense_blockwise(self, x, pm, main_context, right_context,
                               ctx), pm


def dense_blockwise(encoder: nn.Module, x: torch.Tensor, pm: torch.Tensor,
                    main_context: Optional[int], right_context: Optional[int],
                    ctx: Optional[DropoutContext]) -> torch.Tensor:
    """What the fbank and text encoders run after their embedding: the
    sinusoidal positions of the non-pad frames of ``pm``, the one
    ``layer_norm`` (before the stack post-LN, after it pre-LN) and
    ``encoder.layers`` under the dense block bias at (mc, rc) (``encoder``
    holds ``cfg``, ``layers`` and ``layer_norm``).  Unlike the raw-audio
    encoder, the pad frames are not zeroed, T is not padded to a multiple
    and no input dropout runs, as in the JAX package."""
    c = encoder.cfg
    x = x + sinusoidal_positions_from_padding(pm, x.shape[2], dtype=x.dtype)
    if not c.layer_norm_first:
        x = ln(encoder.layer_norm, x)
    mc = c.main_context if main_context is None else main_context
    rc = c.right_context if right_context is None else right_context
    layout = block_layout(x.shape[1], mc, rc)
    x = append_right_context(x, layout)
    bias = block_attn_bias(layout, pm, dtype=torch.float32)
    x = encoder_layers(encoder.layers, c, x, bias, ctx)
    x = strip_right_context(x, layout)
    if c.layer_norm_first:
        x = ln(encoder.layer_norm, x)
    return x


def _group_bias(S: int, ds: Optional[int], cfg: CaatConfig,
                enc_pad: torch.Tensor) -> torch.Tensor:
    """[B, G, S] group bias; ``ds`` <= 0 is one full-context group."""
    ds = cfg.transducer_downsample if ds is None else ds
    return group_attn_bias(S, max(ds, S) if ds <= 0 else ds, enc_pad)


class ConcatJointNet(nn.Module):
    """Additive jointer: tanh(W_enc h_t + W_dec h_u)
    (attention_transducer.py:458-506), each source group's frames mean
    pooled (a softmax over the group bias)."""

    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        D = cfg.jointer_embed_dim
        self.enc_proj = nn.Linear(enc_dim, D)
        self.dec_proj = nn.Linear(cfg.decoder_embed_dim, D)

    def forward(self, decoder_state: torch.Tensor, enc: torch.Tensor,
                enc_pad: torch.Tensor, downsample: Optional[int] = None,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """[B, U, Dd], [B, S, De], [B, S] -> [B, G, U, D] (no dropout)."""
        w = torch.softmax(_group_bias(enc.shape[1], downsample, self.cfg,
                                      enc_pad), dim=-1)
        pooled = torch.einsum("bgs,bsd->bgd", w.to(enc.dtype), enc)
        h_enc = dense(self.enc_proj, pooled.to(self.cfg.compute_dtype))
        h_dec = dense(self.dec_proj,
                      decoder_state.to(self.cfg.compute_dtype))
        return torch.tanh(h_enc[:, :, None, :] + h_dec[:, None, :, :])


class AttentionJointNet(nn.Module):
    """Single einsum-attention jointer (attention_transducer.py:509-586):
    one head over the group's visible frames, tanh of the context plus the
    decoder state."""

    def __init__(self, cfg: CaatConfig, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        D = cfg.jointer_embed_dim
        self.q_proj = nn.Linear(cfg.decoder_embed_dim, D)
        self.k_proj = nn.Linear(enc_dim, D)
        self.v_proj = nn.Linear(enc_dim, D)

    def forward(self, decoder_state: torch.Tensor, enc: torch.Tensor,
                enc_pad: torch.Tensor, downsample: Optional[int] = None,
                ctx: Optional[DropoutContext] = None) -> torch.Tensor:
        """[B, U, Dd], [B, S, De], [B, S] -> [B, G, U, D] (no dropout)."""
        dt = self.cfg.compute_dtype
        D = self.cfg.jointer_embed_dim
        q = dense(self.q_proj, decoder_state.to(dt))
        k, v = dense(self.k_proj, enc.to(dt)), dense(self.v_proj, enc.to(dt))
        logits = torch.einsum("bud,bsd->bus", q.float(), k.float()) * D ** -0.5
        bias = _group_bias(enc.shape[1], downsample, self.cfg, enc_pad)
        logits = logits[:, None] + bias[:, :, None, :]          # [B, G, U, S]
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        att = torch.einsum("bgus,bsd->bgud", p, v)
        return torch.tanh(att + decoder_state[:, None])


JOINTERS = {"mha": MHAJointNet, "concat": ConcatJointNet,
            "attention": AttentionJointNet}


class JointDecoder(nn.Module):
    """``decoder.lm`` (the IsolatedDecoder LM) and ``decoder.jointer``
    (one of ``JOINTERS``), named as in ``W2V2CaatModel``."""

    def __init__(self, cfg: CaatConfig, enc_dim: int, jointer_type: str):
        super().__init__()
        if jointer_type not in JOINTERS:
            raise ValueError(f"jointer_type={jointer_type!r} is not one of "
                             f"{sorted(JOINTERS)}")
        self.lm = IsolatedDecoder(cfg)
        self.jointer = JOINTERS[jointer_type](cfg, enc_dim)


class FbankCaatModel(CaatModelBase):
    """CAAT on 80-d log-mel features (rain arch family ``transducer`` /
    ``caat_transformer``): the config's ``frontend`` and
    ``jointer_type``."""

    def __init__(self, enc_cfg: Wav2Vec2Config, cfg: CaatConfig):
        super().__init__()
        self.enc_cfg = enc_cfg
        self.cfg = cfg
        self.encoder = FbankBlockwiseEncoder(enc_cfg, cfg.frontend)
        self.decoder = JointDecoder(cfg, enc_cfg.encoder_embed_dim,
                                    cfg.jointer_type)

    def _encode(self, source, padding_mask, main_context, right_context,
                ctx: Optional[DropoutContext] = None):
        return self.encoder(source, padding_mask, main_context,
                            right_context, ctx)
