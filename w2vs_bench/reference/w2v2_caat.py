"""Plain float32 reference of wav2vec-S + CAAT decoding, and its fp8 control.

Written from the published model (fairseq wav2vec 2.0 / wav2vec-S, rain's
CAAT ``w2v2_caat``): the strided conv front-end, the blockwise encoder
(blocks of ``main_context`` frames, ``right_context`` look-ahead copies per
block), the causal CAAT LM and the cross-attention jointer over the encoder
frames revealed so far.  It imports torch alone: no module of the program
under test and no JAX.  It runs one whole utterance at a time, with no
cache, no batching across streams and no kernel of the program.

``served_errors`` holds what the timed path left for a stream, its encoder
output and the jointer's last log-probs, to the reference recomputed from
the stream's audio and served tokens.  ``judge`` recomputes every greedy
decision point of a served stream (each emitted token, and the blank that
closed a chunk early) and returns how far each served choice's log-prob
lies below the reference's best.  With ``Arith("fp8")`` every product
quantises both operands to float8 e4m3 with one scale per tensor (the
step below the served bfloat16): that is the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

#: fairseq dictionary: bos doubles as the transducer blank; pad is never
#: emitted (the decoders mask it)
BLANK, PAD = 0, 1
#: the first real frame / token takes sinusoidal row 2 (fairseq padding_idx 1)
POS_OFFSET = 2
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- parameters --------------------------------------------------------------

def param_spec(w2v: dict, caat: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every weight, in a fixed order, under the
    names of rain's ``w2v2_caat`` state dict.  ``kind``: ``normal`` (std),
    ``one`` (1 + std * noise: a norm's gain), ``zero``, ``const`` (std is
    the value)."""
    out = []

    def add(name, shape, kind, std=0.0):
        out.append((name, tuple(int(s) for s in shape), kind, float(std)))

    D = w2v["encoder_embed_dim"]
    F_ = w2v["encoder_ffn_embed_dim"]
    e = "encoder.w2v2_model."
    add(e + "mask_emb", (D,), "zero")
    convs = w2v["conv_feature_layers"]
    n_ln = 1 if w2v["encoder_layers"] == 12 else len(convs)
    cin = 1
    for i, (dim, k, _) in enumerate(convs):
        add(f"{e}feature_extractor.conv_layers.{i}.0.weight", (dim, cin, k),
            "normal", math.sqrt(2.0 / (cin * k)))
        if w2v["conv_bias"]:
            add(f"{e}feature_extractor.conv_layers.{i}.0.bias", (dim,),
                "normal", 0.02)
        if i < n_ln:
            add(f"{e}feature_extractor.conv_layers.{i}.2.1.weight", (dim,),
                "one", 0.1)
            add(f"{e}feature_extractor.conv_layers.{i}.2.1.bias", (dim,),
                "normal", 0.05)
        cin = dim
    add(e + "layer_norm.weight", (cin,), "one", 0.1)
    add(e + "layer_norm.bias", (cin,), "normal", 0.05)
    if cin != D:
        add(e + "post_extract_proj.weight", (D, cin), "normal", cin ** -0.5)
        add(e + "post_extract_proj.bias", (D,), "normal", 0.02)
    add(e + "encoder.layer_norm.weight", (D,), "one", 0.1)
    add(e + "encoder.layer_norm.bias", (D,), "normal", 0.05)
    for i in range(w2v["encoder_layers"]):
        _layer(add, f"{e}encoder.layers.{i}.", D, F_, "self_attn",
               "self_attn_layer_norm", D)

    Dd = caat["decoder_embed_dim"]
    add("decoder.lm.version", (1,), "const", 3.0)
    add("decoder.lm.embed_tokens.weight", (caat["vocab_size"], Dd), "normal",
        Dd ** -0.5)
    for i in range(caat["decoder_layers"]):
        _layer(add, f"decoder.lm.layers.{i}.", Dd,
               caat["decoder_ffn_embed_dim"], "self_attn",
               "self_attn_layer_norm", Dd)
    add("decoder.lm.layer_norm.weight", (Dd,), "one", 0.1)
    add("decoder.lm.layer_norm.bias", (Dd,), "normal", 0.05)
    Dj = caat["jointer_embed_dim"]
    for i in range(caat["jointer_layers"]):
        _layer(add, f"decoder.jointer.layers.{i}.", Dj,
               caat["jointer_ffn_embed_dim"], "enc_attn", "attn_layer_norm", D)
    return out


def _layer(add, p, D, F_, att, att_ln, kdim):
    for proj, fan in (("q_proj", D), ("k_proj", kdim), ("v_proj", kdim),
                      ("out_proj", D)):
        add(f"{p}{att}.{proj}.weight", (D, fan), "normal", fan ** -0.5)
        add(f"{p}{att}.{proj}.bias", (D,), "normal", 0.02)
    add(f"{p}{att_ln}.weight", (D,), "one", 0.1)
    add(f"{p}{att_ln}.bias", (D,), "normal", 0.05)
    add(f"{p}fc1.weight", (F_, D), "normal", D ** -0.5)
    add(f"{p}fc1.bias", (F_,), "normal", 0.02)
    add(f"{p}fc2.weight", (D, F_), "normal", F_ ** -0.5)
    add(f"{p}fc2.bias", (D,), "normal", 0.02)
    add(f"{p}final_layer_norm.weight", (D,), "one", 0.1)
    add(f"{p}final_layer_norm.bias", (D,), "normal", 0.05)


# -- arithmetic in the chosen precision ---------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 round trip with one scale per tensor (amax to 448)."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """The products of one forward: float32, or fp8 operands (the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.q = _fp8 if precision == "fp8" else (lambda t: t.float())

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b.float()

    def conv1d(self, x, w, b, stride):
        return F.conv1d(self.q(x), self.q(w), None if b is None else b.float(),
                        stride=stride)

    def attend(self, q, k, v, allowed):
        """q [.., Tq, Dh], k/v [.., Tk, Dh], allowed [.., Tq, Tk] bool."""
        logits = self.q(q) @ self.q(k).transpose(-1, -2) * q.shape[-1] ** -0.5
        logits = logits.masked_fill(~allowed, float("-inf"))
        return self.q(torch.softmax(logits, dim=-1)) @ self.q(v)


def _ln(x, W, p, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), W[p + ".weight"].float(),
                        W[p + ".bias"].float(), eps)


def sinusoid(n: int, dim: int, device) -> torch.Tensor:
    """fairseq sinusoidal table [n, dim]: [sin | cos] halves, row 1 zero."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float64)
                     * -(math.log(10000.0) / (half - 1)))
    args = torch.arange(n, dtype=torch.float64)[:, None] * freq[None]
    table = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2:
        table = torch.cat([table, torch.zeros(n, 1, dtype=torch.float64)], 1)
    table[1] = 0.0
    return table.float().to(device)


def _mha(A, W, p, x, src, allowed, heads):
    """Multi-head attention of ``x`` [Tq, D] over ``src`` [Tk, Dk]."""
    q = A.linear(x, W[p + ".q_proj.weight"], W[p + ".q_proj.bias"])
    k = A.linear(src, W[p + ".k_proj.weight"], W[p + ".k_proj.bias"])
    v = A.linear(src, W[p + ".v_proj.weight"], W[p + ".v_proj.bias"])

    def split(t):
        return t.reshape(t.shape[0], heads, -1).transpose(0, 1)

    o = A.attend(split(q), split(k), split(v), allowed[None])
    o = o.transpose(0, 1).reshape(x.shape[0], -1)
    return A.linear(o, W[p + ".out_proj.weight"], W[p + ".out_proj.bias"])


def _ffn(A, W, p, x, act):
    h = act(A.linear(x, W[p + ".fc1.weight"], W[p + ".fc1.bias"]))
    return A.linear(h, W[p + ".fc2.weight"], W[p + ".fc2.bias"])


# -- the model ---------------------------------------------------------------

def block_allowed(T: int, mc: int, rc: int, device):
    """The wav2vec-S block mask over T frames and their look-ahead copies:
    (allowed [S, S] bool, copy source index [R]).  A frame of block b sees
    the frames of blocks <= b and the copies of block b; the copies of
    block b (frames [(b+1)mc, (b+1)mc + rc), one set per full block) behave
    as members of block b; a copy past the last frame is masked."""
    block = torch.arange(T, device=device) // mc
    nb = T // mc if rc else 0
    src = ((torch.arange(nb, device=device)[:, None] + 1) * mc
           + torch.arange(rc, device=device)[None]).reshape(-1)
    valid = src < T
    copy_block = torch.arange(nb, device=device).repeat_interleave(rc)
    row_block = torch.cat([block, copy_block])
    allowed = torch.cat([
        row_block[:, None] >= block[None, :],
        (row_block[:, None] == copy_block[None, :]) & valid[None, :]], dim=1)
    return allowed, src.clamp(max=T - 1)


def encode(W: Dict[str, torch.Tensor], w2v: dict, audio: torch.Tensor,
           n_frames: int, A: Arith) -> torch.Tensor:
    """audio [n_samples] float -> encoder output [n_frames, D] (the whole
    utterance, one blockwise pass, float32 or the control's products)."""
    e = "encoder.w2v2_model."
    convs = w2v["conv_feature_layers"]
    n_ln = 1 if w2v["encoder_layers"] == 12 else len(convs)
    x = audio.float()[None, None]
    for i, (_, _, stride) in enumerate(convs):
        p = f"{e}feature_extractor.conv_layers.{i}"
        x = A.conv1d(x, W[p + ".0.weight"], W.get(p + ".0.bias"), stride)
        if i < n_ln:
            x = _ln(x.transpose(1, 2), W, p + ".2.1").transpose(1, 2)
        x = F.gelu(x)
    x = x[0].t()[:n_frames]                               # [T, C]
    x = _ln(x, W, e + "layer_norm")
    if e + "post_extract_proj.weight" in W:
        x = A.linear(x, W[e + "post_extract_proj.weight"],
                     W[e + "post_extract_proj.bias"])
    T, D = x.shape
    x = x + sinusoid(T + POS_OFFSET, D, x.device)[POS_OFFSET:]
    pre = w2v["layer_norm_first"]
    if not pre:
        x = _ln(x, W, e + "encoder.layer_norm")
    # pad to the sequence multiple (padded frames are masked as keys)
    Tp = T + (-T) % w2v.get("required_seq_len_multiple", 2)
    if Tp > T:
        x = torch.cat([x, x.new_zeros(Tp - T, D)])
    allowed, src = block_allowed(Tp, w2v["main_context"], w2v["right_context"],
                                 x.device)
    key_ok = torch.cat([torch.arange(Tp, device=x.device) < T, src < T])
    allowed = allowed & key_ok[None]
    x = torch.cat([x, x[src]])
    H = w2v["encoder_attention_heads"]
    for i in range(w2v["encoder_layers"]):
        p = f"{e}encoder.layers.{i}"
        if pre:
            x = x + _mha(A, W, p + ".self_attn",
                         _ln(x, W, p + ".self_attn_layer_norm"),
                         _ln(x, W, p + ".self_attn_layer_norm"), allowed, H)
            x = x + _ffn(A, W, p, _ln(x, W, p + ".final_layer_norm"), F.gelu)
        else:
            x = _ln(x + _mha(A, W, p + ".self_attn", x, x, allowed, H), W,
                    p + ".self_attn_layer_norm")
            x = _ln(x + _ffn(A, W, p, x, F.gelu), W, p + ".final_layer_norm")
    x = x[:T]
    if pre:
        x = _ln(x, W, e + "encoder.layer_norm")
    return x


def lm_states(W, caat: dict, tokens: Sequence[int], A: Arith, device):
    """The CAAT LM over [blank] + tokens -> [len + 1, D]: scaled embedding,
    sinusoidal positions from row 2, causal pre-LN relu layers, final
    norm."""
    ids = torch.tensor([BLANK] + list(tokens), device=device)
    D = caat["decoder_embed_dim"]
    n = ids.shape[0]
    x = W["decoder.lm.embed_tokens.weight"].float()[ids] * D ** 0.5
    x = x + sinusoid(n + POS_OFFSET, D, device)[POS_OFFSET:]
    causal = torch.ones(n, n, dtype=torch.bool, device=device).tril()
    H = caat["decoder_attention_heads"]
    for i in range(caat["decoder_layers"]):
        p = f"decoder.lm.layers.{i}"
        h = _ln(x, W, p + ".self_attn_layer_norm")
        x = x + _mha(A, W, p + ".self_attn", h, h, causal, H)
        x = x + _ffn(A, W, p, _ln(x, W, p + ".final_layer_norm"), F.relu)
    return _ln(x, W, "decoder.lm.layer_norm")


def joint_log_probs(W, caat: dict, h: torch.Tensor, enc: torch.Tensor,
                    visible: torch.Tensor, A: Arith) -> torch.Tensor:
    """Jointer over the first ``visible[i]`` encoder frames for the LM state
    ``h[i]`` -> float32 log-probs [n, V] (pad excluded: -inf)."""
    T = enc.shape[0]
    allowed = torch.arange(T, device=enc.device)[None] < visible[:, None]
    H = caat["jointer_attention_heads"]
    x = h
    for i in range(caat["jointer_layers"]):
        p = f"decoder.jointer.layers.{i}"
        x = x + _mha(A, W, p + ".enc_attn", _ln(x, W, p + ".attn_layer_norm"),
                     enc, allowed, H)
        x = x + _ffn(A, W, p, _ln(x, W, p + ".final_layer_norm"), F.relu)
    logits = A.linear(x, W["decoder.lm.embed_tokens.weight"])
    logits[:, PAD] = float("-inf")
    return torch.log_softmax(logits, dim=-1)


def decisions(tokens: Sequence[int], chunk_of: Sequence[int], n_chunks: int,
              max_emit: int, max_len: int):
    """The greedy decision points of a served stream: (prefix length j,
    chunk c, served symbol) for every emitted token, and a blank where a
    chunk ended before ``max_emit`` emissions with room left in the prefix
    (``max_len`` counts the leading blank)."""
    out, j = [], 0
    for c in range(n_chunks):
        n_c = 0
        while j < len(tokens) and chunk_of[j] == c:
            out.append((j, c, int(tokens[j])))
            j += 1
            n_c += 1
        if n_c < max_emit and j + 1 < max_len:
            out.append((j, c, BLANK))
    if j != len(tokens):
        raise ValueError(f"token {j} lies in chunk {chunk_of[j]}, outside "
                         f"the stream's {n_chunks} chunks")
    return out


@torch.no_grad()
def served_errors(W, w2v: dict, caat: dict, audio: torch.Tensor,
                  n_frames: int, enc_rows: torch.Tensor, prefix, visible: int,
                  log_probs: torch.Tensor, control: bool = False):
    """(encoder error, log-prob error) of one stream as the timed path left
    it: ``enc_rows`` [n, D], the encoder output of its first n frames, held
    to the reference over ``n_frames`` frames of ``audio`` (frames < n
    depend on no later frame) as ||served - ref|| / ||ref||; ``log_probs``
    [V], the jointer's last output for the stream, after the tokens
    ``prefix`` over its first ``visible`` frames, held to the reference's
    as the largest absolute difference (pad excluded, both normalised over
    the rest).  ``control``: the fp8 model's outputs stand in for the
    served ones."""
    n = enc_rows.shape[0]
    dev = audio.device
    f32 = Arith("float32")
    vis = torch.tensor([visible], device=dev)
    with exact_float32():
        enc = encode(W, w2v, audio, n_frames, f32)
        lp = joint_log_probs(W, caat, lm_states(W, caat, prefix, f32, dev)
                             [-1:], enc, vis, f32)[0]
        if control:
            low = Arith("fp8")
            enc8 = encode(W, w2v, audio, n_frames, low)
            got_enc = enc8[:n]
            got_lp = joint_log_probs(W, caat, lm_states(W, caat, prefix, low,
                                                        dev)[-1:],
                                     enc8, vis, low)[0]
        else:
            got_enc = enc_rows.float()
            got_lp = log_probs.float().clone()
            got_lp[PAD] = float("-inf")
            got_lp = got_lp.log_softmax(-1)
    ref_enc = enc[:n]
    keep = torch.isfinite(lp)
    return (float((got_enc - ref_enc).norm() / ref_enc.norm()),
            float((got_lp - lp)[keep].abs().max()))


@torch.no_grad()
def judge(W, w2v: dict, caat: dict, audio: torch.Tensor, tokens, chunk_of,
          n_chunks: int, n_main: int, max_emit: int, max_len: int,
          control: bool = False) -> List[float]:
    """Gaps of one served stream (see the module docstring).  ``audio``
    holds at least the samples of ``n_chunks * n_main + right_context``
    frames.  ``control``: the fp8 model chooses, the float32 model scores."""
    rc = w2v["right_context"]
    T = n_chunks * n_main + rc
    dev = audio.device
    ref = Arith("float32")
    with exact_float32():
        enc = encode(W, w2v, audio, T, ref)
        h = lm_states(W, caat, tokens, ref, dev)
        pts = decisions(tokens, chunk_of, n_chunks, max_emit, max_len)
        j = torch.tensor([p[0] for p in pts], device=dev)
        vis = torch.tensor([(p[1] + 1) * n_main + (rc if p[1] == n_chunks - 1
                                                   else 0) for p in pts],
                           device=dev)
        served = torch.tensor([p[2] for p in pts], device=dev)
        lp = joint_log_probs(W, caat, h[j], enc, vis, ref)
        if control:
            low = Arith("fp8")
            enc8 = encode(W, w2v, audio, T, low)
            h8 = lm_states(W, caat, tokens, low, dev)
            served = joint_log_probs(W, caat, h8[j], enc8, vis, low).argmax(-1)
        best = lp.max(dim=-1).values
        gap = best - lp.gather(1, served[:, None])[:, 0]
    return gap.tolist()
