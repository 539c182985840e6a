"""What a served stream was: its tokens, the chunk of each, its decisions;
the model FLOPs of serving it; and the judgement against the reference.

Shared by the decoding drivers.  A decoder hands back, per stream, a text
and one delay per emitted token; the delay of a token emitted after chunk
``k`` is ``(k * stride + window) / 16`` ms (16 samples per ms).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from w2vs_bench import work
from w2vs_bench.model import text_ids


@dataclasses.dataclass
class Served:
    key: tuple                  # how the driver finds the stream's audio
    n_samples: int
    n_chunks: int
    tokens: List[int]
    chunk_of: List[int]


def chunks_of(n_samples: int, rf: int, hop: int, rc: int, n_main: int) -> int:
    """Chunks the decoders run over ``n_samples`` (their own formula)."""
    frames = (n_samples - rf) // hop + 1
    return max((frames - rc) // n_main, 1)


def served(key, text: str, delays_ms, vocab, n_samples: int, geo) -> Served:
    """``geo``: the decoder's (rf, hop, rc, n_main, window) in samples and
    frames."""
    rf, hop, rc, n_main, window = geo
    stride = n_main * hop
    toks = text_ids(text, vocab)
    chunk_of = [int(round((d * 16 - window) / stride)) for d in delays_ms]
    if len(toks) != len(chunk_of):
        raise ValueError(f"stream {key}: {len(toks)} tokens in its text and "
                         f"{len(chunk_of)} delays")
    return Served(key, n_samples, chunks_of(n_samples, rf, hop, rc, n_main),
                  toks, chunk_of)


def chunk_flops(cfg: dict, traffic: dict, c: int, last: bool, k: int,
                before: int) -> float:
    """Model FLOPs of one stream's chunk ``c`` (``last``: the stream's
    final one, which adds the right-context frames), in which it emitted
    ``k`` tokens after ``before``: the front-end over the chunk's new
    frames, the encoder rows of the chunk over their allowed pairs (the
    committed frames and the chunk's block mask), the jointer K/V of the
    new frames, a jointer pass over the visible frames and a vocabulary
    projection per decision (the tokens, and the blank that closed the
    chunk early), an LM step per token."""
    w, ca = cfg["w2v"], cfg["caat"]
    mc, rc = w["main_context"], w["right_context"]
    blocks = traffic["blocks_per_step"]
    n_main = mc * blocks
    rf, hop = work.receptive(w["conv_feature_layers"])
    new = n_main + (rc if last else 0)
    f = float(work.conv_flops((new - 1) * hop + rf, w["conv_feature_layers"]))
    D, Fe = w["encoder_embed_dim"], w["encoder_ffn_embed_dim"]
    C = w["conv_feature_layers"][-1][0]
    f += 2 * new * C * D if C != D else 0
    f += w["encoder_layers"] * (
        blocks * (mc + rc) * work.layer_row_flops(D, Fe)
        + 4 * D * work.chunk_pairs(c * n_main, mc, rc, blocks))
    Dj, Fj, Lj = (ca["jointer_embed_dim"], ca["jointer_ffn_embed_dim"],
                  ca["jointer_layers"])
    f += Lj * new * 4 * D * Dj
    done = before + k
    dec = k + int(k < traffic["max_emit_per_chunk"]
                  and done + 1 < traffic["max_len"])
    vis = (c + 1) * n_main + (rc if last else 0)
    f += dec * (Lj * (4 * Dj * Dj + 4 * Dj * Fj + 4 * Dj * vis)
                + 2 * Dj * ca["vocab_size"])
    Dd, Fd, Ld = (ca["decoder_embed_dim"], ca["decoder_ffn_embed_dim"],
                  ca["decoder_layers"])
    for j in range(before, done):
        f += Ld * (work.layer_row_flops(Dd, Fd) + 4 * Dd * (j + 2))
    return f


def decode_flops(s: Served, cfg: dict, traffic: dict) -> float:
    """Model FLOPs of serving one stream: ``chunk_flops`` over its chunks
    (the serving driver counts the same per chunk it steps)."""
    per = np.bincount(np.asarray(s.chunk_of, np.int64),
                      minlength=s.n_chunks)[:s.n_chunks]
    before = np.concatenate([[0], np.cumsum(per)[:-1]])
    return float(sum(chunk_flops(cfg, traffic, c, c == s.n_chunks - 1,
                                 int(per[c]), int(before[c]))
                     for c in range(s.n_chunks)))


def judge(ref, weights, cfg: dict, traffic: dict, s: Served, audio,
          control: bool = False) -> List[float]:
    """The reference's gaps for one served stream (``audio``: float32
    samples on the reference's device)."""
    mc = cfg["w2v"]["main_context"]
    return ref.judge(weights, cfg["w2v"], cfg["caat"], audio, s.tokens,
                     s.chunk_of, s.n_chunks, mc * traffic["blocks_per_step"],
                     traffic["max_emit_per_chunk"], traffic["max_len"],
                     control=control)


def checks(errs, gaps, bad, limits: dict) -> list:
    """The compared numbers of a decoding cell: the worst encoder error and
    the worst log-prob error over the streams whose outputs were kept, and
    the widest logit gap over the decisions of the judged streams (1e30
    where a served output was malformed or nothing could be scored)."""
    worst = ([max(e[k] for e in errs) for k in (0, 1)]
             if errs and not bad else [1e30, 1e30])
    worst.append(max(gaps) if gaps and not bad else 1e30)
    return [{"name": name, "value": v, "limit": limits[name]["limit"]}
            for name, v in zip(("encoder_rel_err", "joint_logprob_err",
                                "max_logit_gap"), worst)]
