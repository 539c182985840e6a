"""GPipe pipeline parallelism over the mesh's ``pipe`` dim (port of
``wav2vec_s_tpu/parallel/pipeline.py``).

A combinator, not a wrapper class: a stack of L identical layers, their
parameters stacked along a leading layer axis (``stack_layer_params``), is
split over P pipeline stages (stage s applies layers [s L/P, (s + 1) L/P));
M microbatches march through the stages in lockstep, and the ring shift of
``parallel/functional.py`` moves the activations from stage s to s + 1.
Everything is differentiable: ``loss.backward()`` on every rank runs the
backward pipeline (the ticks in reverse, each gradient shifted from s + 1
back to s, as ``ring_shift``'s backward does), and each stage's gradients
land on its own layers' block of the stacked parameters (the other blocks
get none).

Schedule (plain GPipe, M + P - 1 ticks, as the JAX ``pipeline_apply``):
at tick t stage 0 takes microbatch t (t < M), every stage applies its
layers, stage P - 1 writes microbatch t - (P - 1) (t >= P - 1), and the
activations shift s -> s + 1.  A stage whose tick holds no microbatch
(t - s outside [0, M)) skips its layers and sends zeros: the JAX scan
computes them and throws them away, which changes nothing.  The result
lives on the last stage; a sum over the pipe group (backward: the
identity, as every stage computes the same loss from it) hands it to
every stage.  The shift runs over gloo as an all-gather (gloo has no
point-to-point on CUDA tensors) and over NCCL as ``batch_isend_irecv``.  Bubble fraction (P - 1) / (M + P - 1).

Data parallelism: each microbatch's rows are split over the ``data`` dim
(JAX ``x_spec = P(None, data)``): a rank takes the rows ``local_rows``
selects, and its result holds those rows.  The parameters are replicated
over ``data`` (and over ``model`` and ``seq``: the layer function runs
whole on each of them); summing the parameters' gradients over the data
group is the caller's, as in the train step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from wav2vec_s_tpu_torch.parallel.functional import shift
from wav2vec_s_tpu_torch.parallel.mesh import AXES, dim_size

Stacked = Dict[str, torch.Tensor]
LayerFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def stack_layer_params(layers: Union[Sequence[nn.Module],
                                     Sequence[Dict[str, torch.Tensor]]]
                       ) -> Stacked:
    """One dict of [L, ...] leaves from L layers (modules or state dicts
    with the same keys): the layout that ``apply_stacked`` and the
    pipeline's stage split want.  The result is a new leaf per key that
    requires grad."""
    dicts = [dict(m.named_parameters()) if isinstance(m, nn.Module) else m
             for m in layers]
    return {k: torch.stack([d[k].detach() for d in dicts]).requires_grad_()
            for k in dicts[0]}


def layer_params(stacked: Stacked, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters (views of the stacked leaves)."""
    return {k: v[i] for k, v in stacked.items()}


def apply_stacked(layer_fn: LayerFn, stacked: Stacked,
                  x: torch.Tensor) -> torch.Tensor:
    """Apply the stacked layers in order (the sequential oracle)."""
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        x = layer_fn(layer_params(stacked, i), x)
    return x


def local_rows(x: torch.Tensor, mesh, microbatches: int) -> torch.Tensor:
    """This rank's rows of a whole batch ``x`` [B, ...] under the
    pipeline's split: microbatch m is rows [m B/M, (m + 1) B/M) of ``x``,
    and the data rank d holds its d-th block of each, in microbatch
    order.  ``pipeline_apply`` returns the layers' output on these rows."""
    n_data = dim_size(mesh, AXES.data)
    B, M = x.shape[0], microbatches
    if B % M or (B // M) % n_data:
        raise ValueError(f"{B} rows do not split into {M} microbatches of "
                         f"a multiple of {n_data} data ranks")
    per = B // M // n_data
    d = mesh.get_local_rank(AXES.data)
    xs = x.reshape(M, B // M, *x.shape[1:])
    return xs[:, d * per:(d + 1) * per].reshape(M * per, *x.shape[1:])


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of one stage, forward and backward.  Autograd
    alone would run each rank's backward in its own graph's order, and
    the stages' graphs differ (stage 0 never reads what it receives), so
    the backward collectives would not meet; here the backward walks the
    ticks in reverse on every stage: the gradient of a tick's shift goes
    back (``shift`` by -1), then the stage's layers' vector-Jacobian
    product of that tick."""

    @staticmethod
    def forward(ctx, layer_fn, group, stage, n_pipe, keys, xs, *block):
        M, T = xs.shape[0], xs.shape[0] + n_pipe - 1
        last = stage == n_pipe - 1
        params = [p.detach().requires_grad_() for p in block]
        local = dict(zip(keys, params))
        ticks = []                          # (microbatch, h_in, h_out)
        outs = [torch.zeros_like(xs[0])] * M
        buf = torch.zeros_like(xs[0])
        with torch.enable_grad():
            for t in range(T):
                m = t - stage
                if 0 <= m < M:
                    h_in = (xs[m] if stage == 0 else buf).detach()
                    h_in.requires_grad_()
                    h_out = apply_stacked(layer_fn, local, h_in)
                    ticks.append((m, h_in, h_out))
                    h = h_out.detach()
                    if last:
                        outs[m] = h
                else:
                    h = torch.zeros_like(buf)
                if t < T - 1:           # the last tick's shift feeds nothing
                    buf = shift(h, group, 1)
        out = torch.stack(outs)
        # results live on the last stage (zeros elsewhere): the sum over
        # the pipe group gives them to every stage
        dist.all_reduce(out, group=group)
        ctx.group, ctx.stage, ctx.n_pipe = group, stage, n_pipe
        ctx.ticks, ctx.params, ctx.xs_meta = ticks, params, xs
        return out

    @staticmethod
    def backward(ctx, dout):
        # every stage computes the same loss from the summed result, so
        # dout is the gradient of the last stage's outputs: the sum's
        # backward is the identity
        group, stage, n_pipe = ctx.group, ctx.stage, ctx.n_pipe
        xs, params = ctx.xs_meta, ctx.params
        M, T = xs.shape[0], xs.shape[0] + n_pipe - 1
        last = stage == n_pipe - 1
        ticks = {m: (h_in, h_out) for m, h_in, h_out in ctx.ticks}
        dparams = [torch.zeros_like(p) for p in params]
        dxs = torch.zeros_like(xs) if stage == 0 else None
        send = torch.zeros_like(xs[0])      # this stage's dh_in of tick t+1
        for t in reversed(range(T)):
            g = (shift(send, group, -1) if t < T - 1
                 else torch.zeros_like(send))
            m = t - stage
            send = torch.zeros_like(send)
            if not 0 <= m < M:
                continue
            if last:
                g = g + dout[m]
            h_in, h_out = ticks.pop(m)
            grads = torch.autograd.grad(h_out, [h_in, *params], g,
                                        allow_unused=True)
            for d, gp in zip(dparams, grads[1:]):
                if gp is not None:
                    d.add_(gp)
            if stage == 0:
                dxs[m] = grads[0]
            else:
                send = grads[0]
        ctx.ticks = ctx.params = None
        return (None, None, None, None, None, dxs, *dparams)


def pipeline_apply(layer_fn: LayerFn, stacked: Stacked, x: torch.Tensor,
                   mesh, microbatches: int) -> torch.Tensor:
    """Apply the L stacked layers to ``x`` [B, ...] pipelined over the
    mesh's ``pipe`` dim; returns their output on this rank's rows
    (``local_rows``), on every stage.  ``stacked`` holds every layer on
    every rank (leaves [L, ...]); L must divide by the pipe width P and B
    by ``microbatches`` times the data width.  With P = 1 it is
    ``apply_stacked`` on the rank's rows.  Differentiable in ``x`` and
    ``stacked``: the backward pipeline runs when every rank calls
    ``backward`` on a loss of the result."""
    xs = local_rows(x, mesh, microbatches)
    n_pipe = dim_size(mesh, AXES.pipe)
    if n_pipe == 1:
        return apply_stacked(layer_fn, stacked, xs)
    M = microbatches
    L = next(iter(stacked.values())).shape[0]
    if L % n_pipe:
        raise ValueError(f"{L} layers do not split over {n_pipe} stages")
    group = mesh.get_group(AXES.pipe)
    stage = mesh.get_local_rank(AXES.pipe)
    per = L // n_pipe
    keys = tuple(stacked)
    block = [stacked[k][stage * per:(stage + 1) * per] for k in keys]
    xs = xs.reshape(M, xs.shape[0] // M, *xs.shape[1:])
    out = _Pipeline.apply(layer_fn, group, stage, n_pipe, keys, xs, *block)
    return out.reshape(-1, *out.shape[2:])
