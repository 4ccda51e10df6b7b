"""Pipeline parallelism: GPipe over a `stage` group (counterpart of
`mm_unet_tpu/parallel/pp.py`).

Rank s of the group holds the s-th of S contiguous groups of n_layer / S
layers (`stage_layers`) and runs them as its stage function
(`make_stage_fn`). `pipeline_apply` streams M microbatches through the
stages in M + S - 1 ticks: at tick t stage s runs microbatch t - s (if
there is one) and hands its output to stage s + 1 with one hop. The JAX
package computes the S - 1 bubble ticks on throwaway values; here a
stage idles through them. The last stage's outputs are broadcast to every
stage, so every stage returns the pipeline's output.

Gradients are exact. `torch.distributed` has no differentiable send and
receive, so the hop is a pair of autograd functions: the sender's backward
receives the gradient of what it sent, the receiver's sends back the
gradient of what it received, each hop tagged with its microbatch. The
engine runs each microbatch's chain whole, the last microbatch's first
(its nodes are the newest), so on every stage the backward's hops come in
reverse tick order and match. The broadcast's backward passes the last
stage's own gradient (every stage computes the same loss from the same
output, as the replicated part of the JAX SPMD program does); the other
stages' sends join the graph through it. The gradient of the input lands
on stage 0, the one stage that reads it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn


def _peer(group, r: int) -> int:
    return dist.get_global_rank(group, r) if group is not None else r


class _Send(torch.autograd.Function):
    """Sends x forward; returns an empty token that carries, in the
    backward, the gradient received from the peer."""

    @staticmethod
    def forward(ctx, x, peer, tag, group):
        ctx.peer, ctx.tag, ctx.group, ctx.like = peer, tag, group, (x.shape, x.dtype, x.device)
        dist.send(x.detach().contiguous(), peer, group=group, tag=tag)
        return x.new_zeros(0)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.peer, group=ctx.group, tag=ctx.tag)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    """Receives a tensor like `like` forward; sends its gradient back."""

    @staticmethod
    def forward(ctx, anchor, like, peer, tag, group):
        ctx.peer, ctx.tag, ctx.group = peer, tag, group
        y = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(y, peer, group=group, tag=tag)
        return y

    @staticmethod
    def backward(ctx, dy):
        dist.send(dy.contiguous(), ctx.peer, group=ctx.group, tag=ctx.tag)
        return None, None, None, None, None


class _Collect(torch.autograd.Function):
    """The last stage's outputs on every stage (one broadcast each);
    backward: the last stage's own gradient, and empty gradients for the
    tokens of this stage's sends, whose backwards then run."""

    @staticmethod
    def forward(ctx, src, group, is_last, n, *inputs):
        ctx.is_last, ctx.n, ctx.n_tok = is_last, n, len(inputs) - n
        outs = []
        for t in inputs[:n]:
            y = (t.detach().clone(memory_format=torch.contiguous_format) if is_last
                 else torch.empty_like(t, memory_format=torch.contiguous_format))
            dist.broadcast(y, src, group=group)
            outs.append(y)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dys):
        grads = [dy if ctx.is_last else None for dy in dys]
        toks = [dys[0].new_zeros(0) for _ in range(ctx.n_tok)]
        return (None, None, None, None, *grads, *toks)


def stage_layers(layers: Sequence[nn.Module], group=None) -> list[nn.Module]:
    """This rank's contiguous n_layer / S layers (the JAX package stacks the
    layers' parameters and shards the stack, `stack_layer_params`)."""
    S, s = dist.get_world_size(group), dist.get_rank(group)
    if len(layers) % S:
        raise ValueError(f"n_layer {len(layers)} not divisible by stage group size {S}")
    per = len(layers) // S
    return list(layers[s * per:(s + 1) * per])


def make_stage_fn(blocks: Sequence[nn.Module]) -> Callable:
    """The stage function of a group of layers: x (a tensor or a tuple of
    them, the layers' arguments) through each layer in order."""

    def stage_fn(x):
        for blk in blocks:
            x = blk(*x) if isinstance(x, tuple) else blk(x)
        return x

    return stage_fn


def pipeline_apply(stage_fn: Callable, x, *, num_microbatches: int, group=None):
    """`x` (a tensor or a tuple of tensors with the batch first; the same on
    every stage, read by stage 0) through the S stages of the group, each
    running its own `stage_fn` (the output has x's structure and shapes).
    Returns the output on every stage, differentiable."""
    S, s = dist.get_world_size(group), dist.get_rank(group)
    M = num_microbatches
    leaves = list(x) if isinstance(x, tuple) else [x]
    if leaves[0].shape[0] % M:
        raise ValueError(f"batch {leaves[0].shape[0]} not divisible by num_microbatches {M}")
    mbs = list(zip(*(t.chunk(M) for t in leaves)))  # microbatch m: a tuple of leaves
    pack = (lambda ls: tuple(ls)) if isinstance(x, tuple) else (lambda ls: ls[0])
    outs, tokens = [], []
    anchor = torch.zeros(0, requires_grad=True)
    for t in range(M + S - 1):
        m = t - s
        if not 0 <= m < M:
            continue  # a bubble tick
        if s == 0:
            inp = list(mbs[m])
        else:
            inp = [_Recv.apply(anchor, like, _peer(group, s - 1), m * len(leaves) + k, group)
                   for k, like in enumerate(mbs[m])]
        out = stage_fn(pack(inp))
        out = list(out) if isinstance(out, tuple) else [out]
        if s < S - 1:
            tokens += [_Send.apply(o, _peer(group, s + 1), m * len(leaves) + k, group)
                       for k, o in enumerate(out)]
        else:
            outs.append(out)
    if S == 1:
        return pack([torch.cat(ls) for ls in zip(*outs)])
    full = ([torch.cat(ls) for ls in zip(*outs)] if s == S - 1
            else [torch.empty_like(t) for t in leaves])
    got = _Collect.apply(_peer(group, S - 1), group, s == S - 1, len(leaves), *full, *tokens)
    return pack(list(got))


def mixer_pipeline_forward(model, input_ids: torch.Tensor, *, num_microbatches: int,
                           group=None) -> torch.Tensor:
    """`models.lm.MixerModel.forward` with its Blocks pipelined over the
    stage group (`pp.py:123-162`): the embedding and the final norm run on
    every stage; the Blocks of this rank's stage run in the pipeline. The
    first Block's residual None is a zero tensor (h + 0 is h). Every stage
    returns the output; the embedding's gradient lands on stage 0."""
    h = model.embedding(input_ids)
    stage = make_stage_fn(stage_layers(model.layers, group))
    h, residual = pipeline_apply(stage, (h, torch.zeros_like(h)),
                                 num_microbatches=num_microbatches, group=group)
    return model.norm_f(h + residual)
