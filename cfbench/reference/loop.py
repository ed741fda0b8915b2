"""The chunk loop of the plain epochs: one step a chunk, in visit order.

On the card, after the first ``GROUP`` steps run eagerly (which loads
every kernel the step uses), the rest run as replays of one CUDA graph
of ``GROUP`` steps: the same plain PyTorch operations in the same order,
captured once over static input buffers that each replay refills with
the next group's rows, so that no operation pays a host launch. The
last partial group, and every step off the card, runs eagerly.

``run_many`` runs several independent epochs (each its own tables) at
once: on the card each on a stream of its own, their groups' replays
interleaved, so that their small steps share the device; off the card
one after another.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

GROUP = 256


@dataclass
class Epoch:
    """One plain epoch: the leaves it starts from, its step, the step's
    per-chunk inputs, and a function that reads the leaves it ends at."""
    start: dict
    step: Callable
    inputs: tuple
    end: Callable


class _Loop:
    """One epoch's loop: ``step(*rows)`` for each index c of the
    equal-length tensors ``inputs`` (each [n, ...]), rows = tuple(t[c]
    for t in inputs), in order of c."""

    def __init__(self, step, inputs: tuple, stream=None):
        self.step, self.inputs, self.stream = step, inputs, stream
        self.n = inputs[0].shape[0]
        self.graphed = inputs[0].is_cuda and self.n >= 2 * GROUP
        self.full = self.n // GROUP * GROUP if self.graphed else 0

    def on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def eager(self, lo: int, hi: int):
        with self.on_stream():
            for c in range(lo, hi):
                self.step(*(t[c] for t in self.inputs))

    def capture(self):
        with self.on_stream():
            self.static = tuple(t[:GROUP].clone() for t in self.inputs)
        if self.stream is not None:
            torch.cuda.current_stream().wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for g in range(GROUP):
                self.step(*(s[g] for s in self.static))
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream())

    def replay(self, start: int):
        with self.on_stream():
            for s, t in zip(self.static, self.inputs):
                s.copy_(t[start:start + GROUP])
            self.graph.replay()


def run_many(epochs: list) -> list:
    """Runs each ``Epoch`` of ``epochs`` (independent of one another) and
    returns the (start, end) leaves of each."""
    cuda = bool(epochs) and epochs[0].inputs[0].is_cuda
    side = cuda and len(epochs) > 1
    loops = [_Loop(e.step, e.inputs, torch.cuda.Stream() if side else None)
             for e in epochs]
    main = torch.cuda.current_stream() if cuda else None
    if side:
        for lp in loops:
            lp.stream.wait_stream(main)
    with torch.no_grad():
        for lp in loops:
            lp.eager(0, GROUP if lp.graphed else lp.n)
            if lp.graphed:
                lp.capture()
        for start in range(GROUP, max(lp.full for lp in loops), GROUP):
            for lp in loops:
                if start < lp.full:
                    lp.replay(start)
        for lp in loops:
            if lp.graphed:
                lp.eager(lp.full, lp.n)
                del lp.graph
    if side:
        for lp in loops:
            main.wait_stream(lp.stream)
    return [(e.start, e.end()) for e in epochs]
