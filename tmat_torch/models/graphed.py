"""Members of the invasion ensemble whose features replay from one CUDA graph.

``GraphedFeatures`` is the base of each backbone's classifier
(``resnet.ResNet50TL``, ``swin.SwinV2TL``). A member defines ``features``:
(B, h, w, 3) float32 inputs of its fixed ``input_shape`` to (B, C) float32
pooled features, each image computed on its own. Its head runs on
``pooled(x)``, which is ``features(x)``:

- On CUDA, once ``capture`` has run (the tool's loaders call it), from one
  CUDA graph of ``GRAPH_BATCH`` slices: the host launches a copy and a graph
  instead of every kernel of the base, which it issued more slowly than the
  card ran them. A batch of any size takes ``ceil(B / GRAPH_BATCH)``
  replays, the last one's spare rows holding whatever they held (each image
  is computed on its own, so they change no other row), so no batch
  captures, synchronises or allocates a pool after load. The members of a
  process share one memory pool on their device for their graphs'
  activations, whatever their backbone: a replay's output is read (the
  head, or a copy) before another replay is queued on the stream. The
  base's Python runs only at the warm-up and the capture, so the graph
  keeps the kernels picked then: set the TF32 flags before loading a
  float32 member.
- Elsewhere (the CPU, or a member built and not captured), eagerly.

``replays(x)`` says which: the replays ``pooled(x)`` takes, 0 where it runs
eagerly (``resnet.ensemble_forward`` counts them). ``count_features(batch)``
adds a backbone's own counters for one pass over ``batch`` images, replayed
or eager.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import torch
from torch import nn

GRAPH_BATCH = 8  # slices a graph replay: the depth of the invasion traffic's stacks
# the members with a captured graph: a new one shares a live one's memory pool
# (a pool lasts as long as a graph in it)
_CAPTURED: "weakref.WeakSet[GraphedFeatures]" = weakref.WeakSet()


class GraphedFeatures(nn.Module):
    """A classifier whose ``features`` may replay from a CUDA graph (module doc)."""

    input_shape: Tuple[int, int, int]  # (h, w, 3): the input a captured graph takes
    _graph: Optional[tuple] = None  # (graph, its input, its output) once captured

    def features(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def count_features(self, batch: int) -> None:
        """The backbone's counters of one ``features`` pass over ``batch`` images."""

    @torch.no_grad()
    def capture(self) -> "GraphedFeatures":
        """On CUDA, ``features`` of ``GRAPH_BATCH`` slices as a CUDA graph in
        the memory pool of the device's other members (module doc); a no-op
        elsewhere."""
        dev = next(self.parameters()).device
        if dev.type != "cuda":
            return self
        static_x = torch.zeros(GRAPH_BATCH, *self.input_shape, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.features(static_x)  # first calls pick their kernels outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = next((m._graph[0].pool() for m in _CAPTURED if m._graph[1].device == dev), None)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            static_feats = self.features(static_x)
        self._graph = graph, static_x, static_feats
        _CAPTURED.add(self)
        return self

    def replays(self, x: torch.Tensor) -> int:
        """The graph replays ``pooled(x)`` takes; 0 where it runs eagerly."""
        return -(-x.shape[0] // GRAPH_BATCH) if self._graph is not None and x.is_cuda else 0

    def pooled(self, x: torch.Tensor) -> torch.Tensor:
        """``features(x)``, replayed or eager (module doc)."""
        if self.replays(x):
            return self._replayed(x)
        self.count_features(x.shape[0])
        return self.features(x)

    def _replayed(self, x: torch.Tensor) -> torch.Tensor:
        """``features(x)`` from ``ceil(B / GRAPH_BATCH)`` replays (module
        doc). For one replay the returned tensor is the graph's own, which
        the next replay of any member may overwrite, in stream order."""
        graph, static_x, static_feats = self._graph
        parts = []
        for i in range(0, x.shape[0], GRAPH_BATCH):
            part = x[i:i + GRAPH_BATCH]
            static_x[:len(part)].copy_(part)
            graph.replay()
            self.count_features(GRAPH_BATCH)
            out = static_feats[:len(part)]
            parts.append(out.clone() if x.shape[0] > GRAPH_BATCH else out)
        return parts[0] if len(parts) == 1 else torch.cat(parts)
