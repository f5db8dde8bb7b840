"""The frame loop every configuration's module fills in.

A configuration's `Frames` subclass builds one side, "program" (the port,
`invertavatar_torch`) or "reference" (`benchmark/reference`), from the same
inputs and the same seeded weights, and gives four calls:

  * `avatar(rows)`: the frame-independent part for identities `rows`, made
    once in set-up (the program's whole batch; the reference, one row at a
    time);
  * `drive(t)`: step t's driving signal of every stream;
  * `frame(avatar, rows, t, drive)`: the frames of `rows` at step t, a dict
    of [len(rows), ...] tensors holding at least "image", "image_raw" and
    "image_depth";
  * `spans()`: the (stage, object, attribute) callables the trace wraps.

Row b of the batch belongs to stream b // identities_per_stream."""

from __future__ import annotations

import torch

OUTPUTS = ("image", "image_raw", "image_depth")


class Frames:
    def __init__(self, side: str, cfg: dict, traffic: dict, inputs: dict, seed: int, device):
        if side not in ("program", "reference"):
            raise ValueError(f"side must be 'program' or 'reference', not {side!r}")
        self.side, self.cfg, self.traffic, self.inputs = side, cfg, traffic, inputs
        self.seed, self.device = seed, torch.device(device)
        self.per = traffic["identities_per_stream"]
        self.batch = inputs["batch"]
        self._index = {}

    def _stream_index(self, rows) -> torch.Tensor:
        key = tuple(rows)
        if key not in self._index:
            self._index[key] = torch.tensor([r // self.per for r in rows], device=self.device)
        return self._index[key]

    def per_row(self, per_stream: torch.Tensor, rows) -> torch.Tensor:
        """Rows of a [streams, ...] tensor for batch rows `rows`: as it is
        when they are one row a stream, in order; an expand of a single
        stream, which copies nothing; else an index (made once per rows)."""
        if self.per == 1 and list(rows) == list(range(per_stream.shape[0])):
            return per_stream
        if per_stream.shape[0] == 1:
            return per_stream.expand(len(rows), *per_stream.shape[1:])
        return per_stream.index_select(0, self._stream_index(rows))

    def camera(self, rows, t):
        """[len(rows), 25] the cameras of `rows` at step t."""
        return self.per_row(self.inputs["cameras"][:, t % self.inputs["cycle"]], rows)

    # the configuration's module fills these in
    def avatar(self, rows):
        raise NotImplementedError

    def drive(self, t: int):
        raise NotImplementedError

    def frame(self, avatar, rows, t: int, drive):
        raise NotImplementedError

    def spans(self):
        return []
