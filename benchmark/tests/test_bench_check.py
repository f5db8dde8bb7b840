"""The check fails where it must, on the CPU at tiny sizes, under the
cells' own limits: the control (the reference one precision step down in
the program's place), and the program broken underneath in each way a
cell can fail: a frame that returns an earlier step's frame unchanged,
half of the batch left out with the mean of the rest in its place, an
answer altered where it is produced, and the super-resolution's last block
left out of the image. (Every cell runs on one card: no exchange between
cards exists to leave out.)"""

import pytest
import torch

from benchmark.tests.tiny import run_tiny


@pytest.mark.parametrize("cell", ["ani3dgan512-grid10", "next3d-live1", "ani3dgan512-live4"])
def test_control_fails(cell):
    r = run_tiny(cell, control="tf32")
    assert not r["correct"] and r["failed"] > 0


def _stale(build):
    frame, first = build.frame, []

    def stale(avatar, rows, t, drive):
        if not first:
            first.append(frame(avatar, rows, t, drive))
        return first[0]

    build.frame = stale


def _half_batch(build):
    frame = build.frame

    def half(avatar, rows, t, drive):
        n = len(rows) // 2
        part = frame(_rows(avatar, n), rows[:n], t, drive)
        return {k: v[:n].mean(0, keepdim=True).expand(len(rows), *v.shape[1:]).clone()
                .index_copy_(0, torch.arange(n), v[:n]) for k, v in part.items()}

    build.frame = half


def _rows(avatar, n):
    """The first n rows of an avatar (a tensor, or the tuple of the
    ani3dgan512 avatar: ws, feature lists, raster cache, texture cache)."""
    if hasattr(avatar, "shape"):
        return avatar[:n]
    ws, tex, static, cache, tex_cat = avatar
    return (ws[:n], [x[:n] for x in tex], [x[:n] for x in static], [x[:n] for x in cache],
            {k: v[:n] for k, v in tex_cat.items()})


def _altered(build):
    frame = build.frame

    def altered(avatar, rows, t, drive):
        out = frame(avatar, rows, t, drive)
        img = out["image"].clone()
        img[-1] += 0.05 * img[-1].std()
        return dict(out, image=img)

    build.frame = altered


def _sr_skipped(build):
    """The super-resolution's last block adds nothing to the image: its
    ToRGB layer gives zeros, so the image is block 0's, upsampled."""
    torgb = build.G.superresolution.block1.torgb
    torgb.forward = lambda x, w: torch.zeros_like(x[:, :3])


@pytest.mark.parametrize("cell,fault", [
    ("ani3dgan512-grid10", _stale), ("ani3dgan512-grid10", _half_batch),
    ("ani3dgan512-grid10", _altered), ("next3d-live1", _stale), ("next3d-live1", _altered),
    ("ani3dgan512-live4", _half_batch), ("ani3dgan512-grid10", _sr_skipped),
    ("next3d-live1", _sr_skipped), ("ani3dgan512-live4", _sr_skipped)])
def test_broken_program_fails(cell, fault):
    r = run_tiny(cell, fault=fault)
    assert not r["correct"] and r["failed"] > 0
